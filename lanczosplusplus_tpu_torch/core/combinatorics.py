"""Binomial tables and vectorized combinadic (un)ranking on the host.

Counterpart of ``lanczosplusplus_tpu/core/combinatorics.py``: bases of
at least ``NATIVE_MIN_DIM`` words enumerate through the native host
runtime (``native.py``) where it builds, as in the JAX package, the rest
and a host without a compiler through the numpy path.  The reference
enumerates each one-spin basis by a next-bit-permutation loop and ranks
states with a combinadic perfect hash
rank(w) = sum over set bits b (1-indexed count c) of C(b, c)
(reference: src/Models/HubbardOneOrbital/BasisOneSpin.h:52-81, 178-191).
Whole index ranges are unranked at once with one searchsorted per
particle count.
"""

from __future__ import annotations

import numpy as np

from lanczosplusplus_tpu_torch import native
from lanczosplusplus_tpu_torch.core.bits import WORD

# bases at least this large enumerate natively (the JAX package's
# threshold)
NATIVE_MIN_DIM = 1 << 16


def binomial_table(nmax: int) -> np.ndarray:
    """comb[n, m] = C(n, m) for 0<=n,m<=nmax, int64 (Pascal)."""
    c = np.zeros((nmax + 1, nmax + 1), dtype=np.int64)
    c[:, 0] = 1
    for n in range(1, nmax + 1):
        c[n, 1:] = c[n - 1, 1:] + c[n - 1, :-1]
    return c


def comb(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return int(binomial_table(max(n, k))[n, k])


def rank_combinations(words: np.ndarray, nsite: int,
                      table: np.ndarray | None = None) -> np.ndarray:
    """Colex rank of each k-combination word: sum_b C(b, c_b) with c_b the
    running count of set bits up to b (vectorized perfectIndex)."""
    if table is None:
        table = binomial_table(nsite + 1)
    words = words.astype(WORD)
    ranks = np.zeros(words.shape, dtype=np.int64)
    counts = np.zeros(words.shape, dtype=np.int64)
    for b in range(nsite):
        bit = ((words >> WORD(b)) & WORD(1)).astype(np.int64)
        counts += bit
        # C(b, counts) only where this bit is set
        ranks += bit * table[b, np.minimum(counts, table.shape[1] - 1)]
    return ranks


def unrank_combinations(ranks: np.ndarray, nsite: int, npart: int,
                        table: np.ndarray | None = None) -> np.ndarray:
    """Inverse of rank_combinations: rank -> uint64 word with npart set
    bits among nsite, colex order."""
    if table is None:
        table = binomial_table(nsite + 1)
    r = np.asarray(ranks, dtype=np.int64).copy()
    words = np.zeros(r.shape, dtype=WORD)
    for c in range(npart, 0, -1):
        col = table[:nsite + 1, c]  # strictly increasing for n >= c
        b = np.searchsorted(col, r, side="right") - 1
        words |= WORD(1) << b.astype(WORD)
        r -= col[b]
    return words


def enumerate_combinations(nsite: int, npart: int) -> np.ndarray:
    """All C(nsite, npart) words in colex order (matches the reference's
    next-permutation enumeration order, BasisOneSpin.h:52-62).  Large
    bases route through the native C++ enumerator when it builds."""
    table = binomial_table(nsite + 1)
    dim = int(table[nsite, npart])
    if npart == 0:
        return np.zeros(1, dtype=WORD)
    if dim >= NATIVE_MIN_DIM:
        out = native.enumerate_combinations(nsite, npart)
        if out is not None:
            return out
    return unrank_combinations(np.arange(dim), nsite, npart, table)
