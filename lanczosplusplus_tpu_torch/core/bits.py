"""Vectorized uint64 bit-string utilities on the host (numpy).

Counterpart of ``lanczosplusplus_tpu/core/bits.py``, numpy half only.
The reference encodes one Slater determinant per spin species as a
machine word and derives fermion signs from popcounts of masked words
(reference: src/Engine/ProgramGlobals.h:102, 109-114).  Every operation
is vectorized over whole basis arrays instead of per-state loops.
"""

from __future__ import annotations

import numpy as np

WORD = np.uint64

_M1 = WORD(0x5555555555555555)
_M2 = WORD(0x3333333333333333)
_M4 = WORD(0x0F0F0F0F0F0F0F0F)
_H01 = WORD(0x0101010101010101)


def popcount(words: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint64 array (SWAR)."""
    x = words.astype(WORD, copy=True)
    x = x - ((x >> WORD(1)) & _M1)
    x = (x & _M2) + ((x >> WORD(2)) & _M2)
    x = (x + (x >> WORD(4))) & _M4
    return ((x * _H01) >> WORD(56)).astype(np.int64)


def mask_below(i) -> np.ndarray:
    """(1 << i) - 1 as uint64, vectorized over i."""
    i = np.asarray(i, dtype=WORD)
    return (WORD(1) << i) - WORD(1)


def parity_sign_below(words: np.ndarray, site) -> np.ndarray:
    """(-1)^{#occupied strictly below `site`}: the elementary fermion
    sign (reference: src/Engine/ProgramGlobals.h:109-114 doSign)."""
    cnt = popcount(words.astype(WORD) & mask_below(site))
    return np.where(cnt & 1, -1, 1).astype(np.int64)


def count_range(words: np.ndarray, lo, hi) -> np.ndarray:
    """#occupied sites in [lo, hi) per word (vectorized over words and
    over lo/hi)."""
    lo = np.asarray(lo, dtype=WORD)
    hi = np.asarray(hi, dtype=WORD)
    m = mask_below(hi) & ~mask_below(lo)
    return popcount(words.astype(WORD) & m)


def pair_hop_sign(words: np.ndarray, i, j) -> np.ndarray:
    """Sign for moving a fermion between sites i<j within one word:
    (-1)^{n(i, j) exclusive + n_i} with the reference's boundary
    convention (reference: src/Models/HubbardOneOrbital/BasisOneSpin.h:104-121
    doSign(ket,i,j): counts (i,j) open interval plus occupation at i)."""
    i = np.asarray(i)
    j = np.asarray(j)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    cnt = count_range(words, lo + 1, hi) + count_range(words, lo, lo + 1)
    return np.where(cnt & 1, -1, 1).astype(np.int64)


def get_bit(words: np.ndarray, site) -> np.ndarray:
    """Occupation (0/1) of `site` per word."""
    site = np.asarray(site, dtype=WORD)
    return ((words.astype(WORD) >> site) & WORD(1)).astype(np.int64)


def flip_bit(words: np.ndarray, site) -> np.ndarray:
    site = np.asarray(site, dtype=WORD)
    return words.astype(WORD) ^ (WORD(1) << site)


def bits_to_table(words: np.ndarray, nsite: int) -> np.ndarray:
    """(len(words), nsite) int8 occupation table."""
    w = words.astype(WORD)[:, None]
    shifts = np.arange(nsite, dtype=WORD)[None, :]
    return ((w >> shifts) & WORD(1)).astype(np.int8)
