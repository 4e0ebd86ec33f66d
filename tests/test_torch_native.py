"""The port's binding of the native host runtime (native.py) held against
the JAX package's binding of the same source and against the numpy paths
(tests/test_native.py is the reference test): equal words, ranks, one-spin
hop ELL arrays and scatter-plan tables, bit for bit.  The library builds
here with g++ into the port's _build/ directory.  The port's
``core/combinatorics.enumerate_combinations`` and ``core/sparse.one_spin_ell``
take the binding at the JAX package's thresholds (2^16 words), real bonds
over a ``OneSpinBasis`` only, and keep their numpy paths for a host
without a compiler."""

import numpy as np
import pytest

from lanczosplusplus_tpu import native as jax_native
from lanczosplusplus_tpu.core.basis import OneSpinBasis as JaxOneSpinBasis
from lanczosplusplus_tpu.core.sparse import one_spin_ell as jax_one_spin_ell
from lanczosplusplus_tpu_torch import native
from lanczosplusplus_tpu_torch.core import combinatorics as comb
from lanczosplusplus_tpu_torch.core import sparse
from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis

TABLE = comb.binomial_table(64 + 1)


def ring_bonds(nsite, t=-1.0):
    bonds = []
    for i in range(nsite):
        j = (i + 1) % nsite
        bonds += [(i, j, t), (j, i, t)]
    return bonds


@pytest.fixture
def numpy_only(monkeypatch):
    """The numpy paths: the binding finds no library."""
    monkeypatch.setattr(native, "load", lambda: None)


def test_library_builds_into_the_package_build_dir():
    assert native.available()
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("liblanczos_native_")
    assert path == native.library_path(native.compiler())
    assert native.load() is native.load()


def test_no_compiler_means_numpy_paths(monkeypatch):
    """Without g++ nothing builds and every entry point returns None, so
    the callers take their numpy paths with the same results."""
    want = comb.enumerate_combinations(17, 8)
    monkeypatch.setattr(native, "compiler", lambda: None)
    native.load.cache_clear()
    try:
        assert not native.available()
        assert native.enumerate_combinations(17, 8) is None
        assert native.rank_combinations(want, TABLE) is None
        assert native.one_spin_hop_ell(want, ring_bonds(17), TABLE) is None
        assert native.scatter_plan_tables(np.arange(4), np.ones(4), 2, 2,
                                          2) is None
        np.testing.assert_array_equal(comb.enumerate_combinations(17, 8),
                                      want)
    finally:
        native.load.cache_clear()


@pytest.mark.parametrize("nsite,npart", [(18, 9), (20, 6), (24, 12)])
def test_enumeration_matches_jax_and_numpy(nsite, npart):
    got = native.enumerate_combinations(nsite, npart)
    table = comb.binomial_table(nsite + 1)
    dim = int(table[nsite, npart])
    want = comb.unrank_combinations(np.arange(dim), nsite, npart, table)
    assert got.dtype == np.uint64 and got.shape == (dim,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_native.enumerate_combinations(nsite, npart))


def test_enumerate_combinations_routes_at_the_threshold(monkeypatch):
    calls = []
    binding = native.enumerate_combinations

    def counted(nsite, npart):
        calls.append((nsite, npart))
        return binding(nsite, npart)
    monkeypatch.setattr(native, "enumerate_combinations", counted)
    small = comb.enumerate_combinations(18, 9)        # 48 620 words
    large = comb.enumerate_combinations(19, 9)        # 92 378 words
    assert calls == [(19, 9)]
    assert comb.NATIVE_MIN_DIM == 1 << 16
    monkeypatch.setattr(native, "load", lambda: None)
    np.testing.assert_array_equal(comb.enumerate_combinations(19, 9), large)
    np.testing.assert_array_equal(
        small, comb.unrank_combinations(np.arange(48620), 18, 9))


def test_rank_matches_jax_and_numpy():
    nsite = 20
    words = native.enumerate_combinations(nsite, 10)
    shuffled = words[np.random.default_rng(5).permutation(words.shape[0])]
    got = native.rank_combinations(shuffled, TABLE)
    np.testing.assert_array_equal(got,
                                  comb.rank_combinations(shuffled, nsite))
    np.testing.assert_array_equal(
        got, jax_native.rank_combinations(shuffled, TABLE))
    np.testing.assert_array_equal(np.sort(got), np.arange(words.shape[0]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hop_ell_matches_jax_and_numpy(monkeypatch, dtype):
    """19 sites with 9 up (92 378 words, past the threshold) on a ring
    with uneven hoppings: the port's one_spin_ell through the binding,
    through its numpy path and the JAX package's through its binding,
    bit for bit."""
    nsite = 19
    basis = OneSpinBasis(nsite, 9)
    bonds = [(i, j, t * (1.0 + 0.1 * i)) for i, j, t in ring_bonds(nsite)]
    cols, vals = sparse.one_spin_ell(basis.words, basis.rank, bonds, dtype)
    jbasis = JaxOneSpinBasis(nsite, 9)
    jcols, jvals = jax_one_spin_ell(jbasis.words, jbasis.rank, bonds, dtype)
    n_cols, n_vals = native.one_spin_hop_ell(basis.words, bonds, TABLE)
    monkeypatch.setattr(native, "load", lambda: None)
    p_cols, p_vals = sparse.one_spin_ell(basis.words, basis.rank, bonds,
                                         dtype)
    for c, v in ((jcols, jvals), (p_cols, p_vals), (n_cols, n_vals)):
        np.testing.assert_array_equal(cols, c)
        np.testing.assert_array_equal(vals, np.asarray(v).astype(dtype))
    assert cols.dtype == np.int32 and vals.dtype == dtype
    assert cols.shape == (basis.size, len(bonds))


def test_hop_ell_routes_only_real_bonds_over_a_combination_basis(
        monkeypatch):
    """Below the threshold, for a complex dtype, or for a rank function
    that is not a OneSpinBasis's, one_spin_ell takes the numpy path."""
    calls = []
    binding = native.one_spin_hop_ell

    def counted(*args):
        calls.append(args[0].shape[0])
        return binding(*args)
    monkeypatch.setattr(native, "one_spin_hop_ell", counted)
    big = OneSpinBasis(19, 9)
    bonds = ring_bonds(19)
    sparse.one_spin_ell(OneSpinBasis(18, 9).words,
                        OneSpinBasis(18, 9).rank, bonds, np.float64)
    sparse.one_spin_ell(big.words, big.rank, bonds, np.complex128)
    sparse.one_spin_ell(big.words, lambda w: big.rank(w), bonds, np.float64)
    assert calls == []
    sparse.one_spin_ell(big.words, big.rank, bonds, np.float64)
    assert calls == [big.size]


def numpy_scatter_tables(tgt, amp, s_src, s_dst, ndev):
    """The JAX package's numpy bucketing (parallel/scatter_plan.py)."""
    valid = np.nonzero(tgt >= 0)[0]
    t_v = tgt[valid].astype(np.int64)
    key = (valid // s_src).astype(np.int64) * ndev + t_v // s_dst
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    counts = np.bincount(key_s, minlength=ndev * ndev)
    maxcount = max(int(counts.max(initial=0)), 1)
    offsets = np.zeros(ndev * ndev + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(key_s.shape[0], dtype=np.int64) - offsets[key_s]
    d_s, o_s = key_s // ndev, key_s % ndev
    send_src = np.zeros((ndev, ndev, maxcount), np.int32)
    send_amp = np.zeros((ndev, ndev, maxcount), amp.dtype)
    dst_idx = np.zeros((ndev, ndev, maxcount), np.int32)
    send_src[d_s, o_s, pos] = valid[order] - d_s * s_src
    send_amp[d_s, o_s, pos] = amp[valid][order]
    dst_idx[o_s, d_s, pos] = t_v[order] - o_s * s_dst
    return send_src, send_amp, dst_idx, maxcount


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_scatter_plan_tables_match_jax_and_numpy(dtype):
    rng = np.random.default_rng(11)
    ndev, s_src, s_dst = 4, 2500, 2300
    tgt = rng.integers(-1, ndev * s_dst, size=ndev * s_src)
    amp = rng.standard_normal(tgt.shape[0]).astype(dtype)
    if dtype == np.complex128:
        amp = amp + 1j * rng.standard_normal(tgt.shape[0])
    got = native.scatter_plan_tables(tgt, amp, s_src, s_dst, ndev)
    for want in (jax_native.scatter_plan_tables(tgt, amp, s_src, s_dst,
                                                ndev),
                 numpy_scatter_tables(tgt, amp, s_src, s_dst, ndev)):
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
