"""The sliced ELL form that ``ell_spmv``'s kernel reads, on the CPU.

``ell_spmv_sliced_ref(diag, slice_ell(cols, vals), x)`` against the JAX
package's ``ell_spmv_or_fallback`` on the same numpy-seeded inputs, to
1e-13 of max |y| in float64 (the two sums differ only in their order), on
the port's own ELLs (a 12-site Heisenberg ring, an 8-site t-J ring, a
small complex Rashba ring, a momentum and a parity block, a flattened
Hamiltonian whose padding sits between its parts, the SuperHubbardExtended
J-ELL's rows with no entries) and on random ones (dim not a multiple of
32, K = 1), for one vector and a batch of 3; then the layout's own
invariants: each row's entries in k order, the row permutation a
permutation sorted within its windows, the padding and the slice offsets
where they belong, and the padded matrix's nonzeros given back by
unslicing."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lanczosplusplus_tpu.ops import pallas_kernels as pk
from lanczosplusplus_tpu_torch import symmetry
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.ops import kernels
from test_torch_inputs import heisenberg_text, tj_text

torch.set_num_threads(2)

C = kernels.SLICE_ROWS


def _model_ham(text, dtype=torch.float64):
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    return model, basis, model.hamiltonian(basis, dtype=dtype, device="cpu")


def _block(text, kind, complex_block):
    """The largest block of the wanted type of one symmetry of a chain."""
    model, basis, _ = _model_ham(text)
    cls = (symmetry.TranslationSymmetry if kind == "translation"
           else symmetry.ReflectionSymmetry)
    sym = cls(basis, model.geometry, model, model.is_fermionic)
    blocks = [sym.block_hamiltonian(s) for s in range(sym.sectors())]
    return max((b for b in blocks if b is not None
                and b.dtype.is_complex == complex_block),
               key=lambda b: b.dim)


def _random(dim, k, seed):
    """A random ELL, half its entries padding and every fifth row with no
    entries, as host arrays."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, dim, size=(dim, k)).astype(np.int32)
    vals = rng.standard_normal((dim, k))
    pad = rng.random((dim, k)) < 0.5
    pad[::5] = True
    cols[pad] = np.broadcast_to(np.arange(dim, dtype=np.int32)[:, None],
                                (dim, k))[pad]
    vals[pad] = 0.0
    return rng.standard_normal(dim), cols, vals


def _case(name):
    """(diag, cols, vals) host arrays of one case."""
    if name.startswith("random"):
        dim, k = {"random_dim_1001_k7": (1001, 7),
                  "random_k1": (333, 1)}[name]
        return _random(dim, k, dim + k)
    if name == "heisenberg12":
        ham = _model_ham(heisenberg_text(12, 1, 6))[2]
    elif name == "tj8":
        ham = _model_ham(tj_text(8, 3, 3, periodic=1))[2]
    elif name == "rashba6_complex":
        ham = _model_ham(chip_smoke.rashba_ring_text(6, 6),
                         torch.complex128)[2]
    elif name == "she8_jell":
        ham = _model_ham(chip_smoke.super_hubbard_text(8))[2]
    elif name == "momentum_block":
        ham = _block(chip_smoke.hubbard_chain_text(8, 4, 2, 2),
                     "translation", True)
    elif name == "parity_block":
        ham = _block(chip_smoke.hubbard_chain_text(8, 4, 2, 2, periodic=0),
                     "reflection", False)
    else:   # a flattened Hamiltonian: the dn part's entries after the up
        #     part's padding
        ham = _model_ham(chip_smoke.hubbard_chain_text(8, 4, 3, 3))[2]
        ham = ham.flatten_to_ell()
    return tuple(t.numpy() for t in (ham.diag, ham.ell.cols, ham.ell.vals))


CASES = ["heisenberg12", "tj8", "rashba6_complex", "she8_jell",
         "momentum_block", "parity_block", "flattened", "random_dim_1001_k7",
         "random_k1"]


@pytest.fixture(scope="module")
def arrays():
    return {}


def _arrays(cache, name):
    if name not in cache:
        cache[name] = _case(name)
    return cache[name]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("name", CASES)
def test_sliced_plain_version_matches_jax(arrays, name, rows):
    diag, cols, vals = _arrays(arrays, name)
    dim = cols.shape[0]
    rng = np.random.default_rng(rows + dim)
    x = rng.standard_normal((rows, dim))
    if np.iscomplexobj(vals):
        x = x + 1j * rng.standard_normal((rows, dim))
    sliced = kernels.slice_ell(torch.from_numpy(cols), torch.from_numpy(vals))
    xt = torch.from_numpy(x if rows > 1 else x[0])
    got = kernels.ell_spmv_sliced_ref(torch.from_numpy(diag).to(xt.dtype),
                                      sliced, xt).numpy().reshape(rows, dim)
    for b in range(rows):
        want = np.asarray(pk.ell_spmv_or_fallback(
            jnp.asarray(diag), jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(x[b])))
        assert np.abs(got[b] - want).max() <= 1e-13 * np.abs(want).max()


def _unslice(sliced, dim):
    """The padded (dim, width) form of a sliced ELL, rows in their own
    order, and each row's count of slots up to its last nonzero."""
    perm = sliced.perm.long()
    width = max(sliced.width, 1)
    cols = np.tile(np.arange(dim)[:, None], (1, width))
    vals = np.zeros((dim, width), dtype=sliced.vals.numpy().dtype)
    offsets = sliced.offsets.numpy()
    for s, w in enumerate(sliced.widths.tolist()):
        for i in range(C):
            p = s * C + i
            if p >= dim:
                continue
            slots = offsets[s] + C * np.arange(w) + i
            cols[perm[p], :w] = sliced.cols.numpy()[slots]
            vals[perm[p], :w] = sliced.vals.numpy()[slots]
    return cols, vals


@pytest.mark.parametrize("name", CASES)
def test_slice_layout_invariants(arrays, name):
    _, cols, vals = _arrays(arrays, name)
    dim, k = cols.shape
    sliced = kernels.slice_ell(torch.from_numpy(cols), torch.from_numpy(vals))
    slices = -(-dim // C)
    perm = sliced.perm.numpy()
    assert sliced.perm.dtype == torch.int32 == sliced.cols.dtype
    assert sliced.offsets.dtype == torch.int64
    assert sliced.vals.dtype == torch.from_numpy(vals).dtype
    # the permutation is a permutation, sorted by count (the longest rows
    # first, ties in row order) within each window of rows
    assert np.array_equal(np.sort(perm), np.arange(dim))
    counts = (vals != 0).sum(1)
    window = np.arange(dim) // kernels.SLICE_WINDOW
    assert np.array_equal(window[perm], window)
    key = window * (k + 1) + (k - counts)
    assert np.array_equal(perm, np.argsort(key, kind="stable"))
    # slices: as wide as their longest row, stored one after another
    widths = sliced.widths.numpy()
    lane_counts = np.zeros(slices * C, dtype=np.int64)
    lane_counts[:dim] = counts[perm]
    assert np.array_equal(widths, lane_counts.reshape(slices, C).max(1))
    assert np.array_equal(sliced.offsets.numpy(),
                          np.concatenate([[0], np.cumsum(C * widths)[:-1]]))
    assert sliced.cols.numel() == C * widths.sum()
    assert sliced.width == widths.max() and sliced.nnz == counts.sum()
    # the typical width: the narrowest whose slices hold 9 in 10 slots
    held = [(C * widths[widths <= w]).sum() for w in range(sliced.width + 1)]
    typical = next((w for w, n in enumerate(held)
                    if n >= 0.9 * C * widths.sum()), 0)
    assert sliced.typical_width == typical
    # each row's entries in k order, then its padding: its own row, 0
    ucols, uvals = _unslice(sliced, dim)
    for r in range(dim):
        keep = vals[r] != 0
        n = int(keep.sum())
        assert np.array_equal(ucols[r, :n], cols[r, keep]), r
        assert np.array_equal(uvals[r, :n], vals[r, keep]), r
        assert (ucols[r, n:] == r).all() and (uvals[r, n:] == 0).all(), r
    # unslicing gives back the padded matrix's nonzeros
    dense = np.zeros((dim, dim), dtype=vals.dtype)
    np.add.at(dense, (np.repeat(np.arange(dim), k), cols.reshape(-1)),
              vals.reshape(-1))
    back = np.zeros_like(dense)
    np.add.at(back, (np.repeat(np.arange(dim), ucols.shape[1]),
                     ucols.reshape(-1)), uvals.reshape(-1))
    assert np.array_equal(back, dense)
    assert sliced.nbytes == sum(t.numel() * t.element_size() for t in (
        sliced.cols, sliced.vals, sliced.offsets, sliced.widths, sliced.perm))


def test_sliced_form_drops_the_padding():
    """Three quarters of a Heisenberg ring's padded ELL is padding; the
    sliced form keeps its nonzeros and at most a fifth more slots."""
    _, cols, vals = _case("heisenberg12")
    sliced = kernels.slice_ell(torch.from_numpy(cols), torch.from_numpy(vals))
    nnz = int((vals != 0).sum())
    assert nnz < 0.3 * vals.size
    assert sliced.nnz == nnz <= sliced.cols.numel() <= 1.2 * nnz


def test_empty_matrix():
    sliced = kernels.slice_ell(torch.zeros(0, 3, dtype=torch.int32),
                               torch.zeros(0, 3, dtype=torch.float64))
    assert sliced.width == sliced.nnz == sliced.cols.numel() == 0
    y = kernels.ell_spmv_sliced_ref(torch.zeros(0, dtype=torch.float64),
                                    sliced,
                                    torch.zeros(2, 0, dtype=torch.float64))
    assert y.shape == (2, 0)


def test_cpu_apply_makes_no_sliced_form_and_the_part_keeps_one():
    """On the CPU the Hamiltonian applies its padded arrays through the
    plain version and makes no sliced form; asked for one, the ELL part
    makes it once and keeps it."""
    _, _, ham = _model_ham(chip_smoke.super_hubbard_text(6))
    kernels.reset_launches()
    x = torch.randn(3, ham.dim, dtype=torch.float64)
    ham.matmat_t(x)
    assert kernels.SLICINGS == {} and ham.ell._sliced is None
    sliced = ham.ell.sliced()
    assert ham.ell.sliced() is sliced and kernels.SLICINGS == {"ell_spmv": 1}
    y = kernels.ell_spmv_ref(ham.diag, ham.ell.cols, ham.ell.vals, x)
    np.testing.assert_allclose(
        kernels.ell_spmv_sliced_ref(ham.diag, sliced, x).numpy(), y.numpy(),
        rtol=0, atol=1e-13 * y.abs().max().item())
    kernels.reset_launches()
    assert kernels.SLICINGS == {}


@pytest.mark.parametrize("raises", [False, True], ids=["ends", "raises"])
def test_uncounted_leaves_the_counts_as_they_were(raises):
    """Launches, repacks and slicings counted inside ``uncounted()`` are
    gone when it ends, whether it ends or raises; those before it stay."""
    kernels.reset_launches()
    kernels._launched("ell_spmv", "f64")
    kernels.SLICINGS["ell_spmv"] = 1
    with pytest.raises(ValueError) if raises else contextlib.nullcontext():
        with kernels.uncounted():
            kernels._launched("ell_spmv", "f64")
            kernels._launched("perm_gather", "c128")
            kernels.REPACKS["factor_matmul bf16"] = 2
            kernels.SLICINGS["ell_spmv"] = 2
            if raises:
                raise ValueError
    assert kernels.FORM_LAUNCHES == {"ell_spmv f64": 1}
    assert kernels.LAUNCHES["perm_gather"] == 0
    assert (kernels.REPACKS, kernels.SLICINGS) == ({}, {"ell_spmv": 1})
    kernels.reset_launches()


def test_plain_kernels_take_a_sliced_form():
    """chip_smoke's plain-kernel swap takes the sliced form the card path
    passes and computes the plain version from the padded arrays."""
    diag, cols, vals = map(torch.from_numpy, _random(200, 5, 1))
    sliced = kernels.slice_ell(cols, vals)
    x = torch.randn(200, dtype=torch.float64)
    with chip_smoke.plain_kernels():
        got = kernels.ell_spmv(diag, cols, vals, x, sliced=sliced)
    assert torch.equal(got, kernels.ell_spmv_ref(diag, cols, vals, x))


def _shard(dim, k, extra, seed, dtype):
    """A row shard's ELL: rows `dim`, columns into a source of dim + extra
    entries (an all-gathered state, or the shard's rows and its halo),
    half its entries padding (own row, value 0)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, dim + extra, size=(dim, k)).astype(np.int32)
    vals = rng.standard_normal((dim, k))
    diag = rng.standard_normal(dim)
    if np.dtype(dtype).kind == "c":
        vals = vals + 1j * rng.standard_normal((dim, k))
        diag = diag + 1j * rng.standard_normal(dim)
    pad = rng.random((dim, k)) < 0.5
    cols[pad] = np.broadcast_to(np.arange(dim, dtype=np.int32)[:, None],
                                (dim, k))[pad]
    vals[pad] = 0
    return (torch.from_numpy(diag.astype(dtype)),
            torch.from_numpy(cols), torch.from_numpy(vals.astype(dtype)))


SRC_DTYPES = [(np.float64, 1e-13), (np.float32, 1e-5),
              (np.complex128, 1e-13), (np.complex64, 1e-5)]


@pytest.mark.parametrize("dtype,tol", SRC_DTYPES)
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dim,k,extra", [(257, 7, 3 * 257), (100, 1, 5)])
def test_longer_source_against_dense(dtype, tol, batch, dim, k, extra):
    """y = diag x + A src with A the shard's (rows, len(src)) matrix: both
    plain versions, from the padded arrays and from the sliced form,
    against the dense product in float64 or complex128, for one vector
    and a batch whose source rows sit at a pitch longer than a row."""
    diag, cols, vals = _shard(dim, k, extra, dim + k, dtype)
    rng = np.random.default_rng(7)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal((*lead, dim))
    wide = rng.standard_normal((*lead, dim + extra + 4))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(x.shape)
        wide = wide + 1j * rng.standard_normal(wide.shape)
    xt = torch.from_numpy(x.astype(dtype))
    src = torch.from_numpy(wide.astype(dtype))[..., :dim + extra]
    dense = np.zeros((dim, dim + extra), dtype=np.complex128)
    np.add.at(dense, (np.repeat(np.arange(dim), k), cols.numpy().ravel()),
              vals.numpy().astype(np.complex128).ravel())
    want = diag.numpy().astype(np.complex128) * xt.numpy() + \
        src.numpy().astype(np.complex128) @ dense.T
    if np.dtype(dtype).kind != "c":
        want = want.real
    sliced = kernels.slice_ell(cols, vals)
    for got in (kernels.ell_spmv(diag, cols, vals, xt, src=src),
                kernels.ell_spmv_ref(diag, cols, vals, xt, src),
                kernels.ell_spmv_sliced_ref(diag, sliced, xt, src)):
        assert got.shape == xt.shape and got.dtype == xt.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_sliced_form_of_columns_beyond_its_rows():
    """A shard's columns run past its rows: the sliced form keeps them,
    each row's nonzeros in k order, and its padding points at its own
    rows; unsliced it gives back the padded matrix's nonzeros."""
    diag, cols, vals = _shard(300, 9, 900, 3, np.float64)
    sliced = kernels.slice_ell(cols, vals)
    nz = vals != 0
    assert sliced.nnz == int(nz.sum())
    assert int(sliced.cols.max()) >= 300
    assert bool((sliced.cols[sliced.vals == 0] < 300).all())
    got = {}
    lane = torch.arange(sliced.widths.numel() * C).view(-1, C)
    lane = lane.repeat_interleave(sliced.widths.long(), 0).view(-1)
    rows = sliced.perm.long()[lane[sliced.vals != 0]]
    for r, c, v in zip(rows.tolist(), sliced.cols[sliced.vals != 0].tolist(),
                       sliced.vals[sliced.vals != 0].tolist()):
        got.setdefault(r, []).append((c, v))
    for r in range(300):
        assert got.get(r, []) == list(zip(cols[r][nz[r]].tolist(),
                                          vals[r][nz[r]].tolist()))


def test_source_of_the_wrong_shape_raises():
    diag, cols, vals = _shard(50, 3, 20, 1, np.float64)
    x = torch.zeros(2, 50, dtype=torch.float64)
    for bad in (torch.zeros(2, 49, dtype=torch.float64),
                torch.zeros(3, 70, dtype=torch.float64),
                torch.zeros(70, dtype=torch.float64),
                torch.zeros(70, 2, dtype=torch.float64).T):
        with pytest.raises(ValueError, match="src"):
            kernels.ell_spmv(diag, cols, vals, x, src=bad)
