"""The port's kernel wrappers on the CPU: their plain versions held against
the JAX package's Pallas kernels (run as tests/test_pallas.py runs them),
dispatch by device, and the checks the wrappers make before a launch.
The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.ops import pallas_kernels as pk
from lanczosplusplus_tpu_torch.ops import build, kernels

torch.set_num_threads(2)


def test_factor_matmul_ref_matches_pallas():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 257)).astype(np.float32)
    a = rng.standard_normal((123, 257)).astype(np.float32)
    expect = pk.factor_matmul(jnp.asarray(x), jnp.asarray(a),
                              tile_m=128, tile_n=128, tile_k=128)
    got = kernels.factor_matmul_ref(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-4)


def test_ell_spmv_ref_matches_pallas_fallback():
    rng = np.random.default_rng(1)
    dim, k = 500, 7
    diag = rng.standard_normal(dim)
    cols = rng.integers(0, dim, size=(dim, k)).astype(np.int32)
    vals = rng.standard_normal((dim, k))
    x = rng.standard_normal(dim)
    expect = pk.ell_spmv_or_fallback(jnp.asarray(diag), jnp.asarray(cols),
                                     jnp.asarray(vals), jnp.asarray(x))
    got = kernels.ell_spmv_ref(*map(torch.from_numpy, (diag, cols, vals, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-13)


@pytest.mark.parametrize("dim,k", [(500, 7), (64, 1), (33, 12)])
def test_ell_spmv_k_major_matches_jax_and_contiguous(dim, k):
    """The K-major view (strides (1, dim)) that the port stores gives the
    JAX package's result and the contiguous form's, to 1e-13 relative in
    float64 (the sums differ at most in their order)."""
    rng = np.random.default_rng(dim + k)
    diag = rng.standard_normal(dim)
    cols = rng.integers(0, dim, size=(dim, k)).astype(np.int32)
    vals = rng.standard_normal((dim, k))
    x = rng.standard_normal(dim)
    expect = np.asarray(pk.ell_spmv_or_fallback(
        jnp.asarray(diag), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(x)))
    tc = torch.from_numpy(np.ascontiguousarray(cols.T)).T
    tv = torch.from_numpy(np.ascontiguousarray(vals.T)).T
    assert tc.shape == (dim, k) and tc.T.is_contiguous()
    got = kernels.ell_spmv(torch.from_numpy(diag), tc, tv,
                           torch.from_numpy(x)).numpy()
    flat = kernels.ell_spmv(*map(torch.from_numpy, (diag, cols, vals, x)))
    scale = np.abs(expect).max()
    assert np.abs(got - expect).max() <= 1e-13 * scale
    assert np.abs(got - flat.numpy()).max() <= 1e-13 * scale


@pytest.mark.parametrize("case,expect", [
    # the 14-site up apply: every operand k- or n-contiguous, even pitch
    ("up3432", (True, True, True, True, True, 128)),
    # the 14-site dn apply: X and Y transposed views, m-contiguous
    ("dn3432", (False, True, True, True, False, 128)),
    # 12 sites: 64 large tiles would leave half the card idle
    ("up924", (True, True, True, True, True, 64)),
    ("dn924", (False, True, True, True, False, 64)),
    # an odd pitch cannot take 16-byte copies or stores
    ("wide257", (True, False, True, False, False, 64)),
    # the same even-pitched operands one element into their storage
    ("offset1", (True, False, True, False, False, 128)),
    # no contiguous axis: the nearer one is walked, 8 bytes at a time
    ("strided", (True, False, False, False, False, 64)),
])
def test_factor_matmul_plan(case, expect):
    """The float64 kernel's path is a pure function of pointers, strides
    and shape."""
    base = 1 << 20
    if case.startswith(("up", "dn")):
        size = int(case[2:])
        row, col = (size, 1), (1, size)
        xs = ys = row if case.startswith("up") else col
        args = (base, xs, base, row, base, ys, size, size)
    elif case == "wide257":
        args = (base, (257, 1), base, (257, 1), base, (123, 1), 300, 123)
    elif case == "offset1":
        args = (base + 8, (3432, 1), base + 8, (3432, 1), base + 8,
                (3432, 1), 3432, 3432)
    else:
        args = (base, (700, 2), base, (3, 900), base, (1400, 2), 300, 300)
    plan = kernels.factor_matmul_plan(*args)
    assert tuple(plan) == expect
    assert kernels.factor_matmul_plan(*args, sm_count=1).tile == 128
    assert plan.bits == sum(bit << i for i, bit in enumerate(
        (*expect[:5], expect[5] == 128)))


def test_factor_matmul_plan_of_real_tensors():
    """Strides and pointers as the main path hands them over."""
    x = torch.zeros(6, 8, dtype=torch.float64)
    a = torch.zeros(6, 6, dtype=torch.float64)
    y = torch.zeros(6, 8, dtype=torch.float64)
    plan = kernels.factor_matmul_plan(
        x.T.data_ptr(), x.T.stride(), a.data_ptr(), a.stride(),
        y.T.data_ptr(), y.T.stride(), 8, 6)
    assert (plan.x_kmajor, plan.a_kmajor, plan.y_vec16) == (False, True,
                                                            False)
    flat = torch.zeros(49, dtype=torch.float64)[1:].view(6, 8)
    assert flat.data_ptr() % 16 == 8
    assert not kernels.factor_matmul_plan(
        flat.data_ptr(), flat.stride(), a.data_ptr(), a.stride(),
        y.data_ptr(), y.stride(), 6, 6).x_vec16


@pytest.mark.parametrize("operand,rows,cols", [("A", 16, 4), ("B", 4, 8),
                                               ("C", 16, 8)])
def test_dmma_fragment_map_covers_tile(operand, rows, cols):
    """Every element of each operand's tile is held by exactly one
    (lane, register), and every lane holds the same number of registers."""
    frag = kernels.dmma_fragment_map()[operand]
    assert sorted(frag.values()) == [(r, c) for r in range(rows)
                                     for c in range(cols)]
    per_lane = rows * cols // 32
    assert sorted(frag) == [(lane, reg) for lane in range(32)
                            for reg in range(per_lane)]


def test_dmma_fragment_map_multiplies():
    """The kernel's fragment indexing, copied here from
    csrc/factor_matmul.cu, agrees with the table: registers loaded from a
    16-row slab of X and an 8-row slab of A (both indexed (row, k)) as the
    kernel loads them, multiplied as the table says the instruction pairs
    them, and stored as the kernel stores them, give X . A^T."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 4))
    a = rng.standard_normal((8, 4))
    a_reg = np.empty((32, 2))
    b_reg = np.empty((32, 1))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in range(2):
            a_reg[lane, h] = x[g + 8 * h, t]   # af[h] = xs[at(g + 8 h, t)]
        b_reg[lane, 0] = a[g, t]               # bf = as[at(g, t)]
    frag = kernels.dmma_fragment_map()
    a_at = {pos: held for held, pos in frag["A"].items()}
    b_at = {pos: held for held, pos in frag["B"].items()}
    c_reg = np.zeros((32, 4))
    for (lane, reg), (r, col) in frag["C"].items():
        for kk in range(4):
            c_reg[lane, reg] += a_reg[a_at[r, kk]] * b_reg[b_at[kk, col]]
    y = np.empty((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in range(2):
            for e in range(2):                 # Y[g + 8 h][2 t + e]
                y[g + 8 * h, 2 * t + e] = c_reg[lane, 2 * h + e]
    np.testing.assert_allclose(y, x @ a.T, rtol=0, atol=1e-13)


def test_cpu_dispatch_launches_nothing():
    """CPU tensors take the plain versions: results equal them and no
    kernel launch is counted."""
    kernels.reset_launches()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(40, 30, generator=g, dtype=torch.float64)
    a = torch.randn(30, 30, generator=g, dtype=torch.float64)
    y0 = torch.randn(40, 30, generator=g, dtype=torch.float64)
    np.testing.assert_array_equal(kernels.factor_matmul(x, a).numpy(),
                                  kernels.factor_matmul_ref(x, a).numpy())
    # the dn-factor form: Y += A . X^T-view, accumulated through strides
    y = y0.clone()
    xt = torch.randn(30, 40, generator=g, dtype=torch.float64)
    kernels.factor_matmul(xt.T, a, out=y, accumulate=True)
    np.testing.assert_allclose(y.numpy(), (y0 + xt.T @ a.T).numpy(),
                               rtol=1e-14)
    yt = y0.T.clone()
    kernels.factor_matmul(x, a, out=yt.T, accumulate=True)
    np.testing.assert_allclose(yt.T.numpy(), (y0 + x @ a.T).numpy(),
                               rtol=1e-14)
    diag = torch.randn(50, generator=g, dtype=torch.float64)
    cols = torch.randint(0, 50, (50, 3), generator=g, dtype=torch.int32)
    vals = torch.randn(50, 3, generator=g, dtype=torch.float64)
    v = torch.randn(50, generator=g, dtype=torch.float64)
    np.testing.assert_array_equal(
        kernels.ell_spmv(diag, cols, vals, v).numpy(),
        kernels.ell_spmv_ref(diag, cols, vals, v).numpy())
    assert kernels.LAUNCHES == {"factor_matmul": 0, "ell_spmv": 0}


def test_non_cpu_device_without_kernel_raises():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card is refused, not computed with the plain version."""
    x = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.factor_matmul(x, torch.empty(5, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.ell_spmv(torch.empty(4, device="meta"),
                         torch.zeros(4, 2, dtype=torch.int32, device="meta"),
                         torch.empty(4, 2, device="meta"),
                         torch.empty(4, device="meta"))


@pytest.mark.parametrize("case", ["contraction", "out_shape", "accumulate",
                                  "ell_shape", "ell_index_dtype",
                                  "ell_strides", "ell_strides_differ",
                                  "ell_vector_strided"])
def test_wrappers_reject_bad_operands(case):
    x = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        if case == "contraction":
            kernels.factor_matmul(x, torch.zeros(5, 2, dtype=torch.float64))
        elif case == "out_shape":
            kernels.factor_matmul(x, torch.zeros(5, 3, dtype=torch.float64),
                                  out=torch.zeros(4, 4, dtype=torch.float64))
        elif case == "accumulate":
            kernels.factor_matmul(x, torch.zeros(5, 3, dtype=torch.float64),
                                  accumulate=True)
        elif case == "ell_shape":
            kernels.ell_spmv(torch.zeros(4), torch.zeros(4, 2, dtype=torch.int32),
                             torch.zeros(4, 3), torch.zeros(4))
        elif case == "ell_index_dtype":
            kernels.ell_spmv(torch.zeros(4), torch.zeros(4, 2, dtype=torch.int64),
                             torch.zeros(4, 2), torch.zeros(4))
        elif case == "ell_strides":
            # neither K-major nor contiguous: every other column of a
            # wider array, for both tensors alike
            kernels.ell_spmv(torch.zeros(4),
                             torch.zeros(4, 4, dtype=torch.int32)[:, ::2],
                             torch.zeros(4, 4)[:, ::2], torch.zeros(4))
        elif case == "ell_strides_differ":
            kernels.ell_spmv(torch.zeros(4),
                             torch.zeros(2, 4, dtype=torch.int32).T,
                             torch.zeros(4, 2), torch.zeros(4))
        else:
            kernels.ell_spmv(torch.zeros(8)[::2],
                             torch.zeros(4, 2, dtype=torch.int32),
                             torch.zeros(4, 2), torch.zeros(4))


def test_overlap_detection():
    base = torch.zeros(10, 10)
    assert kernels._overlaps(base[:5], base[4:])
    assert not kernels._overlaps(base[:5], base[5:])
    assert kernels._overlaps(base.T, base)


def test_library_name_follows_sources(tmp_path, monkeypatch):
    """The built library is named by the digest of the sources, so an
    edited kernel is rebuilt rather than loaded stale."""
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path()
    assert before.parent == build.BUILD_DIR
    assert {p.name for p in build.sources()} == {"ell_spmv.cu",
                                                 "factor_matmul.cu"}
    (tmp_path / "ell_spmv.cu").write_text("// edited\n")
    assert build.library_path() != before
