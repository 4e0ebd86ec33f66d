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
    """The port keeps one ELL layout, contiguous (dim, K): it gives the JAX
    package's result to 1e-13 relative in float64 (the sums differ at most
    in their order), for one vector and for every row of a batch-major
    block, and a K-major view (strides (1, dim)) of the same entries is
    refused before any dispatch."""
    rng = np.random.default_rng(dim + k)
    diag = rng.standard_normal(dim)
    cols = rng.integers(0, dim, size=(dim, k)).astype(np.int32)
    vals = rng.standard_normal((dim, k))
    xk = rng.standard_normal((3, dim))
    tdiag, tcols, tvals, txk = map(torch.from_numpy, (diag, cols, vals, xk))
    block = kernels.ell_spmv(tdiag, tcols, tvals, txk).numpy()
    assert block.shape == (3, dim)
    for b in range(3):
        expect = np.asarray(pk.ell_spmv_or_fallback(
            jnp.asarray(diag), jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(xk[b])))
        got = kernels.ell_spmv(tdiag, tcols, tvals, txk[b]).numpy()
        scale = np.abs(expect).max()
        assert np.abs(got - expect).max() <= 1e-13 * scale
        assert np.abs(block[b] - expect).max() <= 1e-13 * scale
    tc = torch.from_numpy(np.ascontiguousarray(cols.T)).T
    tv = torch.from_numpy(np.ascontiguousarray(vals.T)).T
    assert tc.shape == (dim, k) and torch.equal(tc, tcols)
    if k > 1:   # with K = 1 the two layouts are one
        with pytest.raises(ValueError, match="contiguous"):
            kernels.ell_spmv(tdiag, tc, tv, txk[0])


@pytest.mark.parametrize("shape", [(1, 40, 30), (5, 40, 30), (3, 1, 7)])
def test_batched_plain_versions_match_einsum(shape):
    """``factor_matmul_ref`` and ``ell_spmv_ref`` on a batch against
    einsum, and a batch of one against the unbatched call."""
    rng = np.random.default_rng(sum(shape))
    r, m, k = shape
    x = rng.standard_normal(shape)
    a = rng.standard_normal((11, k))
    got = kernels.factor_matmul_ref(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.einsum("bmk,nk->bmn", x, a),
                               rtol=0, atol=1e-13)
    one = kernels.factor_matmul(torch.from_numpy(x[:1]), torch.from_numpy(a))
    np.testing.assert_array_equal(
        one[0].numpy(),
        kernels.factor_matmul(torch.from_numpy(x[0]),
                              torch.from_numpy(a)).numpy())
    dim = m * k
    diag = rng.standard_normal(dim)
    cols = rng.integers(0, dim, size=(dim, 4)).astype(np.int32)
    vals = rng.standard_normal((dim, 4))
    xk = x.reshape(r, dim)
    args = tuple(map(torch.from_numpy, (diag, cols, vals)))
    got = kernels.ell_spmv_ref(*args, torch.from_numpy(xk)).numpy()
    expect = diag * xk + np.einsum("rs,brs->br", vals, xk[:, cols])
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(
        kernels.ell_spmv(*args, torch.from_numpy(xk[:1]))[0].numpy(),
        kernels.ell_spmv(*args, torch.from_numpy(xk[0])).numpy())


def test_batched_factor_matmul_on_transposed_views():
    """The batched dn apply: Y[b]^T += X[b]^T . A^T through views, no
    copy, against einsum."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 9, 7)))     # (R, szd, szu)
    a = torch.from_numpy(rng.standard_normal((9, 9)))        # A_dn
    y0 = torch.from_numpy(rng.standard_normal((4, 9, 7)))
    y = y0.clone()
    out = kernels.factor_matmul(x.transpose(1, 2), a,
                                out=y.transpose(1, 2), accumulate=True)
    assert out.data_ptr() == y.data_ptr()
    np.testing.assert_allclose(
        y.numpy(), y0.numpy() + np.einsum("dc,bcu->bdu", a.numpy(),
                                          x.numpy()), rtol=0, atol=1e-13)


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
    # 14 states of 12 sites: 14 x 64 large tiles fill the card
    ("batch_dn924", (False, True, True, True, False, 128)),
    # the 14-site N_up = 8 sector under a batch: odd pitch 3003
    ("batch_dn3003", (False, False, True, True, False, 128)),
    # an odd batch stride puts every other member 8 bytes off
    ("batch_odd_stride", (True, False, True, True, False, 64)),
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
    elif case == "batch_dn924":
        col = (924 * 924, 1, 924)
        args = (base, col, base, (924, 1), base, col, 924, 924, 132, 14)
    elif case == "batch_dn3003":
        col = (3432 * 3003, 1, 3003)
        args = (base, col, base, (3432, 1), base, col, 3003, 3432, 132, 14)
    elif case == "batch_odd_stride":
        args = (base, (801, 8, 1), base, (8, 1), base, (801, 8, 1), 100, 8,
                132, 3)
    elif case == "wide257":
        args = (base, (257, 1), base, (257, 1), base, (123, 1), 300, 123)
    elif case == "offset1":
        args = (base + 8, (3432, 1), base + 8, (3432, 1), base + 8,
                (3432, 1), 3432, 3432)
    else:
        args = (base, (700, 2), base, (3, 900), base, (1400, 2), 300, 300)
    plan = kernels.factor_matmul_plan(*args)
    assert tuple(plan) == expect
    assert kernels.factor_matmul_plan(*args[:8], sm_count=1).tile == 128
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
    # a block of states as the batched dn apply hands it over
    xb = torch.zeros(5, 6, 8, dtype=torch.float64).transpose(1, 2)
    yb = torch.zeros(5, 6, 8, dtype=torch.float64).transpose(1, 2)
    plan = kernels.factor_matmul_plan(
        xb.data_ptr(), xb.stride(), a.data_ptr(), a.stride(), yb.data_ptr(),
        yb.stride(), 8, 6, batch=5)
    assert (plan.x_kmajor, plan.x_vec16, plan.y_vec16) == (False, True, False)


def test_tile_rule_counts_the_whole_batch():
    """64 large tiles of one 924^2 product leave the card half empty; from
    three such products on there is one for every SM."""
    row = (924, 1)
    tiles = [kernels.factor_matmul_plan(0, (924 * 924, *row), 0, row, 0,
                                        (924 * 924, *row), 924, 924,
                                        batch=batch).tile
             for batch in (1, 2, 3, 14)]
    assert tiles == [64, 64, 128, 128]


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
    xb = torch.randn(3, 40, 30, generator=g, dtype=torch.float64)
    np.testing.assert_array_equal(kernels.factor_matmul(xb, a).numpy(),
                                  kernels.factor_matmul_ref(xb, a).numpy())
    vb = torch.randn(3, 50, generator=g, dtype=torch.float64)
    np.testing.assert_array_equal(
        kernels.ell_spmv(diag, cols, vals, vb).numpy(),
        kernels.ell_spmv_ref(diag, cols, vals, vb).numpy())
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
                                  "ell_vector_strided", "ell_k_major",
                                  "ell_block_strided", "ell_block_3d",
                                  "ell_block_width", "batch_out_shape",
                                  "batch_4d", "batch_factor_3d"])
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
        elif case == "ell_vector_strided":
            kernels.ell_spmv(torch.zeros(8)[::2],
                             torch.zeros(4, 2, dtype=torch.int32),
                             torch.zeros(4, 2), torch.zeros(4))
        elif case == "ell_k_major":
            kernels.ell_spmv(torch.zeros(4),
                             torch.zeros(2, 4, dtype=torch.int32).T,
                             torch.zeros(2, 4).T, torch.zeros(4))
        elif case.startswith("ell_block"):
            block = {"ell_block_strided": torch.zeros(4, 3).T,
                     "ell_block_3d": torch.zeros(2, 3, 4),
                     "ell_block_width": torch.zeros(3, 5)}[case]
            kernels.ell_spmv(torch.zeros(4),
                             torch.zeros(4, 2, dtype=torch.int32),
                             torch.zeros(4, 2), block)
        elif case == "batch_out_shape":
            kernels.factor_matmul(torch.zeros(2, 4, 3, dtype=torch.float64),
                                  torch.zeros(5, 3, dtype=torch.float64),
                                  out=torch.zeros(4, 5, dtype=torch.float64))
        elif case == "batch_4d":
            kernels.factor_matmul(torch.zeros(2, 2, 4, 3, dtype=torch.float64),
                                  torch.zeros(5, 3, dtype=torch.float64))
        else:
            kernels.factor_matmul(torch.zeros(2, 4, 3, dtype=torch.float64),
                                  torch.zeros(2, 5, 3, dtype=torch.float64))


def test_overlap_detection():
    base = torch.zeros(10, 10)
    assert kernels._overlaps(base[:5], base[4:])
    assert not kernels._overlaps(base[:5], base[5:])
    assert kernels._overlaps(base.T, base)
    # 3-D operands: a block's members interleaved with another's do
    # overlap as spans, two halves of one buffer do not
    cube = torch.zeros(4, 6, 5)
    assert kernels._overlaps(cube[::2], cube[1::2])
    assert not kernels._overlaps(cube[:2].transpose(1, 2), cube[2:])


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
