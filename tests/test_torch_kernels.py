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
                                  "ell_shape", "ell_index_dtype"])
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
        else:
            kernels.ell_spmv(torch.zeros(4), torch.zeros(4, 2, dtype=torch.int64),
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
