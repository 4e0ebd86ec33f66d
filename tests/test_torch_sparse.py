"""The port's sector Hamiltonians held against the JAX package's on the
CPU in float64: the same arrays from both packages' models, the same dense
matrices, and the same matvecs in the gather and the densified form."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.core.sparse import coo_to_ell as jax_coo_to_ell
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch.core.sparse import (coo_to_ell,
                                                  hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_torch_host import hubbard_chain_text, super_hubbard_text

torch.set_num_threads(2)

# 8-site HubbardOneBand PBC chain (dim 4900), 6-site SuperHubbardExtended
# open chain (dim 400)
CASES = {"chain8": hubbard_chain_text(8), "super6": super_hubbard_text(6)}


def _both(name):
    """(port Hamiltonian on the CPU, JAX Hamiltonian), both float64."""
    inp, jinp = parse_input(CASES[name]), jax_parse(CASES[name])
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    ham = model.hamiltonian(model.create_basis(parts), dtype=torch.float64,
                            device="cpu")
    jham = jmodel.hamiltonian(jmodel.create_basis(parts), dtype=np.float64)
    return ham, jham


def _jax_arrays(jham):
    f = jham.factorized
    ell = jham.ell
    return dict(diag=np.asarray(jham.diag),
                ell_cols=None if ell is None else np.asarray(ell.cols),
                ell_vals=None if ell is None else np.asarray(ell.vals),
                up_cols=np.asarray(f.up_cols), up_vals=np.asarray(f.up_vals),
                dn_cols=np.asarray(f.dn_cols), dn_vals=np.asarray(f.dn_vals),
                spin_shape=jham.spin_shape)


def _x(dim, seed=3):
    return np.random.default_rng(seed).standard_normal(dim)


@pytest.mark.parametrize("name", sorted(CASES))
def test_models_give_the_same_arrays(name):
    ham, jham = _both(name)
    ref = _jax_arrays(jham)
    np.testing.assert_array_equal(ham.diag.numpy(), ref["diag"])
    f = ham.factorized
    for key, t in (("up_cols", f.up_cols), ("up_vals", f.up_vals),
                   ("dn_cols", f.dn_cols), ("dn_vals", f.dn_vals)):
        np.testing.assert_array_equal(t.numpy(), ref[key], err_msg=key)
    assert (ham.ell is None) == (ref["ell_cols"] is None)
    if ham.ell is not None:
        np.testing.assert_array_equal(ham.ell.cols.numpy(), ref["ell_cols"])
        np.testing.assert_array_equal(ham.ell.vals.numpy(), ref["ell_vals"])
    assert ham.spin_shape == tuple(ref["spin_shape"])
    assert ham.dtype == torch.float64 and ham.dim == jham.dim


@pytest.mark.parametrize("name", sorted(CASES))
def test_to_dense_equal(name):
    ham, jham = _both(name)
    np.testing.assert_allclose(ham.to_dense(), jham.to_dense(),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("form", ["gather", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matvec_equal(name, form):
    ham, jham = _both(name)
    if form == "dense":
        ham = ham.densify_factors()
        assert ham.factorized.up_dense is not None
        assert ham.factorized.dn_dense is not None
    x = _x(ham.dim)
    expect = np.asarray(jham.matvec(jnp.asarray(x)))
    got = ham.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_hamiltonian_from_numpy_reproduces_matvec(name):
    _, jham = _both(name)
    ham = hamiltonian_from_numpy(**_jax_arrays(jham), device="cpu",
                                 dtype=torch.float64)
    x = _x(jham.dim, seed=4)
    expect = np.asarray(jham.matvec(jnp.asarray(x)))
    for h in (ham, ham.densify_factors()):
        np.testing.assert_allclose(h.matvec(torch.from_numpy(x)).numpy(),
                                   expect, rtol=0, atol=1e-12)


def test_ell_part_is_stored_k_major():
    """The generic ELL tensors keep the JAX package's (dim, K) shape and
    values but lie K-major, strides (1, dim), from the model and from
    ``hamiltonian_from_numpy`` alike, with the JAX Hamiltonian's dense
    matrix and matvec."""
    ham, jham = _both("super6")
    ref = _jax_arrays(jham)
    rebuilt = hamiltonian_from_numpy(**ref, device="cpu",
                                     dtype=torch.float64)
    dim, k = ref["ell_cols"].shape
    x = _x(dim, seed=5)
    expect = np.asarray(jham.matvec(jnp.asarray(x)))
    for h in (ham, rebuilt):
        for t, name in ((h.ell.cols, "ell_cols"), (h.ell.vals, "ell_vals")):
            assert t.shape == (dim, k) and t.stride() == (1, dim)
            assert t.T.is_contiguous()
            np.testing.assert_array_equal(t.numpy(), ref[name])
        assert h.ell.cols.dtype == torch.int32
        np.testing.assert_allclose(h.to_dense(), jham.to_dense(),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(h.matvec(torch.from_numpy(x)).numpy(),
                                   expect, rtol=0, atol=1e-12)


def test_densify_respects_max_bytes():
    ham, _ = _both("super6")
    assert ham.densify_factors(max_bytes=0) is ham
    dense = ham.densify_factors(max_bytes=20 * 20 * 8)
    assert dense.factorized.up_dense.shape == (20, 20)
    np.testing.assert_allclose(dense.to_dense(), ham.to_dense())


@pytest.mark.parametrize("nnz", [0, 300])
def test_coo_to_ell_equal(nnz):
    """Duplicates merged, cancellations dropped, padding self-pointing."""
    rng = np.random.default_rng(nnz)
    rows = rng.integers(0, 40, nnz)
    cols = rng.integers(0, 40, nnz)
    vals = rng.choice([-1.0, 0.5, 1.0], nnz)
    got = coo_to_ell(40, rows, cols, vals, min_k=2)
    expect = jax_coo_to_ell(40, rows, cols, vals, min_k=2)
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g, e)
