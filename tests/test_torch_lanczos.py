"""The port's Lanczos solver held against the JAX package's on the CPU in
float64, from the same numpy start vector: the (alpha, beta) tridiagonal,
the ground energy, the plain two-pass path, restarts and the dense
fallback."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_host import INPUT0, hubbard_chain_text

torch.set_num_threads(2)


def _hams(text):
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    return (model.hamiltonian(model.create_basis(parts), device="cpu"),
            jmodel.hamiltonian(jmodel.create_basis(parts), dtype=np.float64))


@pytest.fixture(scope="module")
def chain8():
    ham, jham = _hams(hubbard_chain_text(8))
    v0 = np.random.default_rng(11).standard_normal(ham.dim)
    return ham, jham, v0 / np.linalg.norm(v0)


@pytest.mark.parametrize("reorth", ["selective", "full"])
def test_tridiagonal_equal(chain8, reorth):
    ham, jham, v0 = chain8
    res = lz.tridiagonalize(ham, v0, 30, reorth=reorth)
    jres = jlz.tridiagonalize(jham, jnp.asarray(v0), 30, reorth=reorth)
    assert res.m == jres.m == 30
    np.testing.assert_allclose(res.alphas, jres.alphas, rtol=1e-9)
    np.testing.assert_allclose(res.betas, jres.betas, rtol=1e-9)
    # the stored basis is orthonormal
    V = res.V.numpy()
    np.testing.assert_allclose(V @ V.T, np.eye(30), atol=1e-9)


def test_lowest_states_e0_equal(chain8):
    ham, jham, v0 = chain8
    evals, vecs, info = lz.lowest_states(ham, v0=v0, return_info=True)
    jevals, _ = jlz.lowest_states(jham, v0=jnp.asarray(v0))
    assert abs(evals[0] - jevals[0]) <= 1e-10 * abs(jevals[0])
    assert info.converged and not info.used_dense_fallback
    assert vecs.shape == (1, ham.dim)
    v = vecs[0]
    resid = torch.linalg.vector_norm(ham.matvec(v) - evals[0] * v).item()
    assert resid < 1e-6


def test_plain_two_pass_under_tiny_budget(chain8):
    """A Krylov budget below one basis routes to lowest_states_plain."""
    ham, jham, v0 = chain8
    evals, vecs, info = lz.lowest_states(ham, v0=v0, return_info=True,
                                         krylov_budget_bytes=1024)
    assert np.isnan(info.residual)
    jevals, _ = jlz.lowest_states(jham, v0=jnp.asarray(v0))
    assert abs(evals[0] - jevals[0]) <= 1e-10 * abs(jevals[0])
    pe, pvecs = lz.lowest_states_plain(ham, v0=v0, max_steps=200)
    assert pe[0] == evals[0]
    rq = torch.vdot(pvecs[0], ham.matvec(pvecs[0])).item()
    assert abs(rq - jevals[0]) <= 1e-8 * abs(jevals[0])


def test_restart_at_budget_converges(chain8):
    """A budget that holds 20 steps but not 40 restarts from the Ritz
    vector instead of doubling, and still converges."""
    ham, jham, v0 = chain8
    budget = 30 * ham.dim * 8
    evals, _, info = lz.lowest_states(ham, v0=v0, max_steps=20,
                                      krylov_budget_bytes=budget,
                                      dense_fallback_dim=0,
                                      return_info=True)
    jevals, _ = jlz.lowest_states(jham, v0=jnp.asarray(v0))
    assert info.converged and info.steps == 20
    assert abs(evals[0] - jevals[0]) <= 1e-10 * abs(jevals[0])


def test_unconverged_strict_raises(chain8):
    ham, _, v0 = chain8
    with pytest.raises(RuntimeError, match="failed to converge"):
        lz.lowest_states(ham, v0=v0, max_steps=3, tol=1e-14,
                         dense_fallback_dim=0, strict=True)


def test_dense_branch_and_fallback_equal():
    ham, jham = _hams(INPUT0)
    evals, vecs, info = lz.lowest_states(ham, return_info=True)
    jevals, jvecs = jlz.lowest_states(jham)
    assert info.used_dense_fallback and info.steps == 0
    np.testing.assert_allclose(evals, jevals, rtol=0, atol=1e-12)
    assert vecs.shape == (1, 36)
    np.testing.assert_allclose(np.abs(vecs.numpy()), np.abs(jvecs),
                               atol=1e-10)


def test_finish_lanczos_equal(chain8):
    ham, jham, v0 = chain8
    res = lz.tridiagonalize(ham, v0, 40, reorth="full")
    jres = jlz.tridiagonalize(jham, jnp.asarray(v0), 40, reorth="full")
    evals, vecs = lz.finish_lanczos(res.alphas, res.betas, res.V, 2)
    jevals, jvecs = jlz.finish_lanczos(jres.alphas, jres.betas, jres.V, 2)
    np.testing.assert_allclose(evals, jevals, rtol=1e-10)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), atol=1e-7)


def test_random_start_vector_is_seeded():
    a = lz.random_start_vector(100, 5, torch.float64, "cpu")
    b = lz.random_start_vector(100, 5, torch.float64, "cpu")
    c = lz.random_start_vector(100, 6, torch.complex128, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float64
    assert c.dtype == torch.complex128
    for v in (a, c):
        assert abs(torch.linalg.vector_norm(v).item() - 1.0) < 1e-14
