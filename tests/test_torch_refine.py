"""The float64 refinement of a solve below float64 (``ops/refine``,
``solver/lanczos._maybe_refine``) held against the JAX package's
(``ops/df64``: ``host_matvec_f64``, ``host_refined_energy``,
``rqi_refined_energy``, ``refinement_flops``) on the CPU: the same stored
float32, bfloat16 and complex64 tables, the same numpy states from a
seed, the JAX functions run with x64 on as its own tests run them
(tests/test_df64.py).  The forms: the 8-site Hubbard chain (flat, its
one-spin part in gather form and with bf16 dense factors), the factored
Heisenberg ring, a complex Rashba-like ELL, a bf16cross Rashba half-cut
and bf16 Kitaev factors.

Tolerances: float64 applies of the same tables agree to 1e-12 of max |y|
(sum order); Rayleigh quotients to 1e-12 relative; RQI energies, which
both packages drive from one float32 Ritz vector to the float64 bar, to
1e-10 relative of each other and of the float64 solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.core.sparse import (EllPart as JaxEllPart,
                                             Hamiltonian as JaxHamiltonian,
                                             coo_to_ell)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models import (
    factored_hamiltonian_or_none as jax_factored)
from lanczosplusplus_tpu.models.kitaev_factored import (
    build_factored_kitaev as jax_build_kitaev)
from lanczosplusplus_tpu.ops import df64
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.core.sparse import hamiltonian_from_numpy
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    build_factored_kitaev)
from lanczosplusplus_tpu_torch.ops import refine
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_host import hubbard_chain_text
from test_torch_inputs import heisenberg_text, kitaev_text, rashba_text, tj_text

torch.set_num_threads(2)


def _models(text):
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    return model, model.create_basis(parts), jmodel, \
        jmodel.create_basis(parts), parts


def _hubbard(dense_bf16=False):
    model, basis, jmodel, jbasis, _ = _models(hubbard_chain_text(8))
    ham = model.hamiltonian(basis, dtype=torch.float32)
    jham = jmodel.hamiltonian(jbasis, dtype=np.float32)
    if dense_bf16:
        ham = ham.densify_factors(factor_dtype=torch.bfloat16)
        jham = jham.densify_factors(factor_dtype=jnp.bfloat16)
    return ham, jham


def _heisenberg_factored(nsite=10):
    model, basis, jmodel, jbasis, parts = _models(
        heisenberg_text(nsite, 1, nsite // 2))
    return (factored_hamiltonian_or_none(model, basis, parts, torch.float32),
            jax_factored(jmodel, jbasis, parts, np.float32))


def _complex_ell(dim=400, seed=5):
    """tests/test_df64.py's random sparse complex Hermitian matrix, as a
    complex64 ELL over a float32 diagonal."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal(
        (dim, dim))
    m = (m + m.conj().T) / 2
    m *= (rng.random((dim, dim)) < 0.02)
    m = (m + m.conj().T) / 2
    diag = np.real(np.diag(m)).copy()
    off = m - np.diag(np.diag(m))
    r, c = np.nonzero(off)
    cols, vals = coo_to_ell(dim, r, c, off[r, c])
    ham = hamiltonian_from_numpy(diag, cols, vals, None, None, None, None,
                                 None, "cpu", torch.complex64)
    jham = JaxHamiltonian(diag=jnp.asarray(diag, jnp.float32),
                          ell=JaxEllPart(cols=jnp.asarray(cols),
                                         vals=jnp.asarray(vals,
                                                          jnp.complex64)),
                          factorized=None, spin_shape=None)
    return ham, jham


def _rashba_bf16cross():
    model, basis, jmodel, jbasis, parts = _models(
        rashba_text(6, 5, r=0.5, u=4.0, periodic=1))
    return (factored_hamiltonian_or_none(model, basis, parts, torch.float32,
                                         cross_dtype=torch.bfloat16),
            jax_factored(jmodel, jbasis, parts, np.float32,
                         cross_dtype=jnp.bfloat16))


def _kitaev_bf16():
    model, basis, jmodel, jbasis, _ = _models(
        kitaev_text(8, 1.1, 0.7, 0.9, periodic=1))
    return (build_factored_kitaev(model, basis, dtype=torch.float32,
                                  factor_dtype=torch.bfloat16),
            jax_build_kitaev(jmodel, jbasis, dtype=np.float32,
                             factor_dtype=jnp.bfloat16))


FORMS = {"hubbard8": _hubbard,
         "hubbard8_bf16_factors": lambda: _hubbard(dense_bf16=True),
         "heisenberg10_factored": _heisenberg_factored,
         "complex_ell": _complex_ell,
         "rashba6_bf16cross": _rashba_bf16cross,
         "kitaev8_bf16": _kitaev_bf16}


def _state(form, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(form.dim)
    if form.dtype.is_complex:
        x = x + 1j * rng.standard_normal(form.dim)
    return x


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_matvec_f64_matches_jax_host_matvec(name):
    """The float64 twin applies what JAX ``host_matvec_f64`` applies: the
    stored tables widened (bf16 factors as rounded), bf16cross amplitudes
    at full precision with no state cast, the one-spin part through its
    gather maps."""
    ham, jham = FORMS[name]()
    x = _state(ham)
    got = refine.matvec_f64(ham, torch.from_numpy(x))
    assert got.dtype in (torch.float64, torch.complex128)
    assert _rel(got.numpy(), df64.host_matvec_f64(jham, x)) <= 1e-12
    twin = refine.f64_twin(ham)
    assert not getattr(twin, "quantized", False)
    assert refine.f64_twin(twin) is twin


@pytest.mark.parametrize("name", sorted(FORMS))
def test_host_refined_energy_matches_jax(name):
    ham, jham = FORMS[name]()
    x = _state(ham, seed=7)
    got = refine.host_refined_energy(ham, torch.from_numpy(x))
    want = df64.host_refined_energy(jham, x)
    assert abs(got - want) <= 1e-12 * abs(want)


def test_refinement_flops_match_jax():
    for name in ("hubbard8", "heisenberg10_factored", "rashba6_bf16cross",
                 "kitaev8_bf16", "complex_ell"):
        ham, jham = FORMS[name]()
        assert refine.refinement_flops(ham) == df64.refinement_flops(jham)


def test_host_matvec_f64_blockkron_is_the_forms_matvec():
    """tests/test_df64.py::test_host_matvec_f64_blockkron on the port: on
    a float64 factored form the twin is the form itself."""
    model, basis, jmodel, jbasis, parts = _models(heisenberg_text(8, 1, 4))
    ham = factored_hamiltonian_or_none(model, basis, parts, torch.float64)
    jham = jax_factored(jmodel, jbasis, parts, np.float64)
    assert refine.f64_twin(ham) is ham
    x = _state(ham)
    y = refine.matvec_f64(ham, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ham.matvec(torch.from_numpy(x)).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(y, df64.host_matvec_f64(jham, x), atol=1e-12)


@pytest.mark.parametrize("name", ["hubbard8", "heisenberg10_factored",
                                  "complex_ell", "rashba6_bf16cross"])
def test_rqi_refined_energy_matches_jax(name):
    """From one float32 Ritz vector (the JAX solve's, unrefined), both
    packages' RQI reach the float64 energy of the stored tables: within
    1e-10 of each other and of a float64 solve of those tables."""
    ham, jham = FORMS[name]()
    _, jvecs = jlz.lowest_states(jham, max_steps=150, refine=False,
                                 dense_fallback_dim=0)
    v = np.array(jvecs[0])
    got = refine.rqi_refined_energy(ham, torch.from_numpy(v))
    want = df64.rqi_refined_energy(jham, v)
    e64 = lz.lowest_states(refine.f64_twin(ham), max_steps=200,
                           dense_fallback_dim=0)[0][0]
    assert abs(got - want) <= 1e-10 * abs(want)
    assert abs(got - e64) <= 1e-10 * abs(e64)


def test_gmres_solves_the_shifted_system():
    """The correction solve alone: restarted GMRES on a well-conditioned
    shifted system meets its relative tolerance."""
    ham, _ = _hubbard()
    b = torch.from_numpy(_state(ham, seed=11).astype(np.float32))

    def apply(z):
        return ham.matvec(z.contiguous()) + 30.0 * z
    t = refine.gmres(apply, b, restart=20, maxiter=3, tol=1e-4)
    assert t.dtype == torch.float32
    assert (torch.linalg.vector_norm(apply(t) - b)
            / torch.linalg.vector_norm(b)).item() <= 1e-4


@pytest.mark.parametrize("name", ["hubbard8", "heisenberg10_factored",
                                  "complex_ell"])
def test_lowest_states_auto_refines_float32(name):
    """A float32 (complex64) solve comes back refined: within 1e-10 of the
    float64 solve of the same tables, as the JAX package's automatic
    refinement (tests/test_df64.py::test_lowest_states_auto_refines_f32,
    test_rqi_factored_reaches_f64_bar)."""
    ham, jham = FORMS[name]()
    e32, vecs, info = lz.lowest_states(ham, max_steps=150,
                                       dense_fallback_dim=0,
                                       return_info=True)
    assert vecs.dtype == ham.dtype and info.converged
    e64 = lz.lowest_states(refine.f64_twin(ham), max_steps=200,
                           dense_fallback_dim=0)[0][0]
    je32 = jlz.lowest_states(jham, max_steps=150, dense_fallback_dim=0)[0][0]
    assert abs(float(e32[0]) - e64) <= 1e-10 * abs(e64)
    assert abs(float(e32[0]) - float(je32)) <= 1e-10 * abs(e64)
    unrefined = lz.lowest_states(ham, max_steps=150, dense_fallback_dim=0,
                                 refine=False)[0][0]
    assert abs(unrefined - e64) > abs(float(e32[0]) - e64)


@pytest.mark.parametrize("text", [tj_text(8, 3, 3, periodic=1),
                                  heisenberg_text(10, 1, 5, j=0.7)],
                         ids=["tj8", "heisenberg10_j07"])
def test_engine_float32_refines_against_float64_couplings(text):
    """The Engine builds every form in float64 and solves its float32 copy
    (``refine.narrowed``): couplings float32 cannot hold (0.3, 0.7) keep
    their float64 values in the refinement, so the energy is the float64
    one to 1e-10, in the flat and the factored form, against the JAX
    package's float64 Engine."""
    from lanczosplusplus_tpu.engine import Engine as JaxEngine
    for solver in ("none", "factored"):
        t = text.replace("SolverOptions=none", f"SolverOptions={solver}")
        inp = parse_input(t)
        model = build_model(inp, Geometry(inp))
        eng = Engine(model, inp, config=Config(device="cpu",
                                               real_dtype=torch.float32))
        assert eng.eigenvector(0).dtype == torch.float32
        jinp = jax_parse(t)
        want = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)),
                         jinp).ground_energy
        assert abs(eng.ground_energy - want) <= 1e-10 * abs(want)


def test_narrowed_shares_index_tables():
    model, basis, _, _, parts = _models(
        rashba_text(6, 5, r=0.5, u=4.0, periodic=1))
    form = factored_hamiltonian_or_none(model, basis, parts, torch.float64,
                                        cross_dtype=torch.bfloat16)
    low = refine.narrowed(form)
    assert low.dtype == torch.float32 and low.quantized
    assert low.inner.perm_cross[0].row_src is form.inner.perm_cross[0].row_src
    assert low.sign.dtype == torch.float32
    x = torch.from_numpy(_state(form, seed=2))
    y = low.matvec(x.float()).double()
    y64 = refine.f64_twin(form).matvec(x)
    assert _rel(y.numpy(), y64.numpy()) <= 1e-2
