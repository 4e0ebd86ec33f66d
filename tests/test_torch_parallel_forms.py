"""The port's distributed forms and solvers (``parallel/mesh``, ``kron``,
``halo``, ``blockkron_dist``) on gloo worlds of 2 and 4 ranks on the CPU
(``torch_parallel_paths.forms`` and ``solves``, every world spawned once
for the module), held against the single-process port and against the
JAX package's sharded runs on the same number of virtual devices.

Tolerances: each form's apply, to one state and to a block of 3, equals
the single-process port's to 1e-12 of max |y| and the JAX package's
sharded matvec to 1e-10 (the flat ELL, Kronecker, halo and
halo-Kronecker forms on the flat cases, remainders and padding included;
the column-sharded block form on t-J and the Rashba half-cut).  E0 of
every solver to 1e-10 relative against the single-process port and 1e-9
absolute against the JAX package's distributed solver, the ground
state's overlap 1 - 1e-7; the halo form's plain (alpha, beta) from one
start vector to 1e-10 for 20 coefficients; the budget, unconvergence,
restart and keyword paths as ``tests/test_distributed.py:301-370``
holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.parallel import blockkron_dist as jbk
from lanczosplusplus_tpu.parallel import halo as jhalo
from lanczosplusplus_tpu.parallel import kron as jkron
from lanczosplusplus_tpu.parallel import mesh as jmesh
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_parallel_plans import jax_case
from torch_parallel_paths import (CASES, FACTORED, FLAT, FORMS, inputs,
                                  port_case)
from torch_world import run_world

torch.set_num_threads(2)

SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = tmp_path_factory.mktemp("forms")
    return {(size, what): run_world(size, f"torch_parallel_paths:{what}",
                                    work, timeout=150)[0]
            for size in SIZES for what in ("forms", "solves")}


def jax_factored(name):
    """The JAX package's factored form of a factored case."""
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.rashba_halfcut import \
        build_halfcut_rashba
    from lanczosplusplus_tpu.models.tj_factored import build_factored_tj

    text, parts = CASES[name]
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(parts)
    if name == "tj8":
        return build_factored_tj(model, basis, dtype=np.float64)
    return build_halfcut_rashba(model, basis, dtype=np.float64)


def jax_sharded(jham, form, ndev):
    """The JAX package's sharded form of a flat case on `ndev` virtual
    devices."""
    mesh = jmesh.make_mesh(jax.devices()[:ndev])
    if form == "flat":
        return jmesh.shard_hamiltonian(jham, mesh), mesh
    if form == "kron":
        return jkron.shard_kron_hamiltonian(jham, mesh)[0], mesh
    if form == "halo":
        return jhalo.HaloPlan(jham, ndev).hamiltonian(mesh), mesh
    if form == "kronhalo":
        return jhalo.KronHaloPlan(jham, ndev).hamiltonian(mesh), mesh
    return jbk.shard_blockkron(jham.inner, mesh), mesh


def _jax_apply(sham, mesh, x):
    xp = np.concatenate([x, np.zeros(sham.dim - x.shape[0])])
    return np.asarray(jax.jit(lambda h, v: h.matvec(v))(
        sham, jmesh.sharded_vector(jnp.asarray(xp), mesh)))[:x.shape[0]]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FLAT)
@pytest.mark.parametrize("form", FORMS)
def test_flat_case_forms(worlds, size, name, form):
    y, Y, fraction = worlds[size, "forms"][name, form]
    _, _, ham = port_case(name)
    x, X = inputs(ham.dim, 1), inputs(ham.dim, 2, 3)
    assert _rel(y, ham.matvec(x).numpy()) <= 1e-12
    assert _rel(Y, ham.matmat_t(X).numpy()) <= 1e-12
    sham, mesh = jax_sharded(jax_case(name), form, size)
    assert _rel(y, _jax_apply(sham, mesh, x.numpy())) <= 1e-10
    if form == "halo":
        assert np.array_equal(worlds[size, "forms"][name, "halo matvec_fn"],
                              y)
    if form in ("halo", "kronhalo"):
        plan = (jhalo.HaloPlan if form == "halo" else jhalo.KronHaloPlan)(
            jax_case(name), size)
        assert fraction == plan.halo_fraction


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FACTORED)
def test_block_kronecker_form(worlds, size, name):
    y, Y, _ = worlds[size, "forms"][name, "blockkron"]
    _, _, fact, _ = port_case(name)
    x, X = inputs(fact.dim, 1), inputs(fact.dim, 2, 3)
    assert _rel(y, fact.inner.matvec(x).numpy()) <= 1e-12
    assert _rel(Y, fact.inner.matmat_t(X).numpy()) <= 1e-12
    sham, mesh = jax_sharded(jax_factored(name), "blockkron", size)
    assert _rel(y, _jax_apply(sham, mesh, x.numpy())) <= 1e-10


def _single(name):
    """(E0, ground state) of the single-process port, in flat order."""
    if name in FACTORED:
        _, _, fact, _ = port_case(name)
        evals, vecs = lz.lowest_states(fact, max_steps=160)
    else:
        _, _, ham = port_case(name)
        evals, vecs = lz.lowest_states(ham, max_steps=120)
    return float(evals[0]), vecs[0].numpy()


def _jax_solve(name, how, ndev):
    """E0 of the JAX package's distributed solver `how` on a case."""
    from lanczosplusplus_tpu.parallel.halo import halo_lowest_states
    mesh = jmesh.make_mesh(jax.devices()[:ndev])
    if name in FACTORED:
        return float(jmesh.distributed_lowest_states(
            jax_factored(name), mesh, max_steps=160)[0][0])
    jham = jax_case(name)
    solver = {"distributed": jmesh.distributed_lowest_states,
              "halo": halo_lowest_states,
              "kron": jkron.kron_lowest_states}[how]
    return float(solver(jham, mesh, max_steps=120)[0][0])


SOLVES = [("hubbard8", "distributed"), ("hubbard8", "halo"),
          ("hubbard8", "flat"), ("hubbard8", "halo flat"),
          ("hubbard8", "kron"), ("hubbard7", "distributed"),
          ("hubbard7", "halo"), ("she7", "distributed"), ("she7", "halo"),
          ("feas4", "distributed"), ("feas4", "halo"),
          ("tj8", "distributed"), ("rashba6", "distributed")]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name,how", SOLVES)
def test_solver(worlds, size, name, how):
    e0, vec = worlds[size, "solves"][name, how]
    e_s, v_s = _single(name)
    assert abs(e0 - e_s) <= 1e-10 * abs(e_s)
    assert abs(np.vdot(vec, v_s)) >= 1.0 - 1e-7
    if size == 4 and how in ("distributed", "halo", "kron"):
        assert abs(e0 - _jax_solve(name, how, size)) <= 1e-9


@pytest.mark.parametrize("size", SIZES)
def test_halo_plain_tridiagonal(worlds, size):
    """From one start vector the halo form's plain (alpha, beta) are the
    single-process port's."""
    alphas, betas = worlds[size, "solves"]["halo plain"]
    _, _, ham = port_case("hubbard8")
    v0 = inputs(ham.dim, 5)
    res = lz.tridiagonalize_plain(ham, v0 / torch.linalg.vector_norm(v0), 60)
    np.testing.assert_allclose(alphas[:20], res.alphas[:20], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(betas[:20], res.betas[:20], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("size", SIZES)
def test_budget_forces_two_pass(worlds, size):
    """Half the stored basis: the plain two-pass solver, no residual, and
    the single-process two-pass solve's energy and state."""
    e0, vec, no_residual, steps = worlds[size, "solves"]["two-pass"]
    _, _, ham = port_case("hubbard8")
    evals, vecs = lz.lowest_states_plain(ham, max_steps=80)
    assert no_residual and steps == 80
    assert abs(e0 - float(evals[0])) <= 1e-9
    assert abs(np.vdot(vec, vecs[0].numpy())) >= 1.0 - 1e-6


@pytest.mark.parametrize("size", SIZES)
def test_unconverged_flag_and_strict(worlds, size):
    converged, raised = worlds[size, "solves"]["unconverged"]
    assert not converged and raised


@pytest.mark.parametrize("size", SIZES)
def test_memory_bounded_restart(worlds, size):
    """A budget that fits 40 steps but not 80 restarts from the Ritz
    vector, single-state, and still converges to the ground state."""
    e0, converged, steps = worlds[size, "solves"]["restart"]
    e_s, _ = _single("hubbard8")
    assert converged and steps == 40
    assert abs(e0 - e_s) <= 1e-9


@pytest.mark.parametrize("size", SIZES)
def test_solve_keywords(worlds, size):
    e_h, conv_h, e_k, conv_k = worlds[size, "solves"]["keywords"]
    e_s, _ = _single("hubbard8")
    assert conv_h and conv_k
    assert abs(e_h - e_s) <= 1e-9 and abs(e_k - e_s) <= 1e-9


def test_jax_single_and_port_single_agree():
    """The single-process references agree with the JAX package's own
    single-device solve (the chain the parallel tests stand on)."""
    e_s, _ = _single("hubbard8")
    assert abs(e_s - float(jlz.lowest_states(jax_case("hubbard8"),
                                             max_steps=120)[0][0])) <= 1e-9
