"""The port's sharded estimators (``parallel/mesh.distributed_*``), the
grand-canonical sweep on a mesh and the scatter plans, on gloo worlds of
2 and 4 ranks on the CPU (``torch_parallel_paths.estimators``, every
world spawned once for the module), each held against the single-process
port from the same start block and against the JAX package's distributed
estimator on the same number of virtual devices.

Tolerances: FTLM energies, specific heats, ln Z and observables 1e-8
(relative) against the single-process port; LTLM 1e-8; KPM moments 1e-10
of mu_0 (and, with bounds from the sharded form's own Lanczos run, 1e-8);
the fleet's first coefficients 1e-9; the FTLM dynamics' pole moments
1e-8 (relative, 1e-10 absolute), its sum rule to 1e-10; the
grand-canonical sweep 1e-8; the scatter plans 1e-12 of max |z|.  The
JAX package draws its own random blocks, so against it each estimator
runs from a block both sides are given: its distributed fleet, FTLM
dynamics and scatter plans from the same rows, its distributed FTLM,
LTLM and KPM from the port's own block (the JAX package's start-block
generator replaced, for the call, by one that returns the port's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.parallel import mesh as jmesh
from lanczosplusplus_tpu.parallel import scatter_plan as jscatter
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch.engine import ftlm as tftlm
from lanczosplusplus_tpu_torch.engine import kpm as tkpm
from lanczosplusplus_tpu_torch.engine.engine import apply_operator_map
from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import ftlm_dynamic
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.thermal import (GrandCanonicalFTLM,
                                                      operator_matrix)
from lanczosplusplus_tpu_torch.parallel.dryrun import build, hubbard_text
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_parallel_plans import jax_case
from torch_parallel_paths import inputs, port_case
from torch_world import run_world

torch.set_num_threads(2)

SIZES = (2, 4)
BETAS = np.asarray([0.5, 2.0])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = tmp_path_factory.mktemp("estimators")
    return {size: run_world(size, "torch_parallel_paths:estimators", work,
                            timeout=150)
            for size in SIZES}


@pytest.fixture
def port_blocks(monkeypatch):
    """The JAX package's distributed FTLM, LTLM and KPM draw their start
    block from its own generator (``solver.lanczos.random_start_block``,
    imported at each call); within a test that takes this fixture they
    get the port's block of the same (dim, R, seed), which the JAX side
    then pads and shards as it always does."""
    def block(dim, num, seed, dtype):
        v = lz.random_start_block(dim, num, seed, torch.float64, "cpu")
        return jnp.asarray(v.numpy(), dtype=dtype)
    monkeypatch.setattr(jlz, "random_start_block", block)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("size", SIZES)
def test_every_rank_has_the_same_estimates(worlds, size):
    ranks = worlds[size]
    for other in ranks[1:]:
        for key in ("ftlm", "ltlm", "kpm", "grand canonical"):
            for a, b in zip(ranks[0][key] if isinstance(ranks[0][key], tuple)
                            else (ranks[0][key],),
                            other[key] if isinstance(other[key], tuple)
                            else (other[key],)):
                assert np.array_equal(a, b), key


@pytest.mark.parametrize("size", SIZES)
def test_ftlm(worlds, size, port_blocks):
    energy, cv, log_z, one = worlds[size][0]["ftlm"]
    _, _, ham = port_case("hubbard8")
    res = tftlm.ftlm(ham, BETAS, num_vectors=12, steps=40, seed=5,
                     operators={"one": np.ones(ham.dim)})
    _close(energy, res.energy, 1e-8)
    _close(cv, res.specific_heat, 1e-8, 1e-10)
    _close(log_z, res.log_z, 1e-8)
    _close(one, res.observables["one"], 1e-8)
    # the JAX package's distributed estimator from the same block
    jres = jmesh.distributed_ftlm(jax_case("hubbard8"),
                                  jmesh.make_mesh(jax.devices()[:size]),
                                  BETAS, num_vectors=12, steps=40, seed=5,
                                  operators={"one": np.ones(ham.dim)})
    _close(energy, jres.energy, 1e-8)
    _close(log_z, jres.log_z, 1e-8)
    _close(one, jres.observables["one"], 1e-8)


@pytest.mark.parametrize("size", SIZES)
def test_ltlm(worlds, size, port_blocks):
    obs, energy, log_z = worlds[size][0]["ltlm"]
    _, _, ham = port_case("hubbard8")
    ops = {"obs": np.linspace(0.0, 1.0, ham.dim), "energy": ham}
    res = tftlm.ltlm(ham, BETAS, ops, num_vectors=4, steps=30, seed=9)
    _close(obs, res["obs"], 1e-8)
    _close(energy, res["energy"], 1e-8)
    _close(log_z, res["_log_z"], 1e-8)
    jham = jax_case("hubbard8")
    jres = jmesh.distributed_ltlm(jham, jmesh.make_mesh(jax.devices()[:size]),
                                  BETAS, {"obs": ops["obs"], "energy": jham},
                                  num_vectors=4, steps=30, seed=9)
    _close(obs, jres["obs"], 1e-8)
    _close(energy, jres["energy"], 1e-8)


@pytest.mark.parametrize("size", SIZES)
def test_kpm(worlds, size, port_blocks):
    _, _, ham = port_case("hubbard8")
    got = worlds[size][0]["kpm"]
    want = tkpm.kpm_dos(ham, num_moments=32, num_vectors=8, seed=3,
                        bounds=(-30.0, 30.0)).moments
    assert np.abs(got - want).max() <= 1e-10 * abs(want[0])
    jm = np.asarray(jmesh.distributed_kpm_dos(
        jax_case("hubbard8"), jmesh.make_mesh(jax.devices()[:size]),
        num_moments=32, num_vectors=8, seed=3, bounds=(-30.0, 30.0)).moments)
    assert np.abs(got - jm).max() <= 1e-10 * abs(jm[0])
    moments, a, b = worlds[size][0]["kpm auto"]
    auto = tkpm.kpm_dos(ham, num_moments=32, num_vectors=8, seed=3)
    assert abs(a - auto.a) <= 1e-10 * abs(auto.a)
    assert abs(b - auto.b) <= 1e-10 * max(abs(auto.b), 1.0)
    assert np.abs(moments - auto.moments).max() <= 1e-8 * auto.moments[0]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["hubbard8", "tj8"])
def test_spectral_fleet(worlds, size, name):
    """The first coefficients of each row against the single-process
    recurrence and the JAX package's distributed fleet from the same
    rows (in flat order; a factored form's fleet runs in block order)."""
    key = "fleet" if name == "hubbard8" else "fleet tj8"
    got = worlds[size][0][key]
    if name == "hubbard8":
        _, _, ham = port_case(name)
        v0s = inputs(ham.dim, 3, 3)
        want_ham, want_rows = ham, v0s
        jham = jax_case(name)
        steps = 40
    else:
        from test_torch_parallel_forms import jax_factored
        _, _, fact, _ = port_case(name)
        v0s = inputs(fact.dim, 4, 2)
        want_ham, want_rows = fact.inner, fact.to_inner(v0s)
        jham = jax_factored(name)
        steps = 30
    v0s = v0s / torch.linalg.vector_norm(v0s, dim=1, keepdim=True)
    want_rows = want_rows / torch.linalg.vector_norm(want_rows, dim=1,
                                                     keepdim=True)
    want = lz.tridiagonalize_plain_batched(want_ham, want_rows, steps)
    jmesh_ = jmesh.make_mesh(jax.devices()[:size])
    jgot = jmesh.distributed_spectral_fleet(jham, jmesh_, v0s.numpy(),
                                            steps=steps)
    for (alphas, betas), w, j in zip(got, want, jgot):
        _close(alphas[:10], w.alphas[:10], 0, 1e-9)
        _close(betas[:10], w.betas[:10], 0, 1e-9)
        _close(alphas[:10], np.asarray(j.alphas)[:10], 0, 1e-9)


def _moments(poles):
    om, wt = poles
    return np.asarray([(wt * om ** k).sum() for k in range(3)])


@pytest.mark.parametrize("size", SIZES)
def test_ftlm_dynamic_across_sectors(worlds, size):
    """c^dag_up at site 0 from the (2, 2) to the (3, 2) sector, both
    sharded, from the same start block: the pole moments of the
    single-process port and of the JAX package's distributed estimator,
    and the sum rule."""
    model, _ = build(hubbard_text(4, 2, 2, periodic=0))
    src, dst = model.create_basis((2, 2)), model.create_basis((3, 2))
    ham_s = model.hamiltonian(src, dtype=torch.float64, device="cpu")
    ham_d = model.hamiltonian(dst, dtype=torch.float64, device="cpu")
    bmat = torch.from_numpy(operator_matrix(model, "cdagger", 0, 0, 0, src,
                                            dst))
    V0 = inputs(ham_s.dim, 11, 6).T
    V0 = V0 / torch.linalg.vector_norm(V0, dim=0)
    ref = ftlm_dynamic(ham_s, ham_d, lambda v: v @ bmat, steps=20,
                       start_vectors=V0)
    jinp = jax_parse(hubbard_text(4, 2, 2, periodic=0))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    jsrc, jdst = jmodel.create_basis((2, 2)), jmodel.create_basis((3, 2))
    jbm = bmat.numpy().T
    jres = jmesh.distributed_ftlm_dynamic(
        jmodel.hamiltonian(jsrc, dtype=np.float64),
        jmodel.hamiltonian(jdst, dtype=np.float64), lambda v: jbm @ v,
        jmesh.make_mesh(jax.devices()[:size]), steps=20,
        start_vectors=V0.numpy())
    for poles, beta in zip(worlds[size][0]["dynamic"], (0.5, 2.0)):
        got = _moments(poles)
        _close(got, _moments(ref.poles(beta)), 1e-8, 1e-10)
        _close(got, _moments(jres.poles(beta)), 1e-8, 1e-10)


@pytest.mark.parametrize("size", SIZES)
def test_ftlm_dynamic_factored(worlds, size):
    """The factored Heisenberg chain's sharded double-Krylov estimator
    (block order inside, flat-order callbacks) against the single-process
    flat estimator from the same block, and its sum rule."""
    _, _, hfact, flat = port_case("heisenberg8")
    diag = torch.linspace(-1.0, 1.0, hfact.dim, dtype=torch.float64)
    V0 = inputs(hfact.dim, 3, 4).T
    V0 = V0 / torch.linalg.vector_norm(V0, dim=0)
    ref = ftlm_dynamic(flat, flat, lambda v: diag * v, steps=16,
                       start_vectors=V0)
    for poles, beta in zip(worlds[size][0]["dynamic heisenberg8"], (0.5, 3.0)):
        _close(_moments(poles), _moments(ref.poles(beta)), 1e-7, 1e-9)
        # the sum rule of <B^2>: the zeroth moment against its direct mean
        assert abs(_moments(poles)[0] - _moments(ref.poles(beta))[0]) \
            <= 1e-10


@pytest.mark.parametrize("size", SIZES)
def test_ftlm_on_a_factored_form(worlds, size):
    energy, idx = worlds[size][0]["ftlm tj8"]
    _, _, fact, _ = port_case("tj8")
    res = tftlm.ftlm(fact, BETAS, num_vectors=8, steps=30, seed=7,
                     operators={"idx": np.arange(fact.dim, dtype=float)})
    _close(energy, res.energy, 1e-8, 1e-8)
    _close(idx, res.observables["idx"], 1e-8, 1e-8)


@pytest.mark.parametrize("size", SIZES)
def test_grand_canonical_sweep_on_a_mesh(worlds, size):
    got = worlds[size][0]["grand canonical"]
    model, _ = build(hubbard_text(4, 2, 2, periodic=0))
    gf = GrandCanonicalFTLM(model, nsite=4, beta_grid=[0.5, 2.0],
                            dense_cutoff=8, num_vectors=8, steps=24,
                            device="cpu")
    want = np.asarray([
        [getattr(gf, q)(b, mu) for q in ("energy", "density",
                                         "log_partition", "specific_heat")]
        for b in (0.5, 2.0) for mu in (0.0, 0.8)])
    _close(got, want, 1e-8, 1e-10)


@pytest.mark.parametrize("size", SIZES)
def test_scatter_plans(worlds, size):
    """c_up at site 0 and a random map, against ``apply_operator_map``
    and the JAX package's plan on `size` virtual devices."""
    model, basis, _ = port_case("hubbard8")
    dst = model.create_basis((3, 4))
    tgt, amp, dst_dim = model.operator_map(LabeledOperator("c"), 0, 0, 0,
                                           basis, dst)
    x = inputs(basis.size, 8)
    got = worlds[size][0]["scatter c"]
    want = apply_operator_map(tgt, amp, dst_dim, x).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    jm = jmesh.make_mesh(jax.devices()[:size])
    jz = np.asarray(jscatter.distributed_apply_operator_map(
        tgt, amp, dst_dim, x.numpy(), jm))
    assert np.abs(got - jz).max() <= 1e-12 * np.abs(jz).max()
    rng = np.random.default_rng(0)
    rtgt, ramp = rng.integers(-1, 777, 1001), rng.standard_normal(1001)
    rx = rng.standard_normal(1001)
    want = np.zeros(777)
    np.add.at(want, rtgt[rtgt >= 0], 0.5 * ramp[rtgt >= 0] * rx[rtgt >= 0])
    got = worlds[size][0]["scatter random"]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
