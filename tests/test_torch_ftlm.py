"""The port's FTLM and LTLM (engine/ftlm.py) held against the JAX
package's on the CPU: the same start block (drawn by ``jax.random`` and
passed in), the same sector, float64 and complex128.  Tolerances: thermal
averages, ln Z and the LTLM estimates to 1e-10 (relative to their scale);
the first 10 recurrence coefficients to 1e-9 (a plain recurrence grows
the rounding of its applies a step, so later coefficients are held only
through the averages they give); exact estimators (a complete orthonormal
start set, steps = dim) to 2e-7 of the full spectrum's averages, the JAX
package's own tolerance; the ``ftlm_hub10_*`` goldens of
benchmarks/goldens.json to 1e-10."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lanczosplusplus_tpu.engine import ftlm as jftlm
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models import (
    factored_hamiltonian_or_none as jax_factored)
from lanczosplusplus_tpu.solver.lanczos import (
    random_start_block as jax_start_block)
from lanczosplusplus_tpu_torch.core.bits import popcount
from lanczosplusplus_tpu_torch.engine import ftlm as tftlm
from lanczosplusplus_tpu_torch.engine.thermal import full_spectrum
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from test_torch_host import hubbard_chain_text
from test_torch_inputs import rashba_text, tj_text

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BETAS = np.asarray([0.1, 0.5, 1.0, 2.0, 5.0])
# benchmarks/onchip_correctness.py:125-146 (HUB10, FTLM_*)
HUB10 = hubbard_chain_text(10).replace("TargetElectronsUp=5",
                                       "TargetElectronsUp=2").replace(
    "TargetElectronsDown=5", "TargetElectronsDown=2")
NP_OF = {torch.float64: np.float64, torch.complex128: np.complex128}


def sector(text, parts=None, dtype=torch.float64):
    """(port Hamiltonian, JAX Hamiltonian, port model, port basis) of an
    input's default sector (or `parts`) on the CPU."""
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = parts or model.default_parts(inp)
    basis = model.create_basis(parts)
    ham = model.hamiltonian(basis, dtype=dtype)
    jham = jmodel.hamiltonian(jmodel.create_basis(parts),
                              dtype=NP_OF[dtype])
    return ham, jham, model, basis


def jax_block(dim, num, seed, dtype):
    return np.array(jax_start_block(dim, num, seed, NP_OF[dtype]))


def docc(basis):
    idx = np.arange(basis.size)
    return popcount(basis.words_up(idx) & basis.words_down(idx)) \
        .astype(np.float64)


def assert_results_equal(res, jres, tol=1e-10):
    for field in ("energy", "energy2", "specific_heat", "log_z"):
        got, want = getattr(res, field), getattr(jres, field)
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= tol * scale, field
    assert res.observables.keys() == jres.observables.keys()
    for name in res.observables:
        want = jres.observables[name]
        assert np.abs(res.observables[name] - want).max() <= \
            tol * max(np.abs(want).max(), 1.0), name
    assert abs(res.e0_estimate - jres.e0_estimate) <= \
        tol * abs(jres.e0_estimate)
    assert (res.num_vectors, res.steps) == (jres.num_vectors, jres.steps)


def test_ftlm_hub10_goldens():
    """The ftlm_hub10_* goldens (HUB10, beta 0.5 and 2.0, R 24, M 40, seed
    424243) from the JAX-drawn block, to 1e-10."""
    with open(os.path.join(REPO, "benchmarks", "goldens.json")) as f:
        goldens = json.load(f)
    ham, _, _, basis = sector(HUB10)
    res = tftlm.ftlm(ham, [0.5, 2.0], steps=40,
                     start_vectors=jax_block(basis.size, 24, 424243,
                                             torch.float64))
    np.testing.assert_allclose(res.energy, goldens["ftlm_hub10_energy"],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.log_z, goldens["ftlm_hub10_log_z"],
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ftlm_matches_jax(dtype):
    """Energy, its square, specific heat, ln Z and a diagonal observable
    (double occupancy) from one block through both packages."""
    text = hubbard_chain_text(6, periodic=False)
    if dtype.is_complex:
        text = rashba_text(5, 4, periodic=1)
    ham, jham, model, basis = sector(text, dtype=dtype)
    V = jax_block(basis.size, 7, 11, dtype)
    ops = {} if dtype.is_complex else {"docc": docc(basis)}
    res = tftlm.ftlm(ham, BETAS, steps=30, operators=ops, start_vectors=V)
    jres = jftlm.ftlm(jham, BETAS, steps=30, operators=ops, start_vectors=V)
    assert_results_equal(res, jres)
    np.testing.assert_allclose(res.free_energy, jres.free_energy,
                               rtol=1e-10)
    np.testing.assert_allclose(res.entropy, jres.entropy, rtol=1e-9,
                               atol=1e-10)


def test_ftlm_hamiltonian_operator_matches_jax():
    """An operator given as an object (the Hamiltonian itself) goes
    through its batched apply; <H> from it equals the energy."""
    ham, jham, _, basis = sector(hubbard_chain_text(6))
    V = jax_block(basis.size, 4, 5, torch.float64)
    res = tftlm.ftlm(ham, BETAS, steps=25, operators={"h": ham},
                     start_vectors=V)
    jres = jftlm.ftlm(jham, BETAS, steps=25, operators={"h": jham},
                      start_vectors=V)
    assert_results_equal(res, jres)
    np.testing.assert_allclose(res.observables["h"], res.energy, rtol=1e-9)


def test_ftlm_recurrence_matches_jax():
    """The batched recurrence's first 10 coefficients and Krylov dots to
    1e-9 against the JAX scan on the same block."""
    ham, jham, _, basis = sector(hubbard_chain_text(6))
    V = jax_block(basis.size, 3, 2, torch.float64)
    Y = docc(basis)[None, None, :] * V.T[None]
    a, b, d = tftlm._ftlm_recurrence(ham, torch.as_tensor(V.T).contiguous(),
                                     torch.as_tensor(Y), 10)
    ja, jb, jd = jftlm._ftlm_recurrence(jham, jnp.asarray(V.T),
                                        jnp.asarray(Y), 10)
    for got, want in ((a, ja), (b, jb), (d, jd)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-9 * np.abs(want).max()


def test_ftlm_complete_basis_is_exact():
    """A complete orthonormal start set and steps = dim make the estimator
    exact: energy, double occupancy and ln Z of the full spectrum."""
    ham, _, model, basis = sector(hubbard_chain_text(4, periodic=False))
    spec = full_spectrum(model, basis, device="cpu")
    dim = basis.size
    d = docc(basis)
    res = tftlm.ftlm(ham, [0.3, 1.0, 4.0], steps=dim,
                     operators={"docc": d}, start_vectors=np.eye(dim))
    for t, beta in enumerate([0.3, 1.0, 4.0]):
        w = np.exp(-beta * (spec.evals - spec.evals.min()))
        per_state = (np.abs(spec.evecs) ** 2 * d[:, None]).sum(0)
        assert abs(res.energy[t] - (spec.evals * w).sum() / w.sum()) <= 2e-7
        assert abs(res.observables["docc"][t]
                   - (per_state * w).sum() / w.sum()) <= 2e-7
        assert abs(res.log_z[t] - np.log(np.exp(-beta * spec.evals).sum())) \
            <= 1e-7


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ltlm_matches_jax(dtype):
    """LTLM of H and a diagonal observable from one block, stored-V
    selective runs in both packages."""
    text = hubbard_chain_text(6, periodic=False)
    if dtype.is_complex:
        text = rashba_text(5, 4, periodic=1)
    ham, jham, _, basis = sector(text, dtype=dtype)
    V = jax_block(basis.size, 3, 7, dtype)
    ops = {"energy": ham}
    jops = {"energy": jham}
    if not dtype.is_complex:
        ops["docc"] = jops["docc"] = docc(basis)
    out = tftlm.ltlm(ham, BETAS, ops, steps=30, start_vectors=V)
    jout = jftlm.ltlm(jham, BETAS, jops, steps=30, start_vectors=V)
    for key in [*jops, "_log_z"]:
        want = np.asarray(jout[key])
        assert np.abs(out[key] - want).max() <= \
            1e-10 * max(np.abs(want).max(), 1.0), key
    assert out["_e0"] <= out["energy"][-1] + 1e-12
    assert out["_ritz_residual"] >= 0.0


def test_ltlm_complete_basis_is_exact():
    ham, _, model, basis = sector(hubbard_chain_text(4, periodic=False))
    spec = full_spectrum(model, basis, device="cpu")
    dim = basis.size
    out = tftlm.ltlm(ham, [0.5, 3.0], {"energy": ham}, steps=dim,
                     start_vectors=np.eye(dim))
    for t, beta in enumerate([0.5, 3.0]):
        w = np.exp(-beta * (spec.evals - spec.evals.min()))
        assert abs(out["energy"][t] - (spec.evals * w).sum() / w.sum()) \
            <= 2e-7


@pytest.mark.parametrize("case", ["tj", "rashba_complex"])
def test_ftlm_permuted_inner_branch(case):
    """A factored sector (PermutedHamiltonian; the complex Rashba half-cut
    carries a sign) runs in its inner block order, with the flat-order
    start block and diagonal operator converted: equal to the same FTLM on
    the flat form and to the JAX package's on its own factored form."""
    if case == "tj":
        text, dtype = tj_text(6, 2, 2, j=0.4, w=0.3, periodic=1), \
            torch.float64
    else:
        text = rashba_text(5, 4, r="(0.3,0.4)", u=4.0, periodic=1,
                           options="useComplex")
        dtype = torch.complex128
    ham, jham, model, basis = sector(text, dtype=dtype)
    parts = basis.parts
    form = factored_hamiltonian_or_none(model, basis, parts, dtype)
    assert type(form).__name__ == "PermutedHamiltonian"
    assert (form.sign is not None) == (case == "rashba_complex")
    jinp = jax_parse(text)
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    jform = jax_factored(jmodel, jmodel.create_basis(parts), parts,
                         NP_OF[dtype])
    V = jax_block(basis.size, 5, 3, dtype)
    diag = np.linspace(0.0, 1.0, basis.size)
    res = tftlm.ftlm(form, BETAS, steps=20, operators={"d": diag},
                     start_vectors=V)
    flat = tftlm.ftlm(ham, BETAS, steps=20, operators={"d": diag},
                      start_vectors=V)
    jres = jftlm.ftlm(jform, BETAS, steps=20, operators={"d": diag},
                      start_vectors=V)
    assert_results_equal(res, flat, tol=1e-9)
    assert_results_equal(res, jres)


def test_schedule_grid_matches_jax():
    text = hubbard_chain_text(4) + ("TemperatureOrBeta=temperature\n"
                                    "TemperatureOrBetaStart=0\n"
                                    "TemperatureOrBetaTotal=4\n"
                                    "TemperatureOrBetaStep=0.5\n")
    tbs, grid = tftlm._schedule_grid(parse_input(text))
    jtbs, jgrid = jftlm._schedule_grid(jax_parse(text))
    assert tbs == jtbs
    np.testing.assert_array_equal(grid, jgrid)
    with pytest.raises(ValueError, match="beta or temperature"):
        tftlm._schedule_grid(parse_input(text.replace(
            "=temperature", "=kelvin")))


@pytest.mark.parametrize("which", ["ftlm", "ltlm"])
def test_schedules_match_jax(monkeypatch, which):
    """ftlm_schedule and ltlm_schedule on the CPU, the port's random block
    replaced by the JAX package's draw (same dim, R and seed)."""
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    text = hubbard_chain_text(6) + ("TemperatureOrBeta=beta\n"
                                    "TemperatureOrBetaStart=0.5\n"
                                    "TemperatureOrBetaTotal=3\n"
                                    "TemperatureOrBetaStep=1.5\n")
    monkeypatch.setattr(lz, "random_start_block",
                        lambda dim, num, seed, dtype, device: torch.as_tensor(
                            jax_block(dim, num, seed, dtype)))
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    run = getattr(tftlm, f"{which}_schedule")
    jrun = getattr(jftlm, f"{which}_schedule")
    sched, _ = run(model, inp, num_vectors=3, steps=20, device="cpu")
    jsched, _ = jrun(jmodel, jinp, num_vectors=3, steps=20)
    assert [tb for tb, _ in sched] == [tb for tb, _ in jsched]
    np.testing.assert_allclose([e for _, e in sched],
                               [e for _, e in jsched], rtol=1e-10)


def test_ftlm_blocks_that_do_not_fit_raise(monkeypatch):
    """R vectors whose blocks (the block, the previous one, its image,
    two temporaries and one image an operator) pass the Krylov budget
    raise MemoryError before any block is made."""
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    ham, _, _, basis = sector(hubbard_chain_text(6))
    need = 6 * 4 * basis.size * 8
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: need - 1)
    with pytest.raises(MemoryError, match="the blocks of 4 vectors"):
        tftlm.ftlm(ham, BETAS, num_vectors=4, steps=5,
                   operators={"d": np.ones(basis.size)})
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: need)
    res = tftlm.ftlm(ham, BETAS, num_vectors=4, steps=5,
                     operators={"d": np.ones(basis.size)})
    np.testing.assert_allclose(res.observables["d"], 1.0, rtol=1e-12)


def test_ltlm_basis_that_does_not_fit_raises(monkeypatch):
    """An LTLM run whose stored basis, start block, image chunk and four
    work vectors pass the Krylov budget raises MemoryError before the
    start block or a basis is made; at the budget it runs."""
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    ham, _, _, basis = sector(hubbard_chain_text(6))
    steps, rows = 20, 3
    need = (steps + rows + min(tftlm.LTLM_CHUNK_ROWS, steps) + 4) \
        * basis.size * 8
    assert tftlm.ltlm_bytes(basis.size, steps, rows, torch.float64) == need
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: need - 1)

    def no_block(*args, **kwargs):
        raise AssertionError("a block was made before the reckoning")
    with monkeypatch.context() as m:
        m.setattr(tftlm, "start_block", no_block)
        with pytest.raises(MemoryError, match="ltlm: the basis of 20 steps"):
            tftlm.ltlm(ham, BETAS, {"energy": ham}, num_vectors=rows,
                       steps=steps)
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: need)
    out = tftlm.ltlm(ham, BETAS, {"energy": ham}, num_vectors=rows,
                     steps=steps)
    assert np.isfinite(out["energy"]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ltlm_chunked_apply_matches_unchunked_and_jax(monkeypatch, dtype):
    """The operator image made a few rows at a time (chunks of 1 and 7
    rows, the last one ragged) gives the values of the image made whole
    to 1e-12, and the JAX package's to 1e-10."""
    text = hubbard_chain_text(6, periodic=False)
    if dtype.is_complex:
        text = rashba_text(5, 4, periodic=1)
    ham, jham, _, basis = sector(text, dtype=dtype)
    V = jax_block(basis.size, 3, 11, dtype)
    ops = {"energy": ham, "d": np.linspace(0.0, 1.0, basis.size)}
    jops = {"energy": jham, "d": ops["d"]}
    outs = []
    for chunk in (1000, 1, 7):
        monkeypatch.setattr(tftlm, "LTLM_CHUNK_ROWS", chunk)
        outs.append(tftlm.ltlm(ham, BETAS, ops, steps=30, start_vectors=V))
    jout = jftlm.ltlm(jham, BETAS, jops, steps=30, start_vectors=V)
    for key in ("energy", "d", "_log_z"):
        scale = max(np.abs(outs[0][key]).max(), 1.0)
        for out in outs[1:]:
            assert np.abs(out[key] - outs[0][key]).max() <= 1e-12 * scale
        assert np.abs(outs[0][key] - np.asarray(jout[key])).max() <= \
            1e-10 * scale, key
    assert outs[1]["_e0"] == outs[0]["_e0"]
