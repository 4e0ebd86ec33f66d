"""The port's dynamics modules held against the JAX package's on the CPU:
Chebyshev real-time evolution (engine/chebyshev_time.py), dynamics1 and
the quasiparticle weight (engine/dynamics.py), broadening
(engine/broadening.py) and the post-processing (postproc.py).
Tolerances: evolved states to 1e-10 against the JAX package with the same
bounds, and to 1e-9 against the dense propagator; continued fractions of
exhausted Krylov spaces (steps >= dim) through their evaluated functions
to 1e-8 of their maximum (the plain batched recurrence); Z(k) to 1e-10;
host-only code (broadening, file assembly) to 1e-12."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu import postproc as jpostproc
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import broadening as jbroadening
from lanczosplusplus_tpu.engine import chebyshev_time as jcheb
from lanczosplusplus_tpu.engine import dynamics as jdynamics
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config, postproc
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine import broadening, chebyshev_time
from lanczosplusplus_tpu_torch.engine import dynamics
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFraction, ContinuedFractionCollection)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_torch_ftlm import jax_block, sector
from test_torch_ftlm_dynamic import HUB4
from test_torch_inputs import feas_text, heisenberg_text

torch.set_num_threads(2)

FEAS2 = feas_text(2, 2, "INT_PAPER33", [1.0, 0.5, -0.2, -0.1], 2, 2)


def engines(text):
    inp, jinp = parse_input(text), jax_parse(text)
    return (Engine(build_model(inp, Geometry(inp)), inp,
                   config=Config.from_input(inp, device="cpu")),
            JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp))


def rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_evolve_matches_jax_and_dense(dtype):
    ham, jham, _, basis = sector(HUB4, dtype=dtype)
    dense = ham.to_dense()
    evals, evecs = np.linalg.eigh(dense)
    psi0 = jax_block(basis.size, 1, 3, dtype)[:, 0]
    times = np.asarray([0.0, 0.5, 2.0, 7.0])
    bounds = (evals[0] - 0.5, evals[-1] + 0.5)
    got = chebyshev_time.evolve(ham, psi0, times, bounds=bounds)
    want = jcheb.evolve(jham, psi0, times, bounds=bounds)
    assert rel(got, want) <= 1e-10
    c = evecs.conj().T @ psi0
    for i, t in enumerate(times):
        exact = evecs @ (np.exp(-1j * evals * t) * c)
        np.testing.assert_allclose(got[i], exact, atol=1e-9)
    auto = chebyshev_time.autocorrelation(ham, psi0, times, bounds=bounds)
    np.testing.assert_allclose(
        auto, jcheb.autocorrelation(jham, psi0, times, bounds=bounds),
        atol=1e-10)


def test_dynamics1_matches_jax():
    """The k-resolved c^dag_a c_b continued fraction of the two-orbital
    FeAs sector (dim 36, the run exhausts it), k = 0 and 1."""
    engine, jengine = engines(FEAS2)
    omegas = np.linspace(-2, 8, 200)
    for m in (0, 1):
        cf = dynamics.dynamics1_spectral(engine, m)
        jcf = jdynamics.dynamics1_spectral(jengine, m)
        assert cf.meta == jcf.meta == f"k={m}"
        assert abs(cf.weight - jcf.weight) <= 1e-10 * max(jcf.weight, 1)
        assert rel(cf.evaluate(omegas, 0.1), jcf.evaluate(omegas, 0.1)) \
            <= 1e-8


@pytest.mark.parametrize("ratio", [False, True])
def test_quasiparticle_weight_matches_jax(ratio):
    """Z(k) on the open 4-site chain with site potentials (its N-1
    ground state is not degenerate, so it is one vector in both
    packages)."""
    engine, jengine = engines(HUB4)
    got = dynamics.quasiparticle_weight_z(engine, ratio=ratio)
    want = jdynamics.quasiparticle_weight_z(jengine, ratio=ratio)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([z for _, z in got], [z for _, z in want],
                               rtol=1e-10, atol=1e-12)


def test_sq_omega_and_ni_omega_match_jax():
    """S(q, omega) of the 6-site Heisenberg ring and N(i, omega) of the
    4-site chain through the batched fleets, against the JAX package's."""
    omegas = np.linspace(-0.5, 6, 131)
    engine, jengine = engines(heisenberg_text(6, 1, 3))
    qs, sqw = postproc.sq_omega(engine, "sz", omegas, 0.08)
    jqs, jsqw = jpostproc.sq_omega(jengine, "sz", omegas, 0.08)
    np.testing.assert_allclose(qs, jqs)
    assert rel(sqw, jsqw) <= 1e-8
    engine, jengine = engines(HUB4)
    dos = postproc.ni_omega(engine, omegas, 0.15)
    assert rel(dos, jpostproc.ni_omega(jengine, omegas, 0.15)) <= 1e-8


def _cf(weight, meta=""):
    return ContinuedFraction(alphas=np.array([0.5, 1.0]),
                             betas=np.array([0.0, 0.3]), e0=-1.0,
                             weight=weight, sigma=1, meta=meta)


def test_comb_file_assembly_matches_jax(tmp_path):
    """assemble_from_comb_files, dynamics_ft and extract_orbitals on .comb
    files written by the port, read by both packages."""
    paths = []
    for i in range(4):
        path = tmp_path / f"root{i}.comb"
        cfs = [_cf(1.0 + 0.5 * i, "0,0,0,0"), _cf(0.3, "0,0,0,1")]
        with open(path, "w") as f:
            f.write("TSPCenter=1\n")
            ContinuedFractionCollection(cfs).write(
                f, index_to_cf=[c.meta for c in cfs])
        paths.append(str(path))
    omegas = np.linspace(-3, 3, 11)
    for got, want in (
            (postproc.assemble_from_comb_files(paths, omegas, 0.1, 1, 4),
             jpostproc.assemble_from_comb_files(paths, omegas, 0.1, 1, 4)),
            (postproc.dynamics_ft(paths, 4, omegas, 0.1),
             jpostproc.dynamics_ft(paths, 4, omegas, 0.1))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-12)
    sel = postproc.extract_orbitals(paths[2], 1, 0)
    jsel = jpostproc.extract_orbitals(paths[2], 1, 0)
    assert [c.weight for c in sel.items] == [c.weight for c in jsel.items]
    with pytest.raises(ValueError, match="no CF with orbital pair"):
        postproc.extract_orbitals(paths[0], 1, 1)


@pytest.mark.parametrize("mode,kwargs", [
    ("real", dict(eps=0.05)), ("real", dict(eps=0.1, start=-2, step=0.1)),
    ("matsubara", dict(eps=0.0, beta=5.0))])
def test_lorentzian_grid_matches_jax(mode, kwargs):
    e = np.array([2.0, -1.0, 0.5, 3.0])
    w = np.array([0.25, 0.5, 1.0, 1e-9])
    om, g = broadening.lorentzian_grid(e, w, 40, mode=mode, **kwargs)
    jom, jg = jbroadening.lorentzian_grid(e, w, 40, mode=mode, **kwargs)
    np.testing.assert_allclose(om, jom, atol=1e-12)
    np.testing.assert_allclose(g, jg, atol=1e-12)
    with pytest.raises(ValueError):
        broadening.lorentzian_grid(e, w, 4, mode="matsubara", beta=0.0)
