"""The port's FTLM double-Krylov estimator (engine/ftlm_dynamic.py) and
Engine.ftlm_local_dos / ftlm_sq_omega held against the JAX package's on
the CPU from the same (JAX-drawn) start block, and against the exact
two-sector Lehmann double sum.  Tolerances: pole moments and broadened
curves to 1e-8 where the estimator is exact (a complete orthonormal start
set, steps = dim); evaluated functions to 1e-9 of their maximum against
the JAX package (stored-V selective runs in both)."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import ftlm_dynamic as jdyn
from lanczosplusplus_tpu.engine.thermal import (
    operator_matrix as jax_operator_matrix)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine import ftlm_dynamic as tdyn
from lanczosplusplus_tpu_torch.engine.thermal import operator_matrix
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_ftlm import jax_block
from test_torch_host import INPUT0, hubbard_chain_text
from test_torch_inputs import heisenberg_text, rashba_text

torch.set_num_threads(2)
HUB4 = INPUT0.replace("potentialV 8 0 0 0 0 0 0 0 0",
                      "potentialV 8 0.1 -0.2 0 0.3 0 0 0 0")


def two_sectors():
    """The 4-site chain's (2, 2) and (3, 2) sectors on the CPU in both
    packages, and B = c^dagger_{0, up} between them as a dense matrix."""
    inp, jinp = parse_input(HUB4), jax_parse(HUB4)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    src, dst = model.create_basis((2, 2)), model.create_basis((3, 2))
    hams = [model.hamiltonian(b) for b in (src, dst)]
    jhams = [jmodel.hamiltonian(jmodel.create_basis(p), dtype=np.float64)
             for p in ((2, 2), (3, 2))]
    bmat = operator_matrix(model, "cdagger", 0, 0, 0, src, dst).T
    return hams, jhams, bmat


def exact_poles(ham_s, ham_d, bmat, beta):
    es, vs = np.linalg.eigh(ham_s.to_dense())
    ed, vd = np.linalg.eigh(ham_d.to_dense())
    w = np.exp(-beta * (es - es.min()))
    m = vd.T @ bmat @ vs
    return (ed[:, None] - es[None, :]).ravel(), \
        (np.abs(m) ** 2 * w[None, :] / w.sum()).ravel()


def moments(om, wt):
    return np.asarray([(wt * om ** k).sum() for k in range(3)])


def test_operator_matrix_matches_jax():
    (hs, hd), _, bmat = two_sectors()
    jinp = jax_parse(HUB4)
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    want = jax_operator_matrix(jmodel, "cdagger", 0, 0, 0,
                               jmodel.create_basis((2, 2)),
                               jmodel.create_basis((3, 2)))
    np.testing.assert_array_equal(bmat.T, want)


def test_exact_with_complete_basis():
    """A complete orthonormal start set and full depth: the estimator is
    the exact finite-T Lehmann double sum."""
    (hs, hd), _, bmat = two_sectors()
    B = torch.as_tensor(bmat)
    dyn = tdyn.ftlm_dynamic(hs, hd, lambda X: X @ B.T, steps=hs.dim,
                            start_vectors=np.eye(hs.dim))
    grid = np.linspace(-8, 12, 400)
    for beta in (0.3, 1.0, 4.0):
        om_e, wt_e = exact_poles(hs, hd, bmat, beta)
        np.testing.assert_allclose(moments(*dyn.poles(beta)),
                                   moments(om_e, wt_e), rtol=1e-8, atol=1e-8)
        broad = (wt_e[None, :] * (0.2 / np.pi) /
                 ((grid[:, None] - om_e[None, :]) ** 2 + 0.04)).sum(1)
        np.testing.assert_allclose(dyn.evaluate(beta, grid, 0.2), broad,
                                   atol=1e-8)


def test_matches_jax_on_one_block():
    """Random JAX block, R = 5, 10 steps: poles and the evaluated function
    against the JAX package's."""
    (hs, hd), (jhs, jhd), bmat = two_sectors()
    V = jax_block(hs.dim, 5, 31, torch.float64)
    B = torch.as_tensor(bmat)
    dyn = tdyn.ftlm_dynamic(hs, hd, lambda X: X @ B.T, steps=10,
                            start_vectors=V)
    jd = jdyn.ftlm_dynamic(jhs, jhd, lambda v: bmat @ v, steps=10,
                           start_vectors=V)
    grid = np.linspace(-6, 10, 200)
    for beta in (0.5, 3.0):
        want = jd.evaluate(beta, grid, 0.15)
        assert np.abs(dyn.evaluate(beta, grid, 0.15) - want).max() <= \
            1e-9 * np.abs(want).max()
    assert abs(dyn.e0 - jd.e0) <= 1e-12 * abs(jd.e0)
    assert (dyn.dim, dyn.num_vectors) == (jd.dim, jd.num_vectors)


def test_annihilated_start_keeps_its_partition_weight():
    """A start vector that B annihilates still counts in Z: the run is
    kept with no poles (as in the JAX package)."""
    (hs, hd), (jhs, jhd), bmat = two_sectors()
    V = jax_block(hs.dim, 3, 5, torch.float64)
    V[:, 1] = 0.0
    zero = np.nonzero(np.abs(bmat).sum(axis=0) == 0)[0]
    V[zero, 1] = 1.0 / np.sqrt(len(zero))      # B V[:, 1] = 0
    B = torch.as_tensor(bmat)
    dyn = tdyn.ftlm_dynamic(hs, hd, lambda X: X @ B.T, steps=8,
                            start_vectors=V)
    jd = jdyn.ftlm_dynamic(jhs, jhd, lambda v: bmat @ v, steps=8,
                           start_vectors=V)
    assert dyn.runs[1].evals2.size == 0 == jd.runs[1].evals2.size
    om, wt = dyn.poles(1.0)
    jom, jwt = jd.poles(1.0)
    np.testing.assert_allclose(om, jom, atol=1e-10)
    np.testing.assert_allclose(wt, jwt, atol=1e-10)


def test_stored_runs_that_do_not_fit_raise(monkeypatch):
    """R stored source runs past the Krylov budget raise MemoryError
    before anything is allocated; they are never moved to the host."""
    (hs, hd), _, bmat = two_sectors()
    monkeypatch.setattr(lz, "default_krylov_budget",
                        lambda device: 8 * hs.dim * 10 * 3 - 1)
    V = np.eye(hs.dim)[:, :3]
    with pytest.raises(MemoryError, match="3 source runs of 10 steps"):
        tdyn.ftlm_source_runs(hs, V, 10)
    B = torch.as_tensor(bmat)
    runs = tdyn.ftlm_source_runs(hs, V[:, :2], 10)
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: 100)
    with pytest.raises(MemoryError, match="a destination run"):
        tdyn.ftlm_dynamic(hs, hd, lambda X: X @ B.T, steps=10,
                          start_vectors=V[:, :2], source_runs=runs)


def _engines(text):
    inp, jinp = parse_input(text), jax_parse(text)
    return (Engine(build_model(inp, Geometry(inp)), inp,
                   config=Config.from_input(inp, device="cpu")),
            JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp))


@pytest.mark.parametrize("op_name,text", [
    ("c", hubbard_chain_text(6, periodic=False)),
    ("splus", heisenberg_text(6, 1, 3))], ids=["c", "splus"])
def test_engine_ftlm_local_dos_matches_jax(op_name, text):
    """Both operator types from one shared source fleet, the
    non-fermionic removal branch with its negative sign, from the JAX
    block passed through the start_vectors hook."""
    engine, jengine = _engines(text)
    V = jax_block(engine.basis.size, 4, 152917, torch.float64)
    omegas = np.linspace(-8.0, 8.0, 161)
    got = engine.ftlm_local_dos(op_name, 1, 1.5, omegas, delta=0.2,
                                steps=25, start_vectors=V)
    want = jengine.ftlm_local_dos(op_name, 1, 1.5, omegas, delta=0.2,
                                  steps=25, start_vectors=V)
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_engine_ftlm_local_dos_exact():
    """A complete start basis: the exact finite-T N_0(omega) from the full
    spectra of the three sectors."""
    engine, _ = _engines(HUB4)
    dim = engine.basis.size
    beta, delta = 1.2, 0.15
    grid = np.linspace(-10, 12, 300)
    got = engine.ftlm_local_dos("c", 0, beta, grid, delta=delta, steps=dim,
                                start_vectors=np.eye(dim))
    model = engine.model
    es, vs = np.linalg.eigh(engine.hamiltonian.to_dense())
    w = np.exp(-beta * (es - es.min()))
    want = np.zeros_like(grid)
    for parts, op, sign in (((3, 2), "cdagger", 1.0), ((1, 2), "c", -1.0)):
        basis = model.create_basis(parts)
        ed, vd = np.linalg.eigh(model.hamiltonian(basis).to_dense())
        m = vd.T @ operator_matrix(model, op, 0, 0, 0, engine.basis,
                                   basis).T @ vs
        om = sign * (ed[:, None] - es[None, :]).ravel()
        wt = (np.abs(m) ** 2 * w[None, :] / w.sum()).ravel()
        want += (wt[None, :] * (delta / np.pi) /
                 ((grid[:, None] - om[None, :]) ** 2 + delta ** 2)).sum(1)
    np.testing.assert_allclose(got, want, atol=1e-8)


def test_engine_ftlm_sq_omega_matches_jax_and_exact():
    """Finite-T S(q, omega) of sz on the 6-site Heisenberg ring: from the
    JAX block against the JAX package, and exact from a complete basis
    (B_q = sum_j e^{iqj} sz_j, Lehmann double sum)."""
    engine, jengine = _engines(heisenberg_text(6, 1, 3))
    dim = engine.basis.size
    grid = np.linspace(-6, 6, 121)
    V = jax_block(dim, 3, 152917, torch.float64)
    qs, got = engine.ftlm_sq_omega("sz", 0.8, grid, delta=0.2, steps=12,
                                   start_vectors=V)
    jqs, want = jengine.ftlm_sq_omega("sz", 0.8, grid, delta=0.2, steps=12,
                                      start_vectors=V)
    np.testing.assert_allclose(qs, jqs)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()

    _, exact = engine.ftlm_sq_omega("sz", 0.8, grid, delta=0.2, steps=dim,
                                    start_vectors=np.eye(dim))
    es, vs = np.linalg.eigh(engine.hamiltonian.to_dense())
    w = np.exp(-0.8 * (es - es.min()))
    szs = [operator_matrix(engine.model, "sz", j, 0, 0, engine.basis,
                           engine.basis).T for j in range(6)]
    for iq in (0, 1, 3):
        bq = sum(np.exp(1j * qs[iq] * j) * szs[j] for j in range(6))
        m = vs.T @ bq @ vs
        om = (es[:, None] - es[None, :]).ravel()
        wt = (np.abs(m) ** 2 * w[None, :] / w.sum()).ravel()
        want_q = (wt[None, :] * (0.2 / np.pi) /
                  ((grid[:, None] - om[None, :]) ** 2 + 0.04)).sum(1)
        np.testing.assert_allclose(exact[iq], want_q, atol=1e-7)


def test_ftlm_sq_omega_complex_guard_raises_in_both():
    """A complex Hamiltonian breaks the cos/sin momentum split: both
    packages raise before any run."""
    text = rashba_text(4, 4, r="(0.3,0.4)", periodic=1,
                       options="useComplex")
    engine, jengine = _engines(text)
    for eng in (engine, jengine):
        with pytest.raises(ValueError, match="real Hamiltonians only"):
            eng.ftlm_sq_omega("n", 1.0, np.linspace(-1, 1, 5), steps=4)
    with pytest.raises(ValueError, match="sector-preserving"):
        engine.ftlm_sq_omega("c", 1.0, np.linspace(-1, 1, 5), steps=4)
