"""The port's spans and counters (``utils/progress``) on the CPU: nothing
recorded with recording off, nesting and self time, the annotations a
profiler sees, the solver's host reads, steps and Gram-Schmidt passes on a
Heisenberg ring, the rows applied at the solver-to-apply boundary (flat
and factored forms, ``lowest_states`` and ``ftlm``), and the names the
port gives its spans."""

import io
import time

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.core import blockkron, sparse
from lanczosplusplus_tpu_torch.engine import ftlm as F
from lanczosplusplus_tpu_torch.engine.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.utils import progress
from test_torch_inputs import heisenberg_text

torch.set_num_threads(2)

# the harness's own span names (portbench/tracing.HARNESS_SPANS)
HARNESS_SPANS = ("window", "unit", "apply")


@pytest.fixture(autouse=True)
def clean():
    progress.reset()
    yield
    progress.reset()


def ring(nsite):
    """(input, model, parts, basis) of the S = 1/2 Heisenberg ring at
    Sz = 0."""
    inp = parse_input(heisenberg_text(nsite, 1, nsite // 2))
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    return inp, model, parts, model.create_basis(parts)


def start(dim, seed=3):
    v0 = np.random.default_rng(seed).standard_normal(dim)
    return v0 / np.linalg.norm(v0)


def test_nothing_recorded_when_off():
    assert progress.span("a") is progress.span("b")
    with progress.span("a"):
        progress.count("c", 2)
    assert progress.totals() == {}
    # counters are always on
    assert progress.COUNTS == {"c": 2}
    with progress.recording():
        with progress.recording():
            pass
        with progress.span("a"):
            pass
    with progress.span("a"):
        pass
    assert progress.totals()["a"]["count"] == 1
    progress.reset()
    assert progress.totals() == {} and progress.COUNTS == {}


def test_nesting_and_self_time():
    with progress.recording():
        with progress.span("outer"):
            time.sleep(0.02)
            for _ in range(3):
                with progress.span("inner"):
                    time.sleep(0.01)
                    with progress.span("leaf"):
                        time.sleep(0.005)
        for _ in range(100):
            with progress.span("many"):
                pass
    t = progress.totals()
    assert set(t) == {"outer", "inner", "leaf", "many"}
    assert [t[k]["count"] for k in ("outer", "inner", "leaf", "many")] == [
        1, 3, 3, 100]
    assert t["leaf"]["seconds"] >= 0.015
    assert t["leaf"]["self_s"] == t["leaf"]["seconds"]
    assert t["inner"]["seconds"] >= 0.045
    assert t["inner"]["self_s"] == pytest.approx(
        t["inner"]["seconds"] - t["leaf"]["seconds"], abs=1e-9)
    assert t["outer"]["seconds"] >= 0.065
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], abs=1e-9)
    assert t["outer"]["self_s"] >= 0.02


def test_a_span_closes_when_its_block_raises():
    with progress.recording():
        with pytest.raises(ValueError):
            with progress.span("outer"):
                with progress.span("inner"):
                    raise ValueError
        with progress.span("after"):
            pass
    t = progress.totals()
    assert t["outer"]["count"] == t["inner"]["count"] == 1
    assert t["after"]["self_s"] == t["after"]["seconds"]
    assert progress._OPEN == []


def test_a_profiler_sees_the_spans():
    """Under a profiler a span records without ``recording()`` and is a
    user annotation of its name in the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with progress.span("lanczos.step"):
            torch.ones(4).add_(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names.count("lanczos.step") == 1
    assert progress.totals()["lanczos.step"]["count"] == 1
    assert progress.span("x") is progress.span("y")


def test_phase_is_a_span_and_logs_as_before():
    out = io.StringIO()
    log = progress.ProgressIndicator("Engine", stream=out)
    with progress.recording(), log.phase("diagonalization dim=4"):
        pass
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Engine [") and lines[0].endswith(
        "]: diagonalization dim=4 starting")
    assert " done in " in lines[1] and lines[1].endswith("s")
    assert progress.totals()["diagonalization dim=4"]["count"] == 1


@pytest.mark.parametrize("nsite", [10, 12])
@pytest.mark.parametrize("reorth", ["selective", "full"])
def test_host_reads_steps_and_passes(monkeypatch, nsite, reorth):
    """Reads a step: alpha and two norms under selective
    reorthogonalization, alpha and beta under full, and 2 more a
    Gram-Schmidt call (DGKS's norms); steps summed over the passes."""
    _, model, _, basis = ring(nsite)
    ham = model.hamiltonian(basis, device="cpu")
    calls = {"reorth": 0, "passes": 0, "steps": 0}
    real_reorth, real_pass, real_tri = lz._reorth, lz._reorth_pass, \
        lz.tridiagonalize

    def reorth_call(*args):
        calls["reorth"] += 1
        return real_reorth(*args)

    def pass_call(*args):
        calls["passes"] += 1
        return real_pass(*args)

    def tridiagonalize(ham, v0, steps, **kwargs):
        calls["steps"] += steps
        return real_tri(ham, v0, steps, **kwargs)
    monkeypatch.setattr(lz, "_reorth", reorth_call)
    monkeypatch.setattr(lz, "_reorth_pass", pass_call)
    monkeypatch.setattr(lz, "tridiagonalize", tridiagonalize)
    with progress.recording():
        evals, _, info = lz.lowest_states(ham, v0=start(ham.dim),
                                          reorth=reorth, return_info=True)
    counts, t = progress.COUNTS, progress.totals()
    assert info.converged and info.steps == 200
    assert calls["steps"] == counts["lanczos.steps"] == info.steps
    assert calls["reorth"] > 0
    per_step = 3 if reorth == "selective" else 2
    assert counts["lanczos.host_reads"] == (
        per_step * counts["lanczos.steps"] + 2 * calls["reorth"])
    assert counts["lanczos.reorth_passes"] == calls["passes"]
    assert calls["reorth"] <= calls["passes"] <= 2 * calls["reorth"]
    if reorth == "full":
        assert calls["reorth"] == info.steps
    assert t["lanczos.solve"]["count"] == 1
    assert t["lanczos.step"]["count"] == info.steps
    assert t["hamiltonian.apply"]["count"] == info.steps
    assert t.get("lanczos.omega", {"count": 0})["count"] == (
        info.steps if reorth == "selective" else 0)
    assert t["lanczos.solve"]["seconds"] >= t["lanczos.step"]["seconds"]
    assert counts["hamiltonian.rows"] == info.steps


def test_steps_sum_over_the_doubling_passes(monkeypatch):
    """A solve that doubles its steps counts every pass's steps; its
    ``SolveInfo.steps`` is the last pass's."""
    _, model, _, basis = ring(12)
    ham = model.hamiltonian(basis, device="cpu")
    passes = []
    real = lz.tridiagonalize

    def tridiagonalize(ham, v0, steps, **kwargs):
        passes.append(steps)
        return real(ham, v0, steps, **kwargs)
    monkeypatch.setattr(lz, "tridiagonalize", tridiagonalize)
    _, _, info = lz.lowest_states(ham, v0=start(ham.dim), max_steps=10,
                                  return_info=True)
    assert len(passes) > 1 and info.steps == passes[-1]
    assert progress.COUNTS["lanczos.steps"] == sum(passes)
    assert progress.COUNTS["hamiltonian.rows"] == sum(passes)


def _counting(monkeypatch, cls, seen):
    """Count the rows every apply of `cls` takes (its ``matvec`` goes
    through its ``matmat_t``)."""
    real = cls.matmat_t

    def matmat_t(self, xk):
        seen[0] += xk.shape[0] if xk.dim() == 2 else 1
        return real(self, xk)
    monkeypatch.setattr(cls, "matmat_t", matmat_t)


@pytest.mark.parametrize("form", ["flat", "factored"])
@pytest.mark.parametrize("unit", ["lowest_states", "ftlm"])
def test_rows_applied(monkeypatch, form, unit):
    """``hamiltonian.rows`` is the rows the operator applied, the factored
    ``PermutedHamiltonian`` solved and estimated in its inner order."""
    _, model, parts, basis = ring(10)
    if form == "flat":
        ham = model.hamiltonian(basis, device="cpu")
        applied = sparse.Hamiltonian
    else:
        ham = factored_hamiltonian_or_none(model, basis, parts,
                                           torch.float64)
        assert isinstance(ham, blockkron.PermutedHamiltonian)
        applied = type(ham.inner)
    seen = [0]
    _counting(monkeypatch, applied, seen)
    if unit == "lowest_states":
        lz.lowest_states(ham, v0=start(ham.dim), max_steps=60)
    else:
        block = torch.from_numpy(np.stack([start(ham.dim, s)
                                           for s in range(6)], axis=1))
        F.ftlm(ham, [0.5, 2.0], num_vectors=6, steps=30,
               start_vectors=block)
        assert seen[0] == 6 * 30
    assert seen[0] > 0
    assert progress.COUNTS["hamiltonian.rows"] == seen[0]


def test_the_port_s_span_names():
    """Every span the port opens on a solve, an estimate, the thermal
    build and the Engine, and none under the harness's names."""
    inp, model, _, basis = ring(10)
    ham = model.hamiltonian(basis, device="cpu")
    with progress.recording():
        lz.lowest_states(ham, v0=start(ham.dim), max_steps=40)
        lz.lowest_states_plain(ham, v0=start(ham.dim), max_steps=20)
        F.ftlm(ham, [1.0], num_vectors=4, steps=10, seed=5)
        F._schedule_ham(model, inp, "cpu")
        Engine(model, inp, Config.from_input(inp, device="cpu"),
               v0=start(basis.size))
    names = set(progress.totals())
    assert {"lanczos.solve", "lanczos.step", "lanczos.omega",
            "hamiltonian.apply", "ftlm.estimate", "ftlm.recurrence",
            "ftlm.read", "ftlm.host", "build", "build.basis",
            "build.tables"} <= names
    assert any(n.startswith("diagonalization dim=") for n in names)
    assert not names & set(HARNESS_SPANS)
    t = progress.totals()
    assert t["ftlm.estimate"]["seconds"] >= (
        t["ftlm.recurrence"]["seconds"] + t["ftlm.read"]["seconds"]
        + t["ftlm.host"]["seconds"])
    assert t["build"]["seconds"] >= t["build.tables"]["seconds"]
