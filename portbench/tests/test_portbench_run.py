"""A run of the harness on the CPU at small sizes: the result line, the
check, the control and each fault a cell can have, the import check, and
the refusal without a card.  The card's own run is marked ``cuda``."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness, run as entry, tracing
from portbench.layout import ROOT, Cell
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 987654321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # one host thread, as run.py sets it: the windows here are seconds
    # long, and a pool of threads on a busy machine stretches a unit past
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tiny.tree(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(threads)


def run_small(root, workload, trace=False, seconds=0.3, seed=SEED):
    cell = Cell(workload, root=root, here=root / "portbench")
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("workload", ["hubbard6.gs", "heisenberg8.gs",
                                      "hubbard6.ftlm", "heisenberg8.ftlm",
                                      "hubbard6.ftlm8", "hubbard6g.gs",
                                      "heisenberg8.gsfull"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(root, monkeypatch, workload, trace):
    # trace the window's first unit alone, so that it has an untraced part
    # for the step times (a unit takes up to two seconds traced here)
    monkeypatch.setattr(tracing, "TRACE_SECONDS", 0.01)
    out = run_small(root, workload, trace, seconds=5.0 if trace else 0.3)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    cell = Cell(workload, root=root, here=root / "portbench")
    section = "per_layer" if trace else "end_to_end"
    expected = {m["name"] for m in cell.metrics(section)}
    for name, metric in out["metrics"].items():
        assert name in expected and NAME.match(name)
        assert UNIT.match(metric["unit"])
        assert np.isfinite(metric["value"])
    # a CPU run reports no device reading: no memory, trace or roofline
    device_only = {"peak_device_gb", "apply_roofline.gs",
                   "apply_roofline.ftlm", "device_idle.gs",
                   "device_idle.ftlm"}
    assert set(out["metrics"]) == expected - device_only
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["device"]["platform"] == "cpu"
    for name, check in out["checks"].items():
        assert check["value"] <= check["limit"] == cell.limits[name]
    json.dumps(out)


def test_same_seed_same_answers(root):
    a = run_small(root, "heisenberg8.ftlm", seconds=0.0)
    b = run_small(root, "heisenberg8.ftlm", seconds=0.0)
    assert a["checks"] == b["checks"]


# -- faults: the timed path broken underneath, each must come out false --

def returns_state_unchanged(monkeypatch):
    from lanczosplusplus_tpu_torch.core import sparse
    monkeypatch.setattr(sparse.Hamiltonian, "matmat_t",
                        lambda self, xk: xk.clone())


def half_the_batch(monkeypatch):
    from lanczosplusplus_tpu_torch.engine import ftlm as F
    real = F.ftlm

    def half(ham, betas, num_vectors, steps, start_vectors):
        keep = num_vectors // 2
        return real(ham, betas, num_vectors=keep, steps=steps,
                    start_vectors=start_vectors[:, :keep])
    monkeypatch.setattr(F, "ftlm", half)


def altered_energy(monkeypatch):
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    real = lz.lowest_states

    def altered(*args, **kwargs):
        evals, vecs, info = real(*args, **kwargs)
        return evals * (1 + 1e-7), vecs, info
    monkeypatch.setattr(lz, "lowest_states", altered)


def altered_vector(monkeypatch):
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    real = lz.lowest_states

    def altered(*args, **kwargs):
        evals, vecs, info = real(*args, **kwargs)
        vecs = vecs.clone()
        vecs[0, 0] += 1e-6
        return evals, vecs, info
    monkeypatch.setattr(lz, "lowest_states", altered)


def altered_estimate(monkeypatch):
    from lanczosplusplus_tpu_torch.engine import ftlm as F
    real = F.ftlm

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        res.energy[3] *= 1 + 1e-7
        return res
    monkeypatch.setattr(F, "ftlm", altered)


@pytest.mark.parametrize("workload,fault", [
    ("hubbard6.gs", returns_state_unchanged),
    ("heisenberg8.gs", returns_state_unchanged),
    ("hubbard6.gs", altered_energy),
    ("heisenberg8.gs", altered_vector),
    ("hubbard6.ftlm", returns_state_unchanged),
    ("heisenberg8.ftlm", half_the_batch),
    ("hubbard6.ftlm", half_the_batch),
    ("heisenberg8.ftlm", altered_estimate)])
def test_fault_is_not_correct(root, monkeypatch, workload, fault):
    from portbench.layout import module
    fault(monkeypatch)
    # the harness draws the warm-up's inputs too: let it run unbroken
    here = root / "portbench"
    solves = module("units", "lowest_states", here).Unit
    monkeypatch.setattr(solves, "warm_up", solves._make_slots)
    monkeypatch.setattr(module("units", "ftlm", here).Unit, "warm_up",
                        lambda self: None)
    out = run_small(root, workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_unconverged_solve_is_not_correct(root, monkeypatch):
    """A solve that reports itself unconverged fails, whatever its gap."""
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    real = lz.lowest_states

    def unconverged(*args, **kwargs):
        evals, vecs, info = real(*args, **kwargs)
        info.converged = False
        return evals, vecs, info
    monkeypatch.setattr(lz, "lowest_states", unconverged)
    out = run_small(root, "heisenberg8.gs")
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", ["hubbard6.gs", "heisenberg8.gs",
                                      "hubbard6.ftlm", "heisenberg8.ftlm"])
def test_float32_control_is_not_correct(root, workload):
    """The port's float32 path in the program's place (``control.py``
    reads it on the card at the cells' own size)."""
    from lanczosplusplus_tpu_torch.ops import refine
    from portbench import reference as ref, sector
    from portbench.control import readings

    cell = Cell(workload, root=root, here=root / "portbench")
    ham, _ = cell.build(torch.device("cpu"))
    reference = ref.sector(cell.config["reference"],
                           sector.input_text(cell.config), "cpu")
    program = readings(cell, ham, reference, [SEED], 2, log=lambda s: None)
    control = readings(cell, refine.narrowed(ham), reference, [SEED + 1], 2,
                       refine=ham, log=lambda s: None)
    limits = cell.limits
    assert all(program[k][0] <= limits[k] for k in limits)
    assert any(control[k][0] > limits[k] for k in limits)


# -- the process: imports, the card, the result line ----------------------

def test_no_jax_and_a_reference_apart_from_the_port(root):
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench import harness
from portbench.layout import Cell
from portbench.run import forbidden_modules
root = Path({str(root)!r})
cell = Cell("hubbard6.ftlm", root=root, here=root / "portbench")
harness.run(cell, 7, 0.1, True, torch.device("cpu"), time.perf_counter())
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    assert out[-1] == "[]"
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench.reference import sector, solvers
from portbench.tests.test_portbench_reference import heisenberg_text
sec = sector("heisenberg", heisenberg_text(8), "cpu")
solvers.lowest_energy(sec)
solvers.ftlm(sec, torch.eye(sec.dim, dtype=torch.float64)[:4], [1.0], 10)
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "lanczosplusplus_tpu",
                 "lanczosplusplus_tpu_torch"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    assert out[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lanczosplusplus_tpu_torch_x", sys)
    assert "lanczosplusplus_tpu" not in entry.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in entry.forbidden_modules()


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "hubbard14.gs", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "hubbard14.gs", "--seed", str(SEED), "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, check=True)
    out = json.loads(done.stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
