"""The per-layer metrics that read the port's own spans and counters
(``program.py``), from traced runs of the harness on the CPU at small
sizes, and from a port that has none of them."""

import time
import types

import pytest
import torch

from portbench import harness, tracing
from portbench.layout import Cell
from portbench.tests import tiny

SEED = 2**31 + 123456789
PROGRAM = {"host_reads_per_step", "reorth_per_step", "ftlm_host_share"}
DEVICE_ONLY = {"apply_roofline.gs", "apply_roofline.ftlm", "device_idle.gs",
               "device_idle.ftlm"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tiny.tree(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(threads)


def traced(root, monkeypatch, workload):
    from lanczosplusplus_tpu_torch.utils import progress

    # the first unit traced, the others not
    monkeypatch.setattr(tracing, "TRACE_SECONDS", 0.01)
    progress.reset()
    cell = Cell(workload, root=root, here=root / "portbench")
    out = harness.run(cell, SEED, 2.0, True, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"] is True
    listed = {m["name"] for m in cell.metrics("per_layer")}
    return out["metrics"], listed


@pytest.mark.parametrize("workload,reads,passes", [
    # selective: 3 reads a step and 2 a Gram-Schmidt call, at most 2
    # passes a call
    ("heisenberg8.gs", (3.0, 7.0), (0.0, 2.0)),
    ("hubbard6.gs", (3.0, 7.0), (0.0, 2.0)),
    # full: alpha and beta, and the call's 2 norms every step
    ("heisenberg8.gsfull", (4.0, 4.0), (1.0, 2.0))])
def test_solver_counters(root, monkeypatch, workload, reads, passes):
    metrics, listed = traced(root, monkeypatch, workload)
    assert {"host_reads_per_step", "reorth_per_step"} <= listed
    assert "ftlm_host_share" not in listed | set(metrics)
    assert reads[0] <= metrics["host_reads_per_step"]["value"] <= reads[1]
    assert metrics["host_reads_per_step"]["unit"] == "reads"
    assert passes[0] <= metrics["reorth_per_step"]["value"] <= passes[1]
    assert metrics["reorth_per_step"]["unit"] == "passes"
    assert not DEVICE_ONLY & set(metrics)


@pytest.mark.parametrize("workload", ["hubbard6.ftlm", "heisenberg8.ftlm"])
def test_ftlm_host_share(root, monkeypatch, workload):
    from lanczosplusplus_tpu_torch.utils import progress

    metrics, listed = traced(root, monkeypatch, workload)
    assert "ftlm_host_share" in listed
    share = metrics["ftlm_host_share"]
    assert 0.0 < share["value"] < 100.0 and share["unit"] == "%"
    assert not {"host_reads_per_step", "reorth_per_step"} & set(metrics)
    assert not DEVICE_ONLY & set(metrics)
    # recorded in the traced part only: one estimate of the window
    assert progress.totals()["ftlm.estimate"]["count"] == 1


@pytest.mark.parametrize("workload", ["heisenberg8.gs", "hubbard6.ftlm"])
def test_a_port_without_them_reads_nothing(root, monkeypatch, workload):
    """A port without spans and counters (an earlier commit) leaves the
    metrics out, and the run is whole."""
    from portbench import program

    # the module as such a port has it: a phase timer, nothing more
    monkeypatch.setattr(program, "_progress", lambda: types.SimpleNamespace(
        ProgressIndicator=object))
    metrics, listed = traced(root, monkeypatch, workload)
    assert PROGRAM & listed and not PROGRAM & set(metrics)
