"""The superhubbard12.gs cell's two readers (``exchange_roofline.gs`` and
``exchange_host_share.gs``) on synthetic contexts, the spans
``Hamiltonian.matmat_t`` opens (nested inside ``hamiltonian.apply``, the
results the same with them on and off), and a small copy of the cell, the
6-site t-U-J ring, through the benchmark's harness on the CPU."""

import time
import types

import pytest
import torch

from lanczosplusplus_tpu_torch.core import sparse
from lanczosplusplus_tpu_torch.utils import progress
from portbench import harness, program, tracing
from portbench.layout import Cell, module
from portbench.reference import sector
from portbench.tests import tiny_superhubbard
from test_torch_super_hubbard_reference import (block, chain_text,
                                                port_hamiltonian, super_text)

SEED = 2**31 + 246813579
ELL = "void (anonymous namespace)::ell_spmv_kernel<double, 4>(...)"
ELL8 = "void (anonymous namespace)::ell_spmv_kernel<double, 8>(...)"
GEMM = "void (anonymous namespace)::factor_matmul_dmma_kernel<64, 64>(...)"
TEXTS = {"t-U-J": super_text(6, True, 3, 3),
         "one band": chain_text(6, True, 3, 3, "HubbardOneBand", [-1.0], 4.0)}


@pytest.fixture(autouse=True)
def clean():
    progress.reset()
    yield
    progress.reset()


def read(metric, context):
    return module("metrics", metric).read(context)


def traced(ops, metric="e0_s", least=(3e-4, "bytes")):
    return {"metric": metric, "least_apply_s": least,
            "trace": {"busy_s": 1.0, "window_s": 2.0, "apply_device_s": 0.01,
                      "breakdown": {"device_ops": ops, "idle_gaps": []}}}


@pytest.mark.parametrize("context,expected", [
    # 100 x 3e-4 s over the two ell_spmv forms' 3e-3 s
    (traced([[GEMM, 0.004], [ELL, 0.002], [ELL8, 0.001]]), 10.0),
    (traced([[ELL, 0.0006]]), 50.0),
    (traced([[GEMM, 0.004]]), None),
    (traced([]), None),
    (traced([[ELL, 0.002]], metric="ftlm_s"), None),
    (traced([[ELL, 0.002]], least=None), None),
    ({"metric": "e0_s", "least_apply_s": (3e-4, "bytes"), "trace": {}},
     None)])
def test_exchange_roofline(context, expected):
    value = read("exchange_roofline.gs", context)
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected, rel=1e-12)


def with_spans(monkeypatch, found):
    monkeypatch.setattr(program, "_progress", lambda: types.SimpleNamespace(
        COUNTS={}, totals=lambda: found))


@pytest.mark.parametrize("found,metric,expected", [
    ({"hamiltonian.apply": {"count": 4, "seconds": 2.0, "self_s": 0.1},
      "hamiltonian.ell": {"count": 4, "seconds": 0.5, "self_s": 0.5}},
     "e0_s", 25.0),
    # a port without the span, as before it was added
    ({"hamiltonian.apply": {"count": 4, "seconds": 2.0, "self_s": 2.0}},
     "e0_s", None),
    ({"hamiltonian.ell": {"count": 4, "seconds": 0.5, "self_s": 0.5}},
     "e0_s", None),
    ({}, "e0_s", None),
    ({"hamiltonian.apply": {"count": 4, "seconds": 2.0, "self_s": 0.1},
      "hamiltonian.ell": {"count": 4, "seconds": 0.5, "self_s": 0.5}},
     "ftlm_s", None)])
def test_exchange_host_share(monkeypatch, found, metric, expected):
    with_spans(monkeypatch, found)
    value = read("exchange_host_share.gs", {"metric": metric})
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected, rel=1e-12)


def test_exchange_host_share_without_span_totals(monkeypatch):
    """A port with no span totals at all reads nothing."""
    monkeypatch.setattr(program, "_progress",
                        lambda: types.SimpleNamespace(COUNTS={}))
    assert read("exchange_host_share.gs", {"metric": "e0_s"}) is None


@pytest.mark.parametrize("form", sorted(TEXTS))
def test_apply_spans_nest_inside_the_apply(form):
    ham = port_hamiltonian(TEXTS[form])
    with progress.recording():
        sparse.apply_vec(ham, block(ham.dim, 1)[0])
        sparse.apply_block_t(ham, block(ham.dim, 3))
    t = progress.totals()
    # without an ELL part the diagonal goes into spin_hop's launch, in the
    # factors' span, and no hamiltonian.ell span opens
    parts = (("hamiltonian.ell",) if ham.ell is not None else ()) + (
        "hamiltonian.factors",)
    assert t["hamiltonian.apply"]["count"] == 2
    assert {p for p in t if p.startswith("hamiltonian.")} == {
        "hamiltonian.apply", *parts}
    for part in parts:
        assert t[part]["count"] == 2
    # the apply's own time is what its parts leave of it
    assert t["hamiltonian.apply"]["seconds"] - t["hamiltonian.apply"][
        "self_s"] == pytest.approx(sum(t[p]["seconds"] for p in parts),
                                   abs=1e-9)
    for part in parts:
        assert t[part]["self_s"] == t[part]["seconds"]


def test_apply_spans_are_profiler_annotations():
    from torch.profiler import ProfilerActivity, profile

    ham = port_hamiltonian(TEXTS["t-U-J"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sparse.apply_vec(ham, block(ham.dim, 1)[0])
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names.count("hamiltonian.ell") == 1
    assert names.count("hamiltonian.factors") == 1


@pytest.mark.parametrize("rows", [None, 1, 3])
@pytest.mark.parametrize("form", sorted(TEXTS))
def test_spans_change_no_result(form, rows):
    from torch.profiler import ProfilerActivity, profile

    ham = port_hamiltonian(TEXTS[form])
    x = block(ham.dim, rows or 1)
    if rows is None:
        x = x[0].contiguous()
    off = ham.matmat_t(x)
    with progress.recording():
        on = ham.matmat_t(x)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = ham.matmat_t(x)
    assert torch.equal(off, on) and torch.equal(off, profiled)
    part = "hamiltonian.ell" if ham.ell is not None else "hamiltonian.factors"
    assert progress.totals()[part]["count"] == 2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tiny_superhubbard.tree(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(threads)


@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_through_the_harness(root, monkeypatch, trace):
    # the first unit traced, the others not
    monkeypatch.setattr(tracing, "TRACE_SECONDS", 0.01)
    cell = Cell(tiny_superhubbard.CELL, root=root, here=root / "portbench")
    out = harness.run(cell, SEED, 2.0 if trace else 0.3, trace,
                      torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["eigpair_gap"]["value"] <= 1e-9
    metrics = out["metrics"]
    if not trace:
        assert set(metrics) == {"setup_s", "e0_s"}
    else:
        listed = {m["name"] for m in cell.metrics("per_layer")}
        assert {"exchange_roofline.gs", "exchange_host_share.gs"} <= listed
        # a CPU run has no device trace
        assert set(metrics) == listed - {"apply_roofline.gs",
                                         "device_idle.gs",
                                         "exchange_roofline.gs"}
        share = metrics["exchange_host_share.gs"]
        assert 0.0 < share["value"] < 100.0 and share["unit"] == "%"
    reference = sector("super_hubbard", "\n".join(cell.config["input"]),
                       "cpu")
    assert progress.COUNTS["build.exchange_entries"] == \
        reference.exchange_entries() == 432


def test_exchange_of_the_wrong_sign_is_not_correct(root, monkeypatch):
    """The exchange's fermion sign, the one part of this model the other
    cells' references do not hold: flipped in the port, the run fails."""
    from lanczosplusplus_tpu_torch.models.hubbard import HubbardModel

    real = HubbardModel._j_offdiagonal_coo

    def flipped(self, basis, dtype):
        cols, vals = real(self, basis, dtype)
        return cols, -vals
    monkeypatch.setattr(HubbardModel, "_j_offdiagonal_coo", flipped)
    cell = Cell(tiny_superhubbard.CELL, root=root, here=root / "portbench")
    out = harness.run(cell, SEED, 0.3, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"] is False
    assert out["checks"]["eigpair_gap"]["value"] > 1e-9


def test_float32_control_is_not_correct(root):
    """The port's float32 path in the program's place, as ``control.py``
    reads it on the card at the cell's own size."""
    from lanczosplusplus_tpu_torch.ops import refine
    from portbench.control import readings
    from portbench.sector import input_text

    cell = Cell(tiny_superhubbard.CELL, root=root, here=root / "portbench")
    ham, _ = cell.build(torch.device("cpu"))
    reference = sector("super_hubbard", input_text(cell.config), "cpu")
    program = readings(cell, ham, reference, [SEED], 2, log=lambda s: None)
    control = readings(cell, refine.narrowed(ham), reference, [SEED + 1], 2,
                       refine=ham, log=lambda s: None)
    assert program["eigpair_gap"][0] <= cell.limits["eigpair_gap"]
    assert control["eigpair_gap"][0] > cell.limits["eigpair_gap"]
