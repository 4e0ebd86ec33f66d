"""profile_step.py's trace accounting on a synthetic chrome trace: device
busy time is the union of the device events' intervals, so overlapping
events count once and host events not at all.  The script imports no
jax."""

import ast
import json
import os

import pytest
import torch

import chip_smoke
import profile_step
from lanczosplusplus_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _event(cat, ts, dur, name="k", ph="X"):
    return dict(cat=cat, ts=ts, dur=dur, name=name, ph=ph)


def test_busy_is_the_union_of_device_intervals(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        _event("cpu_op", 0.0, 1000.0, "aten::mm"),
        _event("cuda_runtime", 5.0, 3.0, "cudaLaunchKernel"),
        _event("kernel", 10.0, 20.0, "a"),
        _event("kernel", 15.0, 10.0, "b"),       # inside a
        _event("gpu_memcpy", 25.0, 15.0, "c"),   # overlaps a's end
        _event("gpu_memset", 50.0, 5.0, "d"),
        _event("kernel", 60.0, 0.0, "e", ph="i"),
    ]}))
    events = profile_step.device_events(str(trace))
    assert [e["name"] for e in events] == ["a", "b", "c", "d"]
    assert profile_step.busy_us(events) == 35.0
    assert profile_step.by_name_ms(events, 2) == {"a": 0.02, "c": 0.015}
    assert profile_step.busy_us([]) == 0.0


def test_gather_arguments():
    """--gather times perm_gather alone, not with another profile."""
    args = profile_step.parse_args(["--gather"])
    assert args.gather and not args.spectral
    assert args.flat is None
    assert not profile_step.parse_args([]).gather
    for bad in (["--sweep"], ["--gather", "--flat", "tj18"],
                ["--gather", "--spectral"]):
        with pytest.raises(SystemExit):
            profile_step.parse_args(bad)


def test_sym_arguments():
    """--sym runs bench.py's projected Kitaev section alone."""
    args = profile_step.parse_args(["--sym"])
    assert args.sym and not args.gather and not args.spectral
    assert args.flat is None
    assert not profile_step.parse_args([]).sym
    for bad in (["--sym", "--gather"], ["--sym", "--flat", "kitaev24f"]):
        with pytest.raises(SystemExit):
            profile_step.parse_args(bad)


def test_gather_cases_on_small_inputs(monkeypatch):
    """--gather's cases, built on the CPU from small inputs of the same
    models: the one-spin up and dn forms at R = 1 and 14, then each
    form's largest PermCrossTerm, with operands whose shapes the tables
    fit; the plain version runs on each."""
    chain = chip_smoke.hubbard_chain_text
    monkeypatch.setattr(chip_smoke, "hubbard_chain_text",
                        lambda nsite, u, *a: chain(6, u, *a))
    monkeypatch.setattr(profile_step, "GATHER_FORMS", (
        ("8-site t-J", "tj_ring_text", (8, 3, 3)),
        ("7-site Rashba half-cut", "rashba_ring_text",
         (7, 7, "0.5", "none")),
        ("4-site FeAs interaction", "feas_ring_text", (4, 2, 2)),
        ("3-site FeAs spin-orbit", "feas_spinorbit_chain_text",
         (3, 2, 1))))
    cases = profile_step.gather_cases(torch.device("cpu"))
    labels = [c[0] for c in cases]
    assert [lab.split(" (")[0] for lab in labels[:4]] == [
        f"f64 14-site one-spin {side} gather form, R={r}"
        for side in ("up", "dn") for r in (1, 14)]
    assert [lab.split(" largest")[0] for lab in labels[4:]] == [
        "f64 8-site t-J", "f64 7-site Rashba half-cut",
        "f64 4-site FeAs interaction", "c128 3-site FeAs spin-orbit"]
    for case, x, y0, tables in cases:
        nb = {t.shape[0] for t in tables.values()}
        assert len(nb) == 1
        rows, cols = y0.shape[-2:]
        for name, length in (("rs", rows), ("a", rows), ("cs", cols),
                             ("beta", cols)):
            if name in tables:
                assert tables[name].shape[1] == length, case
        got = kernels.perm_gather(x, y0.clone(), **tables)
        assert got.shape == y0.shape and torch.isfinite(got).all()


def test_profile_step_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "profile_step.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "torch" in names
    assert not [n for n in names if n.split(".")[0] in
                ("jax", "lanczosplusplus_tpu")]


def test_ftlm_arguments():
    """--ftlm traces the FTLM recurrence alone, not with another
    profile."""
    args = profile_step.parse_args(["--ftlm"])
    assert args.ftlm and not args.spectral and not args.gather
    assert args.flat is None
    assert not profile_step.parse_args([]).ftlm
    for bad in (["--ftlm", "--spectral"], ["--ftlm", "--flat", "tj18"]):
        with pytest.raises(SystemExit):
            profile_step.parse_args(bad)


def test_ftlm_recurrence_on_a_small_sector():
    """--ftlm's traced step on the CPU at 6 sites, through the kernels'
    plain versions as its plain turns run it: the recurrence's (steps, R)
    coefficients, equal both ways, and no operator dots."""
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    inp = parse_input(chip_smoke.hubbard_chain_text(6, 4))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)))
    v0 = lz.random_start_block(ham.dim, profile_step.FTLM_ROWS,
                               profile_step.FTLM_SEED, ham.dtype,
                               "cpu").T.contiguous()
    got = profile_step.ftlm_recurrence(ham, v0, 4)
    plain = profile_step.ftlm_recurrence(chip_smoke.PlainForm(ham), v0, 4)
    assert got[0].shape == got[1].shape == (4, profile_step.FTLM_ROWS)
    assert got[2].shape == (4, 0, profile_step.FTLM_ROWS)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
