"""profile_step.py's trace accounting on a synthetic chrome trace: device
busy time is the union of the device events' intervals, so overlapping
events count once and host events not at all.  The script imports no
jax."""

import ast
import json
import os

import profile_step

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
