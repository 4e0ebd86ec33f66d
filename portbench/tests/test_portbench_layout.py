"""BENCHMARK.json against the benchmark's contract, and the data files the
harness finds by name."""

import json
import re

import pytest

from portbench.layout import HERE, ROOT, Cell, benchmark
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCH = benchmark()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra
        assert NAME.match(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry and section != "end_to_end":
                assert line(entry[key])


def test_configs_lie_under_paths_and_state_their_cuts():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for entry in BENCH["configs"]:
        assert entry["file"].startswith("portbench/configs/")
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["name"] == entry["name"]
        assert config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"] == []
        assert all(NAME.match(k) for k in entry["reduced"])
        assert (HERE / "reference" / f"{config['reference']}.py").exists()


def test_cells_find_their_files_by_name():
    used = set()
    for workload in BENCH["workloads"]:
        assert workload["chips"] == 1
        assert NAME.match(workload["config"])
        assert NAME.match(workload["traffic"])
        cell = Cell(workload["name"])
        used.add(workload["config"])
        assert (HERE / "units" / f"{cell.traffic['unit']}.py").exists()
        assert (HERE / "builds" / f"{cell.config['build']}.py").exists()
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        e2e = {m["name"] for m in cell.metrics("end_to_end")}
        assert {"setup_s", cell.traffic["metric"]} <= e2e
        layer = cell.metrics("per_layer")
        assert layer
        for metric in layer:
            assert callable(cell.reader(metric["name"]))
            assert metric["moves"] in e2e
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_sources_and_layers():
    for metric in BENCH["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        if metric["name"].endswith("_roofline") or ".roofline" in \
                metric["name"] or "_roofline." in metric["name"]:
            assert metric["unit"] == "%"


def test_adding_a_config_and_a_mix_edits_no_file(tmp_path):
    before = tiny.digests(HERE)
    root = tiny.tree(tmp_path)
    after = tiny.digests(root / "portbench")
    assert {k: after[k] for k in before} == before
    added = sorted(set(after) - set(before))
    assert {"configs/hubbard6.json", "traffic/ftlm8.json",
            "builds/gathered.py", "units/lowest_states_full.py"} <= set(added)
    cell = Cell("hubbard6.ftlm8", root=root, here=root / "portbench")
    assert cell.traffic["params"]["vectors"] == 8
    assert {m["name"] for m in cell.metrics("per_layer")} >= {
        "build_s", "ftlm_step_ms", "apply_roofline.ftlm", "device_idle.ftlm"}
