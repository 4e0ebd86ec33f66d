"""Where the benchmark's data and plug-ins live, found by the names in
BENCHMARK.json and in the data files:

    configs/<config>.json     the input text, source, cuts, sizes, and the
                              name of its build path
    builds/<build>.py         ``build(config, device)``: the sector on the
                              card through the port, and its build seconds
    traffic/<mix>.json        a mix's kind of unit, end-to-end metric and
                              parameters
    units/<kind>.py           ``Unit``: one unit of work of a kind
    limits/<workload>.json    the limit of each number the check compares
    metrics/<metric>.py       ``read(context)``: one per-layer metric

A later cell adds files beside these; no file here names a cell, a build
path, a kind of unit or a metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_MODULES: dict[Path, object] = {}


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def by_name(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def data(folder: str, name: str, here: Path = HERE) -> dict:
    return json.loads((here / folder / f"{name}.json").read_text())


def module(folder: str, name: str, here: Path = HERE):
    """The Python file <folder>/<name>.py, loaded once a process."""
    path = here / folder / f"{name}.py"
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name.replace('.', '_')}", path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _MODULES[path] = loaded
    return _MODULES[path]


class Cell:
    """One workload of BENCHMARK.json with its configuration, mix, limits
    and metric entries."""

    def __init__(self, name: str, root: Path = ROOT, here: Path = HERE):
        bench = benchmark(root)
        self.bench = bench
        self.workload = by_name(bench["workloads"], name, "workload")
        self.name = name
        entry = by_name(bench["configs"], self.workload["config"],
                        "configuration")
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = data("traffic", self.workload["traffic"], here)
        self.limits = data("limits", name, here)
        self.here = here

    def metrics(self, section: str) -> list[dict]:
        """The metric entries of `section` (``end_to_end`` or
        ``per_layer``) this cell reports: those that list it, and those
        that list no workloads."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]

    def build(self, device):
        """(the configuration's sector Hamiltonian on `device`, host
        seconds of its build), by builds/<config's build>.py."""
        return module("builds", self.config["build"], self.here).build(
            self.config, device)

    def units(self, ham, seed: int, refine=True):
        """The mix's units on `ham`, by units/<mix's unit>.py.  `refine`:
        what a ground state's energy is refined against (``lowest_states``'s
        own default, or the float64 form a float32 copy was cast from)."""
        kind = module("units", self.traffic["unit"], self.here).Unit
        return kind(self.traffic["params"], ham, seed, refine)

    def reader(self, metric: str):
        """The ``read`` function of metrics/<metric>.py."""
        return module("metrics", metric, self.here).read
