"""``tiny.tree`` with a small t-U-J cell added the way a later change adds
one: the 6-site ring at half filling, a copy of superhubbard12 with its
metrics and limits (new files and new entries, no edit to a file that is
there)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.tests import tiny

BASE = "superhubbard12"
NAME = "superhubbard6"
CELL = f"{NAME}.gs"
EDITS = {"TotalNumberOfSites=12": "TotalNumberOfSites=6",
         "hubbardU 12 " + " ".join(["8"] * 12):
             "hubbardU 6 " + " ".join(["8"] * 6),
         "potentialV 24 " + " ".join(["0"] * 24):
             "potentialV 12 " + " ".join(["0"] * 12),
         "TargetElectronsUp=6": "TargetElectronsUp=3",
         "TargetElectronsDown=6": "TargetElectronsDown=3"}


def tree(tmp: Path) -> Path:
    """The root of ``tiny.tree(tmp)`` with the cell ``superhubbard6.gs``."""
    root = tiny.tree(tmp)
    here = root / "portbench"
    config = json.loads((here / "configs" / f"{BASE}.json").read_text())
    config["name"] = NAME
    config["input"] = [EDITS.get(line, line) for line in config["input"]]
    (here / "configs" / f"{NAME}.json").write_text(json.dumps(config))
    shutil.copy(here / "limits" / f"{BASE}.gs.json",
                here / "limits" / f"{CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": NAME, "source": config["source"],
                             "file": f"portbench/configs/{NAME}.json",
                             "reduced": [], "why": f"a small copy of {BASE}"})
    bench["workloads"].append({"name": CELL, "config": NAME, "traffic": "gs",
                               "chips": 1,
                               "why": f"a small copy of {BASE}.gs"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if f"{BASE}.gs" in metric.get("workloads", [CELL]):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root
