"""A copy of the benchmark in a temporary directory, with small cells added
the way a later change adds one: new files and new entries, no edit to a
file that is there."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from portbench.layout import HERE, ROOT

# name -> (configuration it copies, {text in the input: its replacement})
SMALL = {
    "hubbard6": ("hubbard14", {
        "TotalNumberOfSites=14": "TotalNumberOfSites=6",
        "hubbardU 14 " + " ".join(["4"] * 14):
            "hubbardU 6 " + " ".join(["4"] * 6),
        "potentialV 28 " + " ".join(["0"] * 28):
            "potentialV 12 " + " ".join(["0"] * 12),
        "TargetElectronsUp=7": "TargetElectronsUp=3",
        "TargetElectronsDown=7": "TargetElectronsDown=3"}),
    "heisenberg8": ("heisenberg24", {
        "TotalNumberOfSites=24": "TotalNumberOfSites=8",
        "TargetSzPlusConst=12": "TargetSzPlusConst=4"}),
}
# a mix added as data alone: fewer vectors and steps than ftlm
SMALL_MIX = ("ftlm8", "ftlm", {"vectors": 8, "steps": 40})
# a build path and a kind of unit added as files of their own
GATHERED = '''"""The flat sector with its one-spin hops left as gather maps: no
factor densified on the card."""
import time

import torch

from portbench.sector import input_text


def build(config, device):
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    inp = parse_input(input_text(config))
    start = time.perf_counter()
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    ham = model.hamiltonian(basis, dtype=torch.float64, device=device)
    return ham, time.perf_counter() - start
'''
FULL_REORTH = '''"""Ground-state solves reorthogonalized fully."""
from pathlib import Path

from portbench.layout import module

_solves = module("units", "lowest_states",
                 Path(__file__).resolve().parent.parent).Unit


class Unit(_solves):
    def __init__(self, params, ham, seed, refine=True):
        super().__init__({**params, "reorth": "full"}, ham, seed, refine)
'''
# (cell, configuration, mix, cell whose metrics and limits it takes)
PLUGGED = [("hubbard6g.gs", "hubbard6g", "gs", "hubbard14.gs"),
           ("heisenberg8.gsfull", "heisenberg8", "gsfull",
            "heisenberg24.gs")]


def digests(folder: Path) -> dict[str, str]:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def tree(tmp: Path) -> Path:
    """The root of a benchmark copy under `tmp` whose BENCHMARK.json has
    the cells <small>.gs, <small>.ftlm, hubbard6.ftlm8 and the cells of
    ``PLUGGED`` besides its own."""
    root = tmp / "checkout"
    here = root / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for name, (base, edits) in SMALL.items():
        config = json.loads((here / "configs" / f"{base}.json").read_text())
        config["name"] = name
        for old, new in edits.items():
            config["input"] = [line.replace(old, new)
                               for line in config["input"]]
        (here / "configs" / f"{name}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": config["source"],
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [],
                                 "why": f"a small copy of {base}"})
        for mix in ("gs", "ftlm"):
            cells.append((f"{name}.{mix}", name, mix, f"{base}.{mix}"))
    mix, base_mix, params = SMALL_MIX
    traffic = json.loads((here / "traffic" / f"{base_mix}.json").read_text())
    traffic["params"].update(params)
    (here / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    cells.append((f"hubbard6.{mix}", "hubbard6", mix, "hubbard14.ftlm"))
    (here / "builds" / "gathered.py").write_text(GATHERED)
    (here / "units" / "lowest_states_full.py").write_text(FULL_REORTH)
    config = json.loads((here / "configs" / "hubbard6.json").read_text())
    config.update(name="hubbard6g", build="gathered")
    (here / "configs" / "hubbard6g.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "hubbard6g",
                             "source": config["source"],
                             "file": "portbench/configs/hubbard6g.json",
                             "reduced": [],
                             "why": "a small copy of hubbard6, built by "
                                    "a gathered path"})
    traffic = json.loads((here / "traffic" / "gs.json").read_text())
    traffic["unit"] = "lowest_states_full"
    (here / "traffic" / "gsfull.json").write_text(json.dumps(traffic))
    for cell, config, mix, like in cells + PLUGGED:
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": f"a small copy of {like}"})
        shutil.copy(here / "limits" / f"{like}.json",
                    here / "limits" / f"{cell}.json")
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", [cell]):
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root
