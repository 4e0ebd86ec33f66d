"""The PyTorch port stands without JAX: in a fresh interpreter, importing
every module of the port and running its CLI with every measurement flag
(the estimators' --kpm and --ftlm-dos too), ed --ftlm, thermal --ftlm,
consistency --tinf, spin_orbital, the sector-file writer and the native
host runtime loads no jax module, nor does a gloo world of 2 fresh
interpreters running the distributed dry run, and
chip_smoke.py imports none either and refuses to run without a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from test_torch_host import INPUT0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = """
import importlib, pkgutil, sys
import lanczosplusplus_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.cli import ed_main, thermal_main
lanczos_main.run(["-f", sys.argv[1], "--device", "cpu", "-g", "c", "-c", "n",
                  "-m", "gs|n[0]|gs", "-M", "n?0?0", "-r", "2", "--kpm",
                  "--ftlm-dos", "1.0"])
ed_main.run(["-f", sys.argv[1], "--device", "cpu", "--ftlm"])
thermal_main.run(["-f", sys.argv[1], "--device", "cpu", "--ftlm", "-b", "1"])
from lanczosplusplus_tpu_torch.cli import consistency_main, spin_orbital_main
consistency_main.run(["-f", sys.argv[1], "--device", "cpu", "--tinf"])
spin_orbital_main.run(["2", "1", "--device", "cpu"])
from lanczosplusplus_tpu_torch import Config, load, native
from lanczosplusplus_tpu_torch.io_ import sector_files
model = load(sys.argv[1], Config(device="cpu")).model
sector_files.write_all_sectors("sectors.dat", model, 4, device="cpu")
assert native.available()
assert native.enumerate_combinations(17, 8).shape == (24310,)
jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
assert not jax_mods, jax_mods
print("NO_JAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_runs_without_importing_jax(tmp_path):
    path = tmp_path / "input0.inp"
    path.write_text(INPUT0 + "TSPCenter=1\nTemperatureOrBeta=beta\n"
                    "TemperatureOrBetaStart=0.5\nTemperatureOrBetaTotal=2\n"
                    "TemperatureOrBetaStep=1\nFTLMVectors=4\n"
                    "FTLMSteps=20\nKPMMoments=128\n")
    proc = subprocess.run([sys.executable, "-c", _PROGRAM, str(path)],
                          capture_output=True, text=True, env=_env(),
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Energy=-4.472136" in proc.stdout
    assert "NO_JAX_OK" in proc.stdout
    # the spectral slice ran: a batched fleet and every static observable
    assert len(list(tmp_path.glob("input0.inp*.comb"))) == 4
    assert "EntanglementEntropy=" in proc.stdout
    # the estimators ran: one diagonal pair, its KPM and FTLM densities,
    # the FTLM schedule and the grand-canonical FTLM sweep
    assert sorted(p.name for p in tmp_path.glob("input0.inp*dos")) == \
        ["input0.inp1.ftlmdos", "input0.inp1.kpmdos"]
    assert "method=FTLM R=4 M=20" in proc.stdout
    assert "lnZPartition=" in proc.stderr
    # the consistency and spin-orbital checks and the sector sweep ran
    assert "T=infinity energy=" in proc.stdout
    assert "LAPACK energy=" in proc.stdout
    assert open(tmp_path / "sectors.dat").read().startswith(
        "#TotalSectors=25\n")


def test_distributed_dry_run_loads_no_jax(tmp_path):
    """Two fresh interpreters, ranks of one gloo group on the CPU, run
    ``parallel.dryrun.dryrun(mesh)``: every path agrees with the
    single-device port and neither interpreter holds a jax module."""
    from torch_world import run_world

    for errs, jax_mods, transport in run_world(
            2, "torch_parallel_paths:dryrun_no_jax", tmp_path):
        assert not jax_mods, jax_mods
        assert transport == "gloo"
        assert max(errs.values()) <= 1e-10


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names
    assert not [n for n in names if n.split(".")[0] in
                ("jax", "lanczosplusplus_tpu")]


@pytest.mark.parametrize("where", ["no_card", "script_alone"])
def test_chip_smoke_fails_without_card_or_package(tmp_path, where):
    """No card, or a directory holding chip_smoke.py and nothing else of
    the repository: a non-zero exit and no result line."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    env = dict(os.environ)
    if where == "no_card":
        env = _env()
    else:
        env.pop("PYTHONPATH", None)
    code = ("import runpy, torch; "
            f"torch.cuda.is_available = lambda: {where != 'no_card'}; "
            f"runpy.run_path({str(script)!r}, run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    expect = ("is_available() is False" if where == "no_card"
              else "No module named 'lanczosplusplus_tpu_torch'")
    assert expect in proc.stderr
