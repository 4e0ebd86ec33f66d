"""The port's Engine and CLI: input0's energy, Engine energies held
against the JAX Engine on the CPU in float64, and the loud refusal of
everything the port does not hold yet (the measurement flags that earlier
slices refused now run)."""

import re

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config, load
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_torch_host import (E0_INPUT0, INPUT0, hubbard_chain_text,
                             super_hubbard_text)

torch.set_num_threads(2)

CPU = Config(device="cpu")


def _write(tmp_path, text, name="input.inp"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_cli_input0_energy(tmp_path, capsys):
    engine = lanczos_main.run(["-f", _write(tmp_path, INPUT0), "-p", "17",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    energy = float(re.search(r"^Energy=(\S+)$", out, re.M).group(1))
    assert abs(energy - E0_INPUT0) <= 1e-12
    norm = float(re.search(r"^E\[0\]=\S+ norm=(\S+)$", out, re.M).group(1))
    assert abs(norm - 1.0) <= 1e-12
    assert engine.config.device == torch.device("cpu")


def test_cli_printmatrix_oracle(tmp_path, capsys):
    text = INPUT0.replace("SolverOptions=none", "SolverOptions=printmatrix")
    lanczos_main.run(["-f", _write(tmp_path, text), "--device", "cpu"])
    out = capsys.readouterr().out
    spectrum = out.split("#FullSpectrum\n")[1].split("Energy=")[0].split()
    assert len(spectrum) == 36
    assert abs(float(spectrum[0]) - E0_INPUT0) <= 1e-12


@pytest.mark.parametrize("name", ["chain8", "super6"])
def test_engine_e0_matches_jax_engine(name):
    text = {"chain8": hubbard_chain_text(8),
            "super6": super_hubbard_text(6)}[name]
    inp, jinp = parse_input(text), jax_parse(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    assert abs(engine.ground_energy - jengine.ground_energy) <= \
        1e-10 * abs(jengine.ground_energy)
    assert engine.solve_info.converged
    assert engine.eigenvector(0).shape == (engine.basis.size,)


def test_engine_logs_one_spin_form(capsys):
    engine = load(hubbard_chain_text(6), CPU)
    assert engine.hamiltonian.factorized.up_dense is None
    assert "one-spin factors on cpu: gather form" in capsys.readouterr().err


@pytest.mark.parametrize("use_complex,dtype", [(False, torch.float64),
                                               (True, torch.complex128)])
def test_config_solves_in_double(use_complex, dtype):
    assert Config(use_complex=use_complex, device="cpu").scalar_dtype == dtype


def test_engine_excited_states():
    text = hubbard_chain_text(6).replace("SolverOptions=none",
                                         "SolverOptions=none\nExcited=2")
    engine = load(text, Config(device="cpu"))
    dense = np.linalg.eigvalsh(engine.hamiltonian.to_dense())
    got = [engine.energies(i) for i in range(3)]
    np.testing.assert_allclose(got, dense[:3], atol=1e-9)


@pytest.mark.parametrize("flag", [["--kpm"], ["--ftlm-dos", "1.0"]],
                         ids=["kpm", "ftlm-dos"])
def test_unported_flags_raise(tmp_path, monkeypatch, capsys, flag):
    """--kpm and --ftlm-dos raise before any work."""
    monkeypatch.chdir(tmp_path)
    argv = ["-f", _write(tmp_path, INPUT0 + "TSPSites 2 0 1\n"), "--device",
            "cpu", *flag]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        lanczos_main.run(argv)
    assert capsys.readouterr().out == ""
    assert not list(tmp_path.glob("*.comb"))


@pytest.mark.parametrize("flag,expect", [
    (["-g", "c"], "#gf(i=0, j=1)"), (["-c", "n"], "[["),
    (["-m", "gs|n[0]|gs"], "gs|n[0]|gs = "),
    (["-M", "n?0?0"], "<gs|n?0?0|gs>="), (["-r", "2"], "EntanglementEntropy=")],
    ids=["g", "c", "m", "M", "r"])
def test_measurement_flags_run(tmp_path, monkeypatch, capsys, flag, expect):
    """The measurement flags of the spectral slice run and print; only -g
    writes a .comb file."""
    monkeypatch.chdir(tmp_path)
    engine = lanczos_main.run(
        ["-f", _write(tmp_path, INPUT0 + "TSPSites 2 0 1\n"), "--device",
         "cpu", *flag])
    assert abs(engine.ground_energy - E0_INPUT0) <= 1e-12
    assert expect in capsys.readouterr().out
    assert (tmp_path / "input.inp0.comb").exists() == (flag[0] == "-g")


@pytest.mark.parametrize("model", ["Heisenberg", "Kitaev", "TjMultiOrb",
                                   "FeAsBasedSc", "Immm",
                                   "HubbardOneBandRashbaSOC"])
def test_unported_models_raise(model):
    inp = parse_input(INPUT0.replace("Model=HubbardOneBand",
                                     f"Model={model}"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        build_model(inp, Geometry(inp))


@pytest.mark.parametrize("edit", ["UseTranslationSymmetry=1",
                                  "SolverOptions=factored"])
def test_unported_inputs_raise(tmp_path, monkeypatch, edit):
    """Symmetry sectors and factored forms raise."""
    monkeypatch.chdir(tmp_path)
    text = INPUT0.replace("SolverOptions=none", edit)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        lanczos_main.run(["-f", _write(tmp_path, text), "--device", "cpu"])


def test_density_of_states_input_runs(tmp_path, monkeypatch):
    """ComputeDensityOfStates=1 writes one .comb per site."""
    monkeypatch.chdir(tmp_path)
    text = INPUT0.replace("SolverOptions=none", "ComputeDensityOfStates=1")
    lanczos_main.run(["-f", _write(tmp_path, text), "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.glob("*.comb")) == \
        [f"input.inp{i}.comb" for i in range(4)]


def test_ainur_input_raises():
    with pytest.raises(NotImplementedError, match="item 14"):
        parse_input("##Ainur1.0\nTotalNumberOfSites=4;\n")


def test_cuda_without_card_raises(monkeypatch):
    """Asking for cuda where there is no card is an error, never a CPU
    run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Config()
    with pytest.raises(RuntimeError, match="cuda"):
        Config(device="cuda:0")


def test_cli_measurements_without_card_raise(tmp_path, monkeypatch):
    """The measurement flags run on the card by default too: without one
    (and without --device cpu) the command raises and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, INPUT0 + "TSPSites 2 0 1\n")
    with pytest.raises(RuntimeError, match="cuda"):
        lanczos_main.run(["-f", path, "-g", "c", "-c", "n"])
    assert not list(tmp_path.glob("*.comb"))
