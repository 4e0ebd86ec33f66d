"""The port's Engine and CLI: input0's energy, Engine energies held
against the JAX Engine on the CPU in float64, every model of the registry
built and solved, and the loud refusal of everything the port does not
hold yet (the measurement flags and the models that earlier slices
refused now run)."""

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
from test_torch_inputs import (feas_jterms_text, feas_so_text, feas_text,
                                heisenberg_text, immm_text, kitaev_text,
                                rashba_text, tj_text)

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


def test_cli_accepts_nthreads(tmp_path, capsys):
    """-S nthreads is accepted and ignored, as the JAX CLI and the
    reference do: the printed energy is the same with it and without it,
    and the same as the JAX CLI's on the same input."""
    from lanczosplusplus_tpu.cli import lanczos_main as jax_main
    path = _write(tmp_path, hubbard_chain_text(6))

    def energy(run, args):
        run(["-f", path, *args])
        return re.search(r"^Energy=(\S+)$", capsys.readouterr().out,
                         re.M).group(1)
    plain = energy(lanczos_main.run, ["--device", "cpu", "-p", "17"])
    assert energy(lanczos_main.run,
                  ["--device", "cpu", "-p", "17", "-S", "2"]) == plain
    assert energy(lanczos_main.run, ["--device", "cpu", "-S", "2"]) == \
        energy(jax_main.run, ["-S", "2"])


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


_FLAT_MODEL_INPUTS = {
    "Heisenberg": heisenberg_text(6, 1, 3),
    "Kitaev": kitaev_text(6, 1.0, 0.6, 0.8, periodic=1),
    "TjMultiOrb": tj_text(6, 2, 2, j=0.4, w=-0.1),
    "FeAsBasedSc": feas_text(2, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1],
                             2, 1),
    "FeAsBasedScExtended": feas_jterms_text(3, 2, 1),
    "FeAsBasedSc+SpinOrbit": feas_so_text(2, 2, 1),
    "Immm": immm_text(4, 2, 2),
    "HubbardOneBandRashbaSOC": rashba_text(4, 2),
}


@pytest.mark.parametrize("model", sorted(_FLAT_MODEL_INPUTS))
def test_flat_models_build_and_solve(tmp_path, capsys, model):
    """Every Model= string of the reference's selector builds through the
    registry and solves through the command line: the printed energy is
    the lowest eigenvalue of the dense matrix."""
    text = _FLAT_MODEL_INPUTS[model]
    inp = parse_input(text)
    assert inp.string("Model") == model.split("+")[0]
    built = build_model(inp, Geometry(inp))
    assert type(built).__module__.startswith(
        "lanczosplusplus_tpu_torch.models.")
    engine = lanczos_main.run(["-f", _write(tmp_path, text), "-p", "17",
                               "--device", "cpu"])
    assert type(engine.model) is type(built)
    energy = float(re.search(r"^Energy=(\S+)$", capsys.readouterr().out,
                             re.M).group(1))
    dense = np.linalg.eigvalsh(engine.hamiltonian.to_dense())
    assert abs(energy - dense[0]) <= 1e-10 * max(abs(dense[0]), 1.0)


def test_unknown_model_raises():
    inp = parse_input(INPUT0.replace("Model=HubbardOneBand",
                                     "Model=NoSuchModel"))
    with pytest.raises(ValueError, match="unknown Model="):
        build_model(inp, Geometry(inp))


@pytest.mark.parametrize("edit", [
    "UseTranslationSymmetry=1",
    pytest.param("SolverOptions=factored,bf16cross",
                 id="SolverOptions=factored")])
def test_unported_inputs_raise(tmp_path, monkeypatch, edit):
    """The bf16 cross gathers of the factored forms raise (the factored
    forms themselves run: tests/test_torch_factored.py).  Symmetry sectors
    are ported (tests/test_torch_symmetry.py): on input0's open chain,
    where translation does not commute with H, the port raises the JAX
    CLI's error."""
    monkeypatch.chdir(tmp_path)
    text = INPUT0.replace("SolverOptions=none", edit)
    path = _write(tmp_path, text)
    if edit.startswith("UseTranslationSymmetry"):
        from lanczosplusplus_tpu.cli import lanczos_main as jax_main
        for run, args in ((lanczos_main.run, ["--device", "cpu"]),
                          (jax_main.run, [])):
            with pytest.raises(ValueError, match="does not commute with "
                                                 "the symmetry"):
                run(["-f", path, *args])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        lanczos_main.run(["-f", path, "--device", "cpu"])


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
