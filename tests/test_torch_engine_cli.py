"""The port's Engine and CLIs: input0's energy, Engine energies held
against the JAX Engine on the CPU in float64, every model of the registry
built and solved, the loud refusal of everything the port does not hold
yet, and the estimator CLIs against the JAX package's: ``lanczos --kpm``
and ``--ftlm-dos`` (their .kpmdos and .ftlmdos files), ``ed`` (full
spectrum, ``--ftlm``, ``--ltlm``), ``thermal`` (full spectra with ``-c``,
and ``--ftlm``), ``sqomega``, ``dynamics1``, ``qpz`` and ``lorentzian``.
Where an estimator draws random vectors, the port is handed the JAX
package's draw through its start-vector hook, so the two agree to
rounding: 1e-8 relative for outputs printed or written with 10 digits
after plain recurrences, 1e-10 otherwise (5e-8 where a value is printed
with 8 significant digits)."""

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
    """An Ainur input parses as the JAX package parses it, and its forms
    outside the documented subset raise ValueError in both."""
    text = "##Ainur1.0\nTotalNumberOfSites=4;\nvector hubbardU=[1, 2];\n"
    assert parse_input(text).entries == jax_parse(text).entries
    bad = "##Ainur1.0\nFiniteLoops=![7, [100, 0.5, 0]];\n"
    for parse in (parse_input, jax_parse):
        with pytest.raises(ValueError, match="subset"):
            parse(bad)


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


# -- the estimator CLIs against the JAX package's ---------------------------

def _jax_draw(dim, num, seed, dtype):
    """The JAX package's random_start_block for the port's arguments."""
    from lanczosplusplus_tpu.solver.lanczos import random_start_block
    npdt = np.complex128 if dtype.is_complex else np.float64
    return torch.as_tensor(np.array(random_start_block(dim, num, seed,
                                                       npdt)))


def _use_jax_draws(monkeypatch):
    """Every random block of the port's estimators becomes the JAX
    package's draw for the same dim, R and seed."""
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    monkeypatch.setattr(lz, "random_start_block",
                        lambda dim, num, seed, dtype, device: _jax_draw(
                            dim, num, seed, dtype).to(device))


def _numbers(text):
    """Every number of the lines of `text` that start with one."""
    out = []
    for line in text.splitlines():
        fields = line.replace("=", " ").split()
        try:
            out.append([float(x) for x in fields])
        except ValueError:
            continue
    return out


def _labelled(text):
    """{label: value} of every ``label=number`` in `text`."""
    return {k: float(v) for k, v in
            re.findall(r"(\w+)=([-+0-9.eE]+[0-9])", text)}


def _assert_numbers_close(got, want, rtol):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1.0)


def _run_both(tmp_path, monkeypatch, capsys, port_run, jax_run, text, args,
              port_args=("--device", "cpu")):
    """Run a port CLI and the JAX CLI on the same input, each in a
    directory of its own; returns ((stdout, stderr, dir) of the port,
    the same of JAX)."""
    outs = []
    for name, run, extra in (("port", port_run, list(port_args)),
                             ("jax", jax_run, [])):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        run(["-f", _write(where, text), *args, *extra])
        got = capsys.readouterr()
        outs.append((got.out, got.err, where))
    return outs


@pytest.mark.parametrize("flag,suffix", [(["--kpm"], "kpmdos"),
                                         (["--ftlm-dos", "1.5"], "ftlmdos")],
                         ids=["kpm", "ftlm-dos"])
def test_estimator_flags_match_jax(tmp_path, monkeypatch, capsys, flag,
                                   suffix):
    """lanczos -g c --kpm and --ftlm-dos write the JAX CLI's .kpmdos and
    .ftlmdos files: the same header, the same grid, the densities to 1e-8
    of their maximum (KPM: every destination sector of input0 has dim 24,
    so both packages' spectral bounds are its extreme eigenvalues; FTLM:
    the port's Engine takes the JAX block through its start_vectors
    hook)."""
    from lanczosplusplus_tpu.cli import lanczos_main as jax_main
    if suffix == "ftlmdos":
        original = Engine.ftlm_local_dos

        def hooked(self, *args, num_vectors=16, seed=152917, **kwargs):
            ham = self.hamiltonian
            return original(self, *args, num_vectors=num_vectors, seed=seed,
                            start_vectors=_jax_draw(ham.dim, num_vectors,
                                                    seed, ham.dtype),
                            **kwargs)
        monkeypatch.setattr(Engine, "ftlm_local_dos", hooked)
    text = INPUT0 + ("TSPSites 2 1 1\nKPMOmegaBegin=-8\nKPMOmegaStep=0.05\n"
                     "KPMOmegaTotal=321\nKPMMoments=128\n"
                     "FTLMOmegaBegin=-8\nFTLMOmegaStep=0.05\n"
                     "FTLMOmegaTotal=321\nFTLMDelta=0.2\nFTLMVectors=4\n"
                     "FTLMSteps=20\n")
    (_, _, pdir), (_, _, jdir) = _run_both(
        tmp_path, monkeypatch, capsys, lanczos_main.run, jax_main.run, text,
        ["-g", "c", *flag])
    got = (pdir / f"input.inp0.{suffix}").read_text()
    want = (jdir / f"input.inp0.{suffix}").read_text()
    assert got.splitlines()[:2] == want.splitlines()[:2]
    got, want = np.loadtxt(got.splitlines()), np.loadtxt(want.splitlines())
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.abs(want[:, 1]).max() > 0.05
    assert np.abs(got[:, 1] - want[:, 1]).max() <= \
        1e-8 * np.abs(want[:, 1]).max()
    assert (pdir / "input.inp0.comb").exists()


_SCHEDULE = ("TemperatureOrBeta=beta\nTemperatureOrBetaStart=0.2\n"
             "TemperatureOrBetaTotal=4\nTemperatureOrBetaStep=0.9\n"
             "FTLMVectors=3\nFTLMSteps=20\n")


@pytest.mark.parametrize("flag", [[], ["--ftlm"], ["--ltlm"]],
                         ids=["full", "ftlm", "ltlm"])
def test_ed_cli_matches_jax(tmp_path, monkeypatch, capsys, flag):
    from lanczosplusplus_tpu.cli import ed_main as jax_ed
    from lanczosplusplus_tpu_torch.cli import ed_main
    _use_jax_draws(monkeypatch)
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, ed_main.run, jax_ed.run,
        hubbard_chain_text(6) + _SCHEDULE, flag)
    assert out.splitlines()[:2] == jout.splitlines()[:2]
    _assert_numbers_close(_numbers(out), _numbers(jout), 1e-10)


@pytest.mark.parametrize("flag", [["-c", "c", "-s", "0,1"], ["--ftlm"]],
                         ids=["full", "ftlm"])
def test_thermal_cli_matches_jax(tmp_path, monkeypatch, capsys, flag):
    """Full spectra with the correlator's poles (held through their sum
    and moments: single poles of a degenerate level differ between two
    eigensolvers), and the FTLM sweep from the JAX draws."""
    from lanczosplusplus_tpu.cli import thermal_main as jax_thermal
    from lanczosplusplus_tpu_torch.cli import thermal_main
    _use_jax_draws(monkeypatch)
    (out, err, _), (jout, jerr, _) = _run_both(
        tmp_path, monkeypatch, capsys, thermal_main.run, jax_thermal.run,
        hubbard_chain_text(4, periodic=False) + _SCHEDULE,
        ["-b", "1.3", "-m", "0.4", *flag])
    got, want = _labelled(err), _labelled(jerr)
    assert got.keys() == want.keys() and len(want) >= 4
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-10 * max(abs(value), 1.0), key
    if flag[0] == "-c":
        poles, jpoles = np.asarray(_numbers(out)), np.asarray(_numbers(jout))
        for k in range(3):
            a = (poles[:, 1] * poles[:, 0] ** k).sum()
            b = (jpoles[:, 1] * jpoles[:, 0] ** k).sum()
            assert abs(a - b) <= 1e-10 * max(abs(b), 1.0)


@pytest.mark.parametrize("flag", [[], ["--dos"], ["--beta", "0.8"]],
                         ids=["sq", "dos", "ftlm"])
def test_sqomega_cli_matches_jax(tmp_path, monkeypatch, capsys, flag):
    """S(q, omega) of the 6-site Heisenberg ring at T = 0 and by FTLM (from
    the JAX draws), N(i, omega) of input0's chain."""
    from lanczosplusplus_tpu.cli import sqomega_main as jax_sq
    from lanczosplusplus_tpu_torch.cli import sqomega_main
    _use_jax_draws(monkeypatch)
    text = INPUT0 if flag == ["--dos"] else heisenberg_text(6, 1, 3)
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, sqomega_main.run, jax_sq.run,
        text + "FTLMVectors=3\nFTLMSteps=12\n",
        ["-b", "-1", "-e", "4", "-s", "0.25", "-d", "0.1", *flag])
    _assert_numbers_close(_numbers(out), _numbers(jout), 5e-8)


def test_dynamics1_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from lanczosplusplus_tpu.cli import dynamics1_main as jax_d1
    from lanczosplusplus_tpu_torch.cli import dynamics1_main
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection
    (out, _, pdir), (jout, _, jdir) = _run_both(
        tmp_path, monkeypatch, capsys, dynamics1_main.run, jax_d1.run,
        feas_text(2, 2, "INT_PAPER33", [1.0, 0.5, -0.2, -0.1], 2, 2),
        ["-r", "1"])
    assert out.splitlines()[0] == jout.splitlines()[0]
    omegas = np.linspace(-2, 8, 101)
    vals = []
    for text, where in ((out, pdir), (jout, jdir)):
        (where / "out.comb").write_text(text)
        vals.append(read_collection(str(where / "out.comb"))
                    .evaluate(omegas, 0.1))
    assert np.abs(vals[0] - vals[1]).max() <= 1e-8 * np.abs(vals[1]).max()


def test_qpz_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from lanczosplusplus_tpu.cli import qpz_main as jax_qpz
    from lanczosplusplus_tpu_torch.cli import qpz_main
    text = INPUT0.replace("potentialV 8 0 0 0 0 0 0 0 0",
                          "potentialV 8 0.1 -0.2 0 0.3 0 0 0 0")
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, qpz_main.run, jax_qpz.run, text,
        ["--ratio"])
    _assert_numbers_close(_numbers(out), _numbers(jout), 1e-10)


def test_lorentzian_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from lanczosplusplus_tpu.cli import lorentzian_main as jax_lor
    from lanczosplusplus_tpu_torch.cli import lorentzian_main
    poles = tmp_path / "poles.txt"
    poles.write_text("-1.0 0.5\n0.5 1.0\n2.0 0.25\n")
    outs = []
    for run in (lorentzian_main.run, jax_lor.run):
        run(["-f", str(poles), "-t", "30", "-m", "real", "-e", "0.05"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 30


@pytest.mark.parametrize("cli", ["ed_main", "thermal_main", "sqomega_main",
                                 "dynamics1_main", "qpz_main"])
def test_estimator_clis_without_card_raise(tmp_path, monkeypatch, cli):
    """Each estimator CLI runs on the card by default: without one it
    raises, and never runs on the CPU instead."""
    import importlib
    run = importlib.import_module(f"lanczosplusplus_tpu_torch.cli.{cli}").run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path, hubbard_chain_text(4) + _SCHEDULE)
    extra = {"thermal_main": ["-b", "1.0"],
             "sqomega_main": ["-b", "0", "-e", "1", "-s", "0.5", "-d",
                              "0.1"]}.get(cli, [])
    with pytest.raises(RuntimeError, match="cuda"):
        run(["-f", path, *extra])
