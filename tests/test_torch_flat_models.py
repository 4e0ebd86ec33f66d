"""The port's flat models (Heisenberg, Kitaev, t-J, Rashba, FeAs in every
FeAsMode, FeAs spin-orbit, Immm, the spin-orbital chain) held against the
JAX package on the CPU in float64 / complex128: equal basis words and
ranks, equal dense matrices (1e-13), equal matvecs of one seeded vector
(1e-12), equal ground-state energies (1e-10), equal operator maps and
sector bookkeeping, the same numbers through both command lines (1e-8),
and the TestSuite goldens through the port's command line.  The port runs
the plain versions of its kernels here; the JAX package runs as its own
tests run it on the CPU."""

import json
import os
import re

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.cli import lanczos_main as jax_lanczos_main
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import operators as jax_ops
from lanczosplusplus_tpu.engine import rahul as jax_rahul
from lanczosplusplus_tpu.engine.rdm import (
    ReducedDensityMatrix as JaxReducedDensityMatrix)
from lanczosplusplus_tpu.engine.spectral import (
    read_collection as jax_read_collection)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_check import (
    validate_input as jax_validate_input)
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models.spin_orbital import (
    build_spin_orbital as jax_build_spin_orbital)
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.core.sparse import hamiltonian_from_numpy
from lanczosplusplus_tpu_torch.engine import Engine, rahul
from lanczosplusplus_tpu_torch.engine import operators as ops
from lanczosplusplus_tpu_torch.engine.rdm import ReducedDensityMatrix
from lanczosplusplus_tpu_torch.engine.spectral import read_collection
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.spin_orbital import build_spin_orbital
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_inputs import (INPUT10, INPUT100, INPUT104, TJ8,
                                feas_jterms_text,
                                feas_so_text, feas_text, heisenberg_text,
                                immm_text, kitaev_text, rashba_text,
                                tj_text, tj_two_orbital_text)

torch.set_num_threads(2)

CPU = Config(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "benchmarks", "goldens.json")) as _f:
    GOLDENS = json.load(_f)


# name -> input text; sizes of 4 to 8 sites, dims from 20 to 924
CASES = {
    "heisenberg_half": heisenberg_text(
        8, 1, 4, extra="MagneticField 8 0.1 0 0.2 0 0 0 0 0.05\n"),
    "heisenberg_one": heisenberg_text(
        5, 2, 4, j=0.8, periodic=0,
        extra="AnisotropyD 5 0.3 0.3 0.1 0.3 0.3\n"),
    "heisenberg_three_halves": heisenberg_text(4, 3, 5, periodic=0),
    "kitaev": kitaev_text(6, 1.0, 0.6, 0.8, periodic=1,
                          extra="MagneticField 6 0.1 0.2 0 0 0.3 0\n"),
    "tj": tj_text(6, 2, 2, j=0.4, w=-0.1),
    "tj_ring": tj_text(6, 3, 2, j=0.3, periodic=1),
    "tj_two_orbitals": tj_two_orbital_text(3, 2, 1),
    "tj_jhund": tj_two_orbital_text(2, 1, 1, jhund=1),
    "rashba": rashba_text(4, 2),
    "rashba_ring_complex": rashba_text(5, 3, r="(0.3,0.4)", periodic=1,
                                       options="useComplex"),
    "feas_paper33": feas_text(3, 2, "INT_PAPER33",
                              [1.0, 0.6, -0.2, -0.1], 2, 2,
                              extra="AnisotropyD=0.4\n"),
    "feas_paper33_complex": feas_text(2, 2, "INT_PAPER33",
                                      [1.0, 0.6, -0.2, -0.1, 0.3, 0.05], 2,
                                      1, options="useComplex"),
    "feas_jterms": feas_jterms_text(3, 2, 1),
    "feas_impurity": feas_text(1, 3, "INT_IMPURITY",
                               [1.0, 0.5, 0.0, 0.3, 0.2], 2, 1),
    "feas_kspace": feas_text(1, 4, "INT_KSPACE", [0.9], 2, 2),
    "feas_int_v": feas_text(2, 3, "INT_V",
                            [1.0, 0.2, 0.3, 0.2, 0.8, 0.1, 0.3, 0.1, 0.6],
                            2, 2, extra="CoulombV=0.0\n"),
    "feas_code2": feas_text(2, 2, "INT_CODE2",
                            [1.0, 0.2, 0.2, 0.8, 0.1, 0.3, 0.3, 0.6], 2, 1),
    "feas_spinorbit": feas_so_text(2, 1, 1),
    "feas_spinorbit_three": feas_so_text(2, 2, 1,
                                         extra="AnisotropyD=0.2\n"),
    "immm": immm_text(4, 2, 2),
    "immm_ktwoniffour": immm_text(6, 2, 2, kind="ktwoniffour"),
}
NAMES = sorted(CASES)


def _both_models(name):
    inp, jinp = parse_input(CASES[name]), jax_parse(CASES[name])
    return (inp, build_model(inp, Geometry(inp)),
            jinp, jax_build_model(jinp, JaxGeometry(jinp)))


def _np_dtype(inp):
    return (np.complex128 if "useComplex" in inp.solver_options()
            else np.float64)


def _both_hamiltonians(name):
    """(port model, port basis, port Hamiltonian on the CPU, JAX model,
    JAX basis, JAX Hamiltonian) of the input's own sector."""
    inp, model, jinp, jmodel = _both_models(name)
    parts = model.default_parts(inp)
    assert parts == jmodel.default_parts(jinp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    ham = model.hamiltonian(basis, dtype=Config.from_input(
        inp, device="cpu").scalar_dtype, device="cpu")
    jham = jmodel.hamiltonian(jbasis, dtype=_np_dtype(jinp))
    return model, basis, ham, jmodel, jbasis, jham


def _word_arrays(basis):
    """Every word array and one-spin sub-basis a basis holds, by name."""
    out = {}
    for attr in ("words", "up_words", "dn_words", "key", "digits"):
        if hasattr(basis, attr):
            out[attr] = np.asarray(getattr(basis, attr))
    for attr in ("up", "down"):
        if hasattr(basis, attr):
            out[attr + ".words"] = np.asarray(getattr(basis, attr).words)
    if hasattr(basis, "blocks"):
        for k, blk in enumerate(basis.blocks):
            if blk is not None:
                out[f"block{k}.up"] = blk[0].words
                out[f"block{k}.down"] = blk[1].words
                out[f"block{k}.offset"] = np.asarray(blk[2])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_basis_words_and_ranks(name):
    inp, model, jinp, jmodel = _both_models(name)
    parts = model.default_parts(inp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    assert basis.size == jbasis.size and basis.size > 1
    assert basis.parts == jbasis.parts
    got, want = _word_arrays(basis), _word_arrays(jbasis)
    assert sorted(got) == sorted(want) and got
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    idx = np.arange(basis.size)
    if hasattr(basis, "up_words"):      # combined-word bases
        np.testing.assert_array_equal(
            basis.rank(basis.up_words, basis.dn_words), idx)
        np.testing.assert_array_equal(
            jbasis.rank(jbasis.up_words, jbasis.dn_words), idx)
    elif hasattr(basis, "up"):          # product bases
        for one, jone in ((basis.up, jbasis.up), (basis.down, jbasis.down)):
            np.testing.assert_array_equal(one.rank(one.words),
                                          jone.rank(jone.words))
            np.testing.assert_array_equal(one.rank(one.words),
                                          np.arange(one.size))
    elif hasattr(basis, "rank"):        # one-word bases
        np.testing.assert_array_equal(basis.rank(basis.words), idx)
        np.testing.assert_array_equal(jbasis.rank(jbasis.words), idx)


@pytest.mark.parametrize("name", NAMES)
def test_to_dense_equal(name):
    _, _, ham, _, _, jham = _both_hamiltonians(name)
    dense, jdense = ham.to_dense(), np.asarray(jham.to_dense())
    assert dense.shape == jdense.shape and dense.dtype == jdense.dtype
    scale = max(np.abs(jdense).max(), 1.0)
    assert np.abs(dense - jdense).max() <= 1e-13 * scale
    assert np.abs(dense - dense.conj().T).max() <= 1e-12 * scale


def _seeded(dim, complex_, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dim)
    return x + 1j * rng.standard_normal(dim) if complex_ else x


@pytest.mark.parametrize("name", NAMES)
def test_matvec_equal(name):
    _, _, ham, _, _, jham = _both_hamiltonians(name)
    x = _seeded(ham.dim, ham.dtype.is_complex)
    want = np.asarray(jham.matvec(x))
    got = ham.matvec(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the densified form, and a batch-major block of three states
    dense_form = ham.densify_factors()
    assert (dense_form is ham) == (ham.factorized is None)
    got = dense_form.matvec(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    block = torch.as_tensor(np.stack([x, 2 * x, x[::-1].copy()]))
    got = dense_form.matmat_t(block)
    assert np.abs(got[0].numpy() - want).max() <= 1e-12 * np.abs(want).max()
    torch.testing.assert_close(got[2], ham.matvec(block[2]), rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_hamiltonian_from_the_jax_arrays(name):
    """The JAX package's own arrays, pulled out as numpy and carried
    across, give the port's plain kernels the same matvec."""
    _, _, ham, _, _, jham = _both_hamiltonians(name)
    f, ell = jham.factorized, jham.ell

    def pull(obj, attr):
        return None if obj is None else np.asarray(getattr(obj, attr))
    carried = hamiltonian_from_numpy(
        np.asarray(jham.diag), pull(ell, "cols"), pull(ell, "vals"),
        pull(f, "up_cols"), pull(f, "up_vals"), pull(f, "dn_cols"),
        pull(f, "dn_vals"), jham.spin_shape, device="cpu", dtype=ham.dtype)
    assert carried.dtype == ham.dtype
    assert (carried.ell is None) == (ell is None)
    assert (carried.factorized is None) == (f is None)
    x = _seeded(ham.dim, ham.dtype.is_complex, seed=9)
    want = np.asarray(jham.matvec(x))
    got = carried.densify_factors().matvec(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_e0_equal(name):
    inp, model, jinp, jmodel = _both_models(name)
    engine = Engine(model, inp, config=Config.from_input(inp, device="cpu"))
    jengine = JaxEngine(jmodel, jinp)
    assert abs(engine.ground_energy - jengine.ground_energy) <= \
        1e-10 * max(abs(jengine.ground_energy), 1.0)
    dense = np.linalg.eigvalsh(engine.hamiltonian.to_dense())
    assert abs(engine.ground_energy - dense[0]) <= 1e-9
    assert engine.eigenvector(0).dtype == engine.hamiltonian.dtype


# operator, spin, orb for every case; a model that does not know one
# raises the same exception type in both packages
_OPERATORS = [("c", 0, 0), ("c", 1, 0), ("cdagger", 0, 0), ("cdagger", 1, 1),
              ("n", 0, 0), ("n", 1, 1), ("sz", 0, 0), ("splus", 0, 0),
              ("sminus", 0, 0), ("sminus", 1, 0), ("nil", 0, 0)]


def _outcome(fn):
    try:
        return fn()
    except (ValueError, NotImplementedError, IndexError) as err:
        return type(err)


@pytest.mark.parametrize("name", NAMES)
def test_operator_maps_and_new_parts_equal(name):
    inp, model, jinp, jmodel = _both_models(name)
    parts = model.default_parts(inp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    nsite = model.geometry.number_of_sites()
    assert model.is_fermionic == jmodel.is_fermionic
    assert [model.orbitals(s) for s in range(nsite)] == \
        [jmodel.orbitals(s) for s in range(nsite)]
    compared = 0
    for op_name, spin, orb in _OPERATORS:
        op, jop = ops.LabeledOperator(op_name), \
            jax_ops.LabeledOperator(op_name)
        new = _outcome(lambda: model.has_new_parts(parts, op, spin, orb))
        jnew = _outcome(lambda: jmodel.has_new_parts(parts, jop, spin, orb))
        assert new == jnew, (op_name, spin, orb)
        if new is None or isinstance(new, type) or op_name == "nil":
            continue
        if orb >= min(model.orbitals(s) for s in range(nsite)):
            continue
        dst = _outcome(lambda: model.create_basis(new))
        jdst = _outcome(lambda: jmodel.create_basis(new))
        if isinstance(jdst, type):  # a sector neither package enumerates
            assert dst is jdst, (op_name, spin, orb)
            continue
        for site in (0, nsite - 1):
            got = _outcome(lambda: model.operator_map(
                op, site, spin, orb, basis, dst))
            want = _outcome(lambda: jmodel.operator_map(
                jop, site, spin, orb, jbasis, jdst))
            if isinstance(want, type):
                assert got is want, (op_name, spin, orb)
                compared += 1
                continue
            assert got[2] == want[2] == dst.size
            alive = want[0] >= 0
            np.testing.assert_array_equal(got[0] >= 0, alive)
            np.testing.assert_array_equal(got[0][alive], want[0][alive])
            np.testing.assert_array_equal(got[1][alive], want[1][alive])
            compared += 1
    assert compared > 0 or name == "kitaev"


# -- the command lines -----------------------------------------------------

def _run_both(tmp_path, monkeypatch, capsys, text, argv):
    """The same input and flags through the port's command line on the CPU
    and the JAX package's: (port engine, port stdout, port .comb
    collections, JAX engine, JAX stdout, JAX .comb collections)."""
    out = []
    for sub, main, extra, read in (
            ("port", lanczos_main, ["--device", "cpu"], read_collection),
            ("jax", jax_lanczos_main, [], jax_read_collection)):
        cwd = tmp_path / sub
        cwd.mkdir()
        (cwd / "input.inp").write_text(text)
        monkeypatch.chdir(cwd)
        engine = main.run(["-f", str(cwd / "input.inp"), "-p", "15",
                           *extra, *argv])
        combs = []
        while (cwd / f"input.inp{len(combs)}.comb").exists():
            combs.append(read(str(cwd / f"input.inp{len(combs)}.comb")))
        out += [engine, capsys.readouterr().out, combs]
    return out


def _numbers(text):
    return np.array([float(x) for x in re.findall(
        r"(?<![\w.])[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?(?![\w.])", text)])


# -g runs where the model changes sector under the operator; SpectralSteps
# exhausts the destination sectors, so the fractions are compared as
# functions (plain Lanczos coefficients amplify rounding)
_GF_CASES = {
    "heisenberg_half": (heisenberg_text(6, 1, 3), ["-g", "sz"]),
    "heisenberg_splus": (heisenberg_text(6, 1, 3), ["-g", "splus"]),
    "tj": (tj_text(6, 2, 2, j=0.4, w=-0.1), ["-g", "c"]),
    "feas_paper33": (feas_text(2, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1],
                               1, 1), ["-g", "c"]),
    "immm": (immm_text(2, 1, 1), ["-g", "c"]),
}


@pytest.mark.parametrize("name", sorted(_GF_CASES))
def test_cli_spectral_function_equal(tmp_path, monkeypatch, capsys, name):
    text, argv = _GF_CASES[name]
    text += "TSPSites 2 0 1\nSpectralSteps=400\n"
    engine, _, combs, jengine, _, jcombs = _run_both(
        tmp_path, monkeypatch, capsys, text, argv)
    assert len(combs) == len(jcombs) == 1
    assert [cf.meta for cf in combs[0].items] == \
        [cf.meta for cf in jcombs[0].items]
    omegas = np.linspace(-6.0, 8.0, 57)
    got = combs[0].evaluate(omegas, 0.25)
    want = jcombs[0].evaluate(omegas, 0.25)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


_STATIC_CASES = {
    "heisenberg_c_sz": ("heisenberg_half", ["-c", "sz"]),
    "heisenberg_r": ("heisenberg_half", ["-r", "3"]),
    "tj_c_n": ("tj", ["-c", "n"]),
    "tj_c_c": ("tj", ["-c", "c"]),
    "tj_m": ("tj", ["-m", "gs|n?0[1]|gs,gs|sz?1[2];n?0[3]|gs"]),
    "tj_M": ("tj", ["-M", "n?0?0;n?1?0"]),
    "tj_r": ("tj", ["-r", "3"]),
    "rashba_c_n": ("rashba", ["-c", "n"]),
    "rashba_complex_c_sz": ("rashba_ring_complex", ["-c", "sz"]),
    "feas_c_n": ("feas_paper33", ["-c", "n"]),
    "feas_m": ("feas_paper33", ["-m", "gs|n?1[2]|gs"]),
    "feas_spinorbit_c_n": ("feas_spinorbit", ["-c", "n"]),
    "immm_c_n": ("immm", ["-c", "n"]),
}


@pytest.mark.parametrize("name", sorted(_STATIC_CASES))
def test_cli_static_observable_equal(tmp_path, monkeypatch, capsys, name):
    case, argv = _STATIC_CASES[name]
    engine, out, _, jengine, jout, _ = _run_both(
        tmp_path, monkeypatch, capsys, CASES[case], argv)
    assert abs(engine.ground_energy - jengine.ground_energy) <= 1e-10
    if argv[0] == "-r":     # the eigenvectors' signs are the library's
        out, jout = (o.split("Eigenvectors of")[0]
                     + o.split("Eigenvalues of")[1] for o in (out, jout))
    got, want = _numbers(out), _numbers(jout)
    assert got.shape == want.shape and got.size > 4
    assert np.abs(got - want).max() <= 1e-8 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("name,text,golden", [
    ("input10", INPUT10, "e0_input10"), ("input100", INPUT100, "e0_input100"),
    ("input104", INPUT104, "e0_input104")])
def test_cli_reaches_the_golden(tmp_path, capsys, name, text, golden):
    path = tmp_path / f"{name}.inp"
    path.write_text(text)
    engine = lanczos_main.run(["-f", str(path), "-p", "17", "--device",
                               "cpu"])
    energy = float(re.search(r"^Energy=(\S+)$", capsys.readouterr().out,
                             re.M).group(1))
    assert abs(energy - GOLDENS[golden]) <= 1e-10 * abs(GOLDENS[golden])
    assert engine.eigenvector(0).dtype == torch.complex128
    if name != "input10":
        assert engine.basis.size == GOLDENS["dim_input100"]


def test_tj_green_function_reaches_the_golden(tmp_path, monkeypatch):
    """G_00(omega) of the 8-site t-J ring against the dense Lehmann sum
    of goldens.json."""
    monkeypatch.chdir(tmp_path)
    inp = parse_input(TJ8)
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    coll, _ = engine.spectral_function("c", 0, 0, spin=0)
    got = coll.evaluate(np.asarray(GOLDENS["gf_tj_omegas"]),
                        GOLDENS["gf_tj_delta"])
    want = np.asarray(GOLDENS["gf_tj_re"]) + 1j * np.asarray(
        GOLDENS["gf_tj_im"])
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_inputs_validate_alike(name):
    inp, jinp = parse_input(CASES[name]), jax_parse(CASES[name])
    assert _outcome(lambda: validate_input(inp)) == \
        _outcome(lambda: jax_validate_input(jinp))


# -- the combined-word branches of rahul and rdm -------------------------

@pytest.mark.parametrize("name,spec", [
    ("tj", "n?0[1]"), ("tj", "sz?0[2];n?1[4]"), ("tj_ring", "n?1[3];sz?1[0]"),
    ("feas_spinorbit", "n?0[1];sz?1[2]"), ("feas_paper33", "n?1[2]"),
    ("immm", "n?1[2];n?0[4]")])
def test_rahul_apply_equal(name, spec):
    inp, model, jinp, jmodel = _both_models(name)
    parts = model.default_parts(inp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    psi = _seeded(basis.size, True, seed=11)
    parsed = [rahul.parse_op_token(t) for t in spec.split(";")]
    jparsed = [jax_rahul.parse_op_token(t) for t in spec.split(";")]
    got = rahul.rahul_apply(basis, [p[0] for p in parsed],
                            [p[1] for p in parsed], psi)
    want = np.asarray(jax_rahul.rahul_apply(
        jbasis, [p[0] for p in jparsed], [p[1] for p in jparsed], psi))
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-13


@pytest.mark.parametrize("name,spin,i,j", [
    ("tj", 0, 1, 2), ("tj", 1, 3, 0), ("tj_ring", 0, 5, 0),
    ("tj_ring", 1, 2, 2)])
def test_measure_fermions_match_two_point(name, spin, i, j):
    """<gs| c^dag_j c_i |gs> by the rahul method on a combined-word basis
    (operator strings that leave the constrained space are dropped)
    against ``two_point``, which is held against the JAX package's through
    the command lines above.  The JAX package's own rahul method cannot
    serve: its ``c`` branch inverts a Python bool, which numpy refuses."""
    inp, model, _, _ = _both_models(name)
    engine = Engine(model, inp, config=CPU)
    ref = engine.two_point("c", spin=(spin, spin))[i, j]
    got = engine.measure(f"gs|c?{spin}'[{j}];c?{spin}[{i}]|gs")
    assert abs(ref) > 1e-3
    assert abs(got - ref) <= 1e-12


@pytest.mark.parametrize("name,split", [
    ("heisenberg_half", 4), ("heisenberg_one", 2),
    ("heisenberg_three_halves", 1), ("tj", 3), ("tj_ring", 2),
    ("tj_two_orbitals", 3)])
def test_reduced_density_matrix_equal(name, split):
    inp, model, jinp, jmodel = _both_models(name)
    parts = model.default_parts(inp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    psi = _seeded(basis.size, True, seed=13)
    psi /= np.linalg.norm(psi)
    got = ReducedDensityMatrix(basis, torch.as_tensor(psi), split)
    want = JaxReducedDensityMatrix(jbasis, psi, split)
    assert got.rho.shape == want.rho.shape
    assert np.abs(got.rho - np.asarray(want.rho)).max() <= 1e-13
    assert abs(np.trace(got.rho).real - 1.0) <= 1e-12


# -- the spin-orbital chain -------------------------------------------------

@pytest.mark.parametrize("nsites,twice_j", [(2, 1), (3, 1), (2, 2), (3, 2),
                                            (2, 3)])
def test_spin_orbital_chain_equal(nsites, twice_j):
    ham = build_spin_orbital(nsites, twice_j, dtype=torch.float64,
                             device="cpu")
    jham = jax_build_spin_orbital(nsites, twice_j, dtype=np.float64)
    dense, jdense = ham.to_dense(), np.asarray(jham.to_dense())
    assert np.abs(dense - jdense).max() <= 1e-13 * np.abs(jdense).max()
    x = _seeded(ham.dim, False)
    want = np.asarray(jham.matvec(x))
    assert np.abs(ham.matvec(torch.as_tensor(x)).numpy() - want).max() \
        <= 1e-12 * np.abs(want).max()
    if twice_j < 3:     # hermitian: a ground state exists
        evals, _ = lz.lowest_states(ham, seed=3)
        assert abs(evals[0] - np.linalg.eigvalsh(jdense)[0]) <= 1e-10


# -- bookkeeping the Engine relies on --------------------------------------

def test_kitaev_basis_is_cached_under_its_parts():
    inp = parse_input(CASES["kitaev"])
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    assert engine.parts == ("full",)
    assert engine._cached_basis(engine.parts) is engine.basis
    assert engine._cached_hamiltonian(engine.parts) is engine.hamiltonian
    assert engine._cached_dense_hamiltonian(engine.parts) is \
        engine.hamiltonian


def test_spinorbit_solve_is_complex_whatever_the_input_asks():
    """The model forces a complex Hamiltonian; the start vector, the
    Krylov basis and the eigenvector follow it, not the input's options."""
    inp = parse_input(CASES["feas_spinorbit"])
    config = Config.from_input(inp, device="cpu")
    assert config.scalar_dtype == torch.float64
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=config)
    assert engine.hamiltonian.dtype == torch.complex128
    assert engine.hamiltonian.diag.dtype == torch.complex128
    assert engine.eigenvector(0).dtype == torch.complex128
    res = lz.tridiagonalize(engine.hamiltonian,
                            np.ones(engine.basis.size), 5)
    assert res.V.dtype == torch.complex128
