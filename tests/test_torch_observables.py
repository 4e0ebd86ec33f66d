"""The port's static observables and its measurement CLI held against the
JAX package on the CPU in float64, at 6 sites: ``two_point``,
``many_point``, ``measure`` and the reduced density matrix from one shared
ground state to 1e-12, and the CLI's ``-g``, ``-c``, ``-m``, ``-M``, ``-r``
output against the JAX CLI's printed lines and ``.comb`` files on an input
written inline."""

import re

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.cli import lanczos_main as jax_main
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import rahul as jrahul
from lanczosplusplus_tpu.engine.operators import \
    LabeledOperator as JaxLabeledOperator
from lanczosplusplus_tpu.engine.rdm import \
    ReducedDensityMatrix as JaxReducedDensityMatrix
from lanczosplusplus_tpu.engine.spectral import \
    read_collection as jax_read_collection
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.engine import Engine, rahul
from lanczosplusplus_tpu_torch.engine.engine import apply_operator_map
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.rdm import ReducedDensityMatrix
from lanczosplusplus_tpu_torch.engine.spectral import read_collection
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_torch_host import hubbard_chain_text, super_hubbard_text

torch.set_num_threads(2)

# 6-site HubbardOneBand PBC chain U = 4 and 6-site SuperHubbardExtended
# open chain, two states each (Excited=1) for the off-diagonal brakets
CASES = {"chain6": hubbard_chain_text(6) + "Excited=1\n",
         "super6": super_hubbard_text(6) + "Excited=1\n"}
OMEGAS = np.linspace(-8, 8, 81)


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    """(port Engine on the CPU, JAX Engine) holding the same two states."""
    text = CASES[request.param]
    inp, jinp = parse_input(text), jax_parse(text)
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device="cpu"))
    np.testing.assert_allclose(engine._energies, jengine._energies,
                               rtol=0, atol=1e-10)
    engine._energies = np.asarray(jengine._energies)
    engine._vectors = torch.as_tensor(
        np.stack([np.asarray(v) for v in jengine._vectors]))
    return engine, jengine


def _assert_matrix(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("op_name,spin,bra_ket", [
    ("n", (0, 0), (0, 0)), ("n", (0, 1), (0, 0)), ("sz", (0, 0), (0, 0)),
    ("c", (0, 0), (0, 0)), ("c", (1, 1), (0, 0)), ("splus", (0, 0), (0, 0)),
    ("n", (0, 0), (0, 1)), ("c", (0, 0), (1, 0))])
def test_two_point_equal(engines, op_name, spin, bra_ket):
    engine, jengine = engines
    _assert_matrix(engine.two_point(op_name, spin=spin, bra_ket=bra_ket),
                   jengine.two_point(op_name, spin=spin, bra_ket=bra_ket))


def test_two_point_traces(engines):
    """<c^dag_i c_i> sums to N_up, <n_i n_j> over all pairs to N_up^2."""
    engine, _ = engines
    assert abs(np.trace(engine.two_point("c")) - 3) <= 1e-12
    assert abs(engine.two_point("n").sum() - 9) <= 1e-12


def test_two_point_refuses_mixed_spin_sector_change(engines):
    engine, _ = engines
    with pytest.raises(ValueError, match="off-diagonal spin"):
        engine.two_point("c", spin=(0, 1))


@pytest.mark.parametrize("sites,names,spins", [
    ((2, 4), ("splus", "sminus"), (0, 0)),
    ((1, 1), ("sminus", "splus"), (0, 0)),
    ((0, 3), ("c", "cdagger"), (0, 0)),
    ((5, 2), ("n", "n"), (0, 1)),
    ((0,), ("c",), (0,)),                   # leaves the sector: 0
])
def test_many_point_equal(engines, sites, names, spins):
    engine, jengine = engines
    orbs = [0] * len(sites)
    got = engine.many_point(sites, names, spins, orbs)
    ref = jengine.many_point(sites, names, spins, orbs)
    assert abs(got - ref) <= 1e-12
    both = engine.many_point(sites, names, spins, orbs, bra_ket=(1, 0))
    assert abs(both - jengine.many_point(sites, names, spins, orbs,
                                         bra_ket=(1, 0))) <= 1e-12


@pytest.mark.parametrize("spec", [
    "gs|n[0]|gs", "gs|n?1[3]|gs", "gs|sz[2];sz[4]|gs", "P1|n[2]|gs",
    "P1|sz?1[0];n[5]|P1", "gs|identity[0]|gs"])
def test_measure_equal(engines, spec):
    engine, jengine = engines
    assert abs(engine.measure(spec) - jengine.measure(spec)) <= 1e-12


@pytest.mark.parametrize("spec,spin,i,j,bra_ket", [
    ("gs|c'[1];c[3]|gs", 0, 3, 1, (0, 0)),
    ("gs|c?1'[0];c?1[5]|gs", 1, 5, 0, (0, 0)),
    ("gs|c'[2];c[2]|gs", 0, 2, 2, (0, 0)),
    ("P1|c'[4];c[1]|gs", 0, 1, 4, (1, 0))])
def test_measure_fermions_match_two_point(engines, spec, spin, i, j,
                                          bra_ket):
    """<bra| c^dag_j c_i |ket> by the rahul method against ``two_point``
    (which agrees with the JAX package's, above).  The JAX package's own
    rahul method cannot serve here: its ``c`` branch inverts a Python
    bool, which numpy refuses."""
    engine, _ = engines
    ref = engine.two_point("c", spin=(spin, spin), bra_ket=bra_ket)[i, j]
    assert abs(engine.measure(spec) - ref) <= 1e-12


def test_measure_refuses_undressed_braket(engines):
    engine, _ = engines
    with pytest.raises(ValueError, match="dressed"):
        engine.measure("n[0]")


def test_rahul_parsers_equal():
    for token in ("c?1[3]", "n[0]", "c'[2]", "sz?0[5]", "identity"):
        (op, site), (jop, jsite) = (rahul.parse_op_token(token),
                                    jrahul.parse_op_token(token))
        assert (op.label, op.dof, op.transpose, site) == \
            (jop.label, jop.dof, jop.transpose, jsite)
    for level in ("gs", "P3", "2", "<gs|"):
        assert rahul.parse_braket_level(level) == \
            jrahul.parse_braket_level(level)
    with pytest.raises(ValueError):
        rahul.parse_op_token("3c")


@pytest.mark.parametrize("split", [1, 3, 4])
def test_reduced_density_matrix_equal(engines, split):
    engine, jengine = engines
    rdm = ReducedDensityMatrix(engine.basis, engine.eigenvector(0), split)
    jrdm = JaxReducedDensityMatrix(jengine.basis,
                                   np.asarray(jengine.eigenvector(0)), split)
    np.testing.assert_allclose(rdm.rho, jrdm.rho, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rdm.eigs, jrdm.eigs, rtol=0, atol=1e-12)
    assert abs(rdm.eigs.sum() - 1) <= 1e-12
    assert abs(rdm.entanglement_entropy() -
               jrdm.entanglement_entropy()) <= 1e-12


def test_apply_operator_map_equal(engines):
    """One operator's scatter on a tensor against numpy's ``add.at``, with
    a factor, into the N+1 sector."""
    engine, _ = engines
    op = LabeledOperator("cdagger")
    dst = engine._cached_basis(engine.model.has_new_parts(engine.parts, op,
                                                          0, 0))
    tgt, amp, dim = engine.model.operator_map(op, 2, 0, 0, engine.basis, dst)
    vec = engine.eigenvector(0)
    got = apply_operator_map(tgt, amp, dim, vec, factor=-0.5)
    ref = np.zeros(dim)
    mask = tgt >= 0
    np.add.at(ref, tgt[mask], -0.5 * amp[mask] * vec.numpy()[mask])
    assert got.shape == (dim,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)
    z = torch.zeros(dim, dtype=torch.float64)
    engine.acc_modified_state(z, op, dst, vec, engine.basis, 2, 0, 0, -0.5)
    np.testing.assert_array_equal(z.numpy(), got.numpy())


@pytest.mark.parametrize("op_name", ["sz", "n"])
def test_acc_modified_state_dressed_equal(engines, op_name):
    """The twoPoint dressing sz -> (n_up - n_down) / 2, site by site,
    against the JAX package's and against the rows of the batched plan."""
    engine, jengine = engines
    op = LabeledOperator(op_name)
    vec = engine.eigenvector(0)
    _, Z = engine._batched_modified_states(op, engine.basis, vec, 0, 0)
    for site in (0, 4):
        z = torch.zeros(engine.basis.size, dtype=torch.float64)
        engine._acc_modified_state_dressed(z, op, engine.basis, vec,
                                           engine.basis, site, 0, 0, -1.0)
        jz = np.zeros(engine.basis.size)
        jengine._acc_modified_state_dressed(
            jz, JaxLabeledOperator(op_name), jengine.basis, vec.numpy(),
            jengine.basis, site, 0, 0, -1.0)
        np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=1e-14)
        np.testing.assert_allclose(z.numpy(), -Z[site].numpy(), rtol=0,
                                   atol=1e-14)


# -- the command line ------------------------------------------------------

_NUMBER = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


def _numbers(text):
    return np.array([float(x) for x in re.findall(_NUMBER, text)])


def _run_both(tmp_path, monkeypatch, capsys, text, flags):
    """(port stdout, JAX stdout), each CLI run in a directory of its own
    on the same input text."""
    outs = []
    for name, main, extra in (("port", lanczos_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        where = tmp_path / name
        where.mkdir()
        (where / "in.inp").write_text(text)
        monkeypatch.chdir(where)
        main.run(["-f", str(where / "in.inp"), "-p", "12", *flags, *extra])
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_spectral_tspsites_matches_jax_cli(tmp_path, monkeypatch, capsys,
                                               name):
    text = CASES[name] + "TSPSites 2 1 4\nSpectralSteps=300\n"
    out, jout = _run_both(tmp_path, monkeypatch, capsys, text, ["-g", "c"])
    assert "#gf(i=1, j=4)" in out and "#gf(i=1, j=4)" in jout
    comb = (tmp_path / "port" / "in.inp0.comb").read_text()
    jcomb = (tmp_path / "jax" / "in.inp0.comb").read_text()
    head = comb.splitlines()[:4]
    assert head == jcomb.splitlines()[:4]
    assert head[:2] == ["Site0=1", "Site1=4"]
    assert head[2] == "#INDEXTOCF 0,0,0,0 0,1,0,0 0,2,0,0 0,3,0,0"
    assert head[3] == "#CONTINUEDFRACTIONCOLLECTION=4"
    coll = read_collection(str(tmp_path / "port" / "in.inp0.comb"))
    jcoll = jax_read_collection(str(tmp_path / "jax" / "in.inp0.comb"))
    for cf, jcf in zip(coll.items, jcoll.items):
        assert (cf.sigma, cf.meta) == (jcf.sigma, jcf.meta)
        assert abs(cf.weight - jcf.weight) <= 1e-10
        assert abs(cf.e0 - jcf.e0) <= 1e-10
    np.testing.assert_allclose(coll.evaluate(OMEGAS, 0.1),
                               jcoll.evaluate(OMEGAS, 0.1), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("labels,files", [
    ("TSPCenter=2\n", 6), ("DoAllPairs=1\n", 36),
    ("ComputeDensityOfStates=1\n", 6),
    ("TSPCenter=2\nSolverOptions=serialgf\n", 6)])
def test_cli_spectral_fleets_match_jax_cli(tmp_path, monkeypatch, capsys,
                                           labels, files):
    """The batched fleets (and the serial schedule) write the JAX CLI's
    files, one per pair in its order."""
    text = hubbard_chain_text(6).replace("SolverOptions=none\n", "") \
        + ("" if "SolverOptions" in labels else "SolverOptions=none\n") \
        + labels + "SpectralSteps=300\n"
    flags = [] if "Density" in labels else ["-g", "c"]
    out, jout = _run_both(tmp_path, monkeypatch, capsys, text, flags)
    assert [ln for ln in out.splitlines() if ln.startswith(("#gf", "TSP"))] \
        == [ln for ln in jout.splitlines() if ln.startswith(("#gf", "TSP"))]
    written = sorted(p.name for p in (tmp_path / "port").glob("*.comb"))
    assert len(written) == files
    assert written == sorted(p.name
                             for p in (tmp_path / "jax").glob("*.comb"))
    for fname in written[::5]:
        comb = (tmp_path / "port" / fname).read_text().splitlines()
        jcomb = (tmp_path / "jax" / fname).read_text().splitlines()
        keep = ("Site", "TSPCenter", "#INDEXTOCF", "#CONTINUED", "#CFSign",
                "#CFMeta")
        assert [ln for ln in comb if ln.startswith(keep)] == \
            [ln for ln in jcomb if ln.startswith(keep)]
        np.testing.assert_allclose(
            read_collection(str(tmp_path / "port" / fname))
            .evaluate(OMEGAS, 0.1),
            jax_read_collection(str(tmp_path / "jax" / fname))
            .evaluate(OMEGAS, 0.1), rtol=0, atol=1e-8)


def test_cli_tspcenter_and_doallpairs_exclude_each_other(tmp_path,
                                                         monkeypatch):
    text = hubbard_chain_text(6) + "TSPCenter=1\nDoAllPairs=1\n"
    (tmp_path / "in.inp").write_text(text)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="TSPCenter and DoAllPairs"):
        lanczos_main.run(["-f", "in.inp", "-g", "c", "--device", "cpu"])


def test_cli_gf_without_pairs_says_so(tmp_path, monkeypatch, capsys):
    (tmp_path / "in.inp").write_text(hubbard_chain_text(6))
    monkeypatch.chdir(tmp_path)
    lanczos_main.run(["-f", "in.inp", "-g", "c", "--device", "cpu"])
    assert "no spectral pairs to run" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.comb"))


@pytest.mark.parametrize("flags,lines", [
    (["-c", "n"], 6), (["-c", "sz"], 6), (["-c", "c", "-s", "1,1"], 6),
    (["-m", "gs|n[0]|gs,gs|sz[1];sz[2]|gs", "-m", "P1|sz[3]|gs"], 3),
    (["-M", "n?0?0;n?1?1,splus?2?0;sminus?4?0"], 2),
])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_static_observables_match_jax_cli(tmp_path, monkeypatch, capsys,
                                              name, flags, lines):
    """-c, -m and -M print the JAX CLI's lines: the same text around the
    numbers, and the numbers to 1e-10."""
    out, jout = _run_both(tmp_path, monkeypatch, capsys, CASES[name], flags)
    tail, jtail = (o.split("norm=")[-1].splitlines()[1:] for o in (out, jout))
    assert len(tail) == len(jtail)
    if flags[0] == "-c":   # one 6 x 6 matrix, rows wrapped and padded
        assert len(_numbers("\n".join(tail))) == 36
    else:
        assert len(tail) == lines
        assert [re.sub(_NUMBER, "#", ln) for ln in tail] == \
            [re.sub(_NUMBER, "#", ln) for ln in jtail]
    np.testing.assert_allclose(_numbers("\n".join(tail)),
                               _numbers("\n".join(jtail)), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_reduced_density_matrix_matches_jax_cli(tmp_path, monkeypatch,
                                                    capsys, name):
    out, jout = _run_both(tmp_path, monkeypatch, capsys, CASES[name],
                          ["-r", "2"])
    for title in ("Reduced Density Matrix\n",
                  "Eigenvectors of Reduced Density Matrix\n",
                  "Eigenvalues of Reduced Density Matrix\n",
                  "EntanglementEntropy="):
        assert title in out and title in jout

    def block(text, start, end):
        return _numbers(text.split(start)[1].split(end)[0])

    for start, end in (("Reduced Density Matrix\n", "Eigenvectors of"),
                       ("Eigenvalues of Reduced Density Matrix\n",
                        "EntanglementEntropy="),
                       ("EntanglementEntropy=", "\n")):
        got, ref = block(out, start, end), block(jout, start, end)
        assert got.shape == ref.shape and got.size > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_cli_energy_lines_unchanged_by_measurements(tmp_path, monkeypatch,
                                                    capsys):
    out, jout = _run_both(tmp_path, monkeypatch, capsys, CASES["chain6"],
                          ["-c", "n"])
    for o in (out, jout):
        assert re.search(r"^Energy=-3\.6687061788", o, re.M)
        assert len(re.findall(r"^E\[\d\]=", o, re.M)) == 2
