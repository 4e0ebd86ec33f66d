"""The port's symmetry sectors held against the JAX package on the CPU in
float64, at the sizes of the JAX package's own symmetry tests
(tests/test_symmetry.py, tests/test_projected.py).

For every case: the same form feeds the rows, the same sector count and
block dims, each block's dense matrix equal to JAX's (1e-12 absolute: both
take orbits in ``np.unique`` order), each block's matvec through the plain
``ell_spmv`` equal to JAX's block matvec (1e-13 of max |y|), and the union
of the block spectra equal to the flat sector's (1e-9).  The Engine with
the symmetry labels against the JAX Engine: energies 1e-10 relative, the
same minimum sector (or its mirror -k, whose spectrum is the same), the
eigenvector a solution of the full H (1e-7).  Then the transform, a JAX
block through the port's solver, the explicit error when no sector is
non-empty, the projected Kitaev path, the CLI's ``Energy=`` and what runs
after a solve whose minimum sector is complex."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu import symmetry as jax_symmetry
from lanczosplusplus_tpu.cli import lanczos_main as jax_main
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine.spectral import (
    read_collection as jax_read_collection)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models.kitaev_factored import (
    build_factored_kitaev as jax_build_factored_kitaev)
from lanczosplusplus_tpu.solver import lanczos as jax_lz
from lanczosplusplus_tpu.symmetry.projected import (
    ProjectedTranslationSolver as JaxProjected)
from lanczosplusplus_tpu_torch import Config, symmetry
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.core.sparse import hamiltonian_from_numpy
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.spectral import read_collection
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    build_factored_kitaev)
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.symmetry.projected import (
    ProjectedTranslationSolver, rotation_weights)
from chip_smoke import hubbard_chain_text
from test_torch_inputs import _term, heisenberg_text, kitaev_text

torch.set_num_threads(2)

CPU = Config(device="cpu")

TJ = ("TotalNumberOfSites=6\nNumberOfTerms=4\n"
      + "".join(_term(v) for v in (-1.0, 0.3, 0.3, 0.0))
      + "Model=TjMultiOrb\nOrbitals=1\nSolverOptions=none\n"
        "TargetElectronsUp=2\nTargetElectronsDown=2\nIsPeriodicX=1\n")
RASHBA = ("TotalNumberOfSites=6\nNumberOfTerms=2\n" + _term(-1.0)
          + _term(0.5) + "Model=HubbardOneBandRashbaSOC\n"
          "hubbardU 6 4 4 4 4 4 4\n"
          "potentialV 12 0 0 0 0 0 0 0 0 0 0 0 0\nSolverOptions=none\n"
          "TargetElectronsTotal=5\nIsPeriodicX=1\n")
FEAS = ("TotalNumberOfSites=4\nModel=FeAsBasedSc\nFeAsMode=INT_PAPER33\n"
        "NumberOfTerms=1\nDegreesOfFreedom=2\nOrbitals=2\n"
        "GeometryKind=chain\nGeometryOptions=ConstantValues\n"
        "SolverOptions=none\n"
        "hubbardU 4 4.0 3.0 -0.8 -0.4\nConnectors 2 2\n-1.0 0.2\n"
        "0.2 -1.0\n"
        "potentialV 16 " + " ".join(["0.3"] * 16) + "\n"
        "TargetElectronsUp=2\nTargetElectronsDown=2\nIsPeriodicX=1\n")

# name -> (input text, symmetry label appended for the Engine)
TRANSLATION = "UseTranslationSymmetry=1\n"
REFLECTION = "UseReflectionSymmetry=1\n"
LADDER = "UseTranslationSymmetry=2\n"
CASES = {
    "hubbard4 translation": (hubbard_chain_text(4, 4, 2, 2), TRANSLATION),
    "heisenberg8 translation": (heisenberg_text(8, 1, 4), TRANSLATION),
    "tj6 translation": (TJ, TRANSLATION),
    "rashba6 translation": (RASHBA, TRANSLATION),
    "feas4 translation": (FEAS, TRANSLATION),
    "kitaev8 translation": (kitaev_text(8, 1.1, 0.7, 0.9, periodic=1),
                            TRANSLATION),
    "hubbard4 reflection": (hubbard_chain_text(4, 4, 2, 2, periodic=0),
                            REFLECTION),
    "feas4 reflection": (FEAS.replace("IsPeriodicX=1", "IsPeriodicX=0")
                         .replace("0.3 " * 15 + "0.3", "0 " * 15 + "0"),
                         REFLECTION),
    "rashba6 reflection": (RASHBA.replace("IsPeriodicX=1", "IsPeriodicX=0"),
                           REFLECTION),
    "hubbard8 ladder": (hubbard_chain_text(8, 4, 2, 2, ladder=True), LADDER),
}


def _both(text):
    """(JAX model, basis), (port model, basis) of one input text."""
    jinp = jax_parse(text)
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    return ((jmodel, jmodel.create_basis(jmodel.default_parts(jinp))),
            (model, model.create_basis(model.default_parts(inp))))


def _symmetries(name):
    """The JAX package's and the port's symmetry of one case (blocks on the
    CPU)."""
    text, label = CASES[name]
    (jmodel, jbasis), (model, basis) = _both(text)
    fermionic = model.is_fermionic
    if label == REFLECTION:
        return (jax_symmetry.ReflectionSymmetry(
                    jbasis, jmodel.geometry, jmodel, fermionic),
                symmetry.ReflectionSymmetry(basis, model.geometry, model,
                                            fermionic), model, basis)
    use_y = label == LADDER
    return (jax_symmetry.TranslationSymmetry(
                jbasis, jmodel.geometry, jmodel, fermionic, use_y=use_y),
            symmetry.TranslationSymmetry(basis, model.geometry, model,
                                         fermionic, use_y=use_y),
            model, basis)


def _rel(got, want) -> float:
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-300)


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_match_jax(name):
    jsym, sym, model, basis = _symmetries(name)
    assert type(sym._ham).__name__ == type(jsym._ham).__name__
    assert sym.sectors() == jsym.sectors()
    rng = np.random.default_rng(5)
    spectra = []
    for s in range(sym.sectors()):
        jblk, blk = jsym.block_hamiltonian(s), sym.block_hamiltonian(s)
        assert (blk is None) == (jblk is None), s
        if blk is None:
            continue
        assert blk.dim == jblk.dim, s
        assert blk.dtype.is_complex == jnp.iscomplexobj(jblk.diag), s
        assert blk.ell.cols.dtype == torch.int32
        dense = blk.to_dense()
        assert np.abs(dense - np.asarray(jblk.to_dense())).max() <= 1e-12, s
        x = rng.standard_normal(blk.dim)
        if blk.dtype.is_complex:
            x = x + 1j * rng.standard_normal(blk.dim)
        got = blk.matvec(torch.as_tensor(x).to(blk.dtype)).numpy()
        assert _rel(got, jblk.matvec(jnp.asarray(x))) <= 1e-13, s
        spectra.append(np.linalg.eigvalsh(dense))
    full = np.linalg.eigvalsh(model.hamiltonian(basis).to_dense())
    np.testing.assert_allclose(np.sort(np.concatenate(spectra)), full,
                               atol=1e-9)


def _minimum_sectors(jsym):
    """The sectors whose lowest block eigenvalue is the minimum over all
    sectors (1e-10 relative), from the JAX blocks, densely: k and -k are
    degenerate for a real H, and a lattice may make other sectors so, so
    which of them a solve reports is a matter of rounding."""
    e0 = {}
    for s in range(jsym.sectors()):
        blk = jsym.block_hamiltonian(s)
        if blk is not None:
            e0[s] = np.linalg.eigvalsh(np.asarray(blk.to_dense()))[0]
    low = min(e0.values())
    return {s for s, e in e0.items() if abs(e - low) <= 1e-10 * abs(low)}


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_engine(name):
    """Energies 1e-10, the minimum sector (the port's and JAX's both among
    the sectors whose lowest level is the minimum), the eigenvector an
    eigenvector of the full sector Hamiltonian, and the winner's SolveInfo
    kept."""
    text, label = CASES[name]
    jinp = jax_parse(text + label)
    jeng = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    inp = parse_input(text + label)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    assert _rel(eng.ground_energy, jeng.ground_energy) <= 1e-10
    lowest = _minimum_sectors(_symmetries(name)[0])
    assert {eng.solve_sector, jeng.solve_sector} <= lowest
    assert eng.solve_info.converged or eng.solve_info.used_dense_fallback
    v = eng.eigenvector(0).numpy()
    assert abs(np.linalg.norm(v) - 1.0) <= 1e-10
    resid = np.linalg.norm(eng.hamiltonian.to_dense() @ v
                           - eng.ground_energy * v)
    assert resid <= 1e-7


@pytest.mark.parametrize("name", ["hubbard4 translation",
                                  "hubbard4 reflection", "hubbard8 ladder",
                                  "rashba6 translation"])
def test_transform_round_trip(name):
    """transform() equals JAX's on the same sector vector and keeps its
    norm, and a block eigenvector comes back as an eigenvector of the full
    sector Hamiltonian."""
    jsym, sym, model, basis = _symmetries(name)
    full = model.hamiltonian(basis).to_dense()
    rng = np.random.default_rng(9)
    for s in range(sym.sectors()):
        blk = sym.block_hamiltonian(s)
        if blk is None:
            continue
        c = rng.standard_normal(blk.dim) + 1j * rng.standard_normal(blk.dim)
        psi = sym.transform(c, s)
        assert np.abs(psi - jsym.transform(c, s)).max() <= 1e-12, s
        assert abs(np.linalg.norm(psi) - np.linalg.norm(c)) <= 1e-10, s
        evals, vecs = np.linalg.eigh(blk.to_dense())
        psi = sym.transform(vecs[:, 0], s)
        resid = np.linalg.norm(full @ psi - evals[0] * psi)
        assert resid <= 1e-7, (s, resid)


def test_jax_blocks_through_the_port_solver():
    """Each JAX momentum block of the 8-site ladder (dims 24-52, both
    types), carried across by hamiltonian_from_numpy, solves through the
    port's lowest_states to JAX's lowest_states energy (1e-10): the two
    solvers on one operator."""
    jsym = _symmetries("hubbard8 ladder")[0]
    kinds = set()
    for s in range(jsym.sectors()):
        jblk = jsym.block_hamiltonian(s)
        cplx = jnp.iscomplexobj(jblk.diag)
        kinds.add(cplx)
        blk = hamiltonian_from_numpy(
            np.asarray(jblk.diag), np.asarray(jblk.ell.cols),
            np.asarray(jblk.ell.vals), None, None, None, None, None, "cpu",
            torch.complex128 if cplx else torch.float64)
        want, _ = jax_lz.lowest_states(jblk, num_states=2, max_steps=200)
        got, _ = lz.lowest_states(blk, num_states=2, max_steps=200)
        assert _rel(got, np.asarray(want)) <= 1e-10, s
    assert kinds == {False, True}


class _Empty:
    """A symmetry whose every sector is empty."""

    def sectors(self):
        return 3

    def block_hamiltonian(self, s):
        return None

    def block_pair(self, s, dtype=None):
        return None, None


def test_no_non_empty_sector_raises(monkeypatch):
    """ROADMAP Queue 3 item 2: with no non-empty sector the JAX Engine
    unpacks None (a bare TypeError); the port raises its own error."""
    text = hubbard_chain_text(4, 4, 2, 2) + TRANSLATION
    monkeypatch.setattr(jax_symmetry, "build_symmetry",
                        lambda *a, **k: _Empty())
    monkeypatch.setattr(symmetry, "build_symmetry",
                        lambda *a, **k: _Empty())
    jinp = jax_parse(text)
    with pytest.raises(TypeError):
        JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    inp = parse_input(text)
    with pytest.raises(ValueError, match="no non-empty symmetry sector"):
        Engine(build_model(inp, Geometry(inp)), inp, config=CPU)


def test_projected_kitaev_matches_jax():
    """The 8-site Kitaev ring's momentum sectors by projection: T^g as a
    reshape-transpose equals the word rotation, the real projectors
    partition the identity, each sector's E0 equals JAX's (1e-10) and the
    orbit block's, and each vector is a clean sector vector."""
    n = 8
    text = kitaev_text(n, 1.1, 0.7, 0.9, periodic=1)
    (jmodel, jbasis), (model, basis) = _both(text)
    u = np.arange(1 << n)
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(1 << n))
    for g in range(1, n):
        rot = ((u >> g) | ((u & ((1 << g) - 1)) << (n - g))) & ((1 << n) - 1)
        assert torch.equal(v.view(1 << g, -1).t().reshape(-1), v[rot])
    total = sum(rotation_weights(n, k) for k in range(n // 2 + 1))
    np.testing.assert_allclose(total, np.eye(1, n)[0], atol=1e-12)
    proj = ProjectedTranslationSolver(
        build_factored_kitaev(model, basis, dtype=torch.float64), n)
    jproj = JaxProjected(jax_build_factored_kitaev(jmodel, jbasis,
                                                   dtype=np.float64), n)
    blocks = symmetry.TranslationSymmetry(basis, model.geometry, model,
                                          fermionic=False)
    assert proj.sectors() == jproj.sectors() == n // 2 + 1
    for s in range(proj.sectors()):
        k = proj.momentum(s)
        evals, vecs, info = proj.solve_sector(s, max_steps=120)
        jevals, _, _ = jproj.solve_sector(s, max_steps=120)
        assert _rel(evals[0], jevals[0]) <= 1e-10, k
        want = min(np.linalg.eigvalsh(blocks.block_hamiltonian(b)
                                      .to_dense())[0]
                   for b in {k, (n - k) % n})
        assert _rel(evals[0], want) <= 1e-10, k
        assert abs(proj.purity(s, vecs[0]) - 1.0) <= 1e-8, k


def test_engine_projected_kitaev_matches_jax():
    """SolverOptions=projected routes the Kitaev ring through the
    projected solver on the CPU: energy, sector and purity as the JAX
    Engine's, the eigenvector a solution of the full H."""
    text = kitaev_text(8, 1.1, 0.7, 0.9, periodic=1).replace(
        "SolverOptions=none", "SolverOptions=projected") + TRANSLATION
    jinp = jax_parse(text)
    jeng = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    inp = parse_input(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    assert _rel(eng.ground_energy, jeng.ground_energy) <= 1e-10
    assert eng.solve_sector == jeng.solve_sector
    assert abs(eng.projected_purity - jeng.projected_purity) <= 1e-8
    assert abs(eng.projected_purity - 1.0) <= 1e-8
    v = eng.eigenvector(0).numpy()
    resid = np.linalg.norm(eng.hamiltonian.to_dense() @ v
                           - eng.ground_energy * v)
    assert resid <= 1e-7


def _energy(run, path, capsys, args=()):
    engine = run(["-f", path, "-p", "17", *args])
    return engine, float(re.search(r"^Energy=(\S+)$",
                                   capsys.readouterr().out, re.M).group(1))


@pytest.mark.parametrize("name", ["hubbard4 translation",
                                  "hubbard4 reflection", "hubbard8 ladder",
                                  "kitaev8 translation"])
def test_cli_energy_matches_jax_cli(tmp_path, capsys, name):
    text, label = CASES[name]
    path = tmp_path / "input.inp"
    path.write_text(text + label)
    _, got = _energy(lanczos_main.run, str(path), capsys,
                     ("--device", "cpu"))
    _, want = _energy(jax_main.run, str(path), capsys)
    assert _rel(got, want) <= 1e-10


def test_observables_after_a_complex_sector_match_jax_cli(tmp_path, capsys,
                                                          monkeypatch):
    """The 6-site ring with 1 up and 2 down electrons has its minimum in a
    complex momentum sector.  After that solve, -c n, -c c, -m, -M, -r and
    -g c through the port's CLI give what the JAX CLI gives: the
    correlators 1e-10, the braket and many-point values 1e-10, the
    entanglement entropy 1e-10, and G(omega + 0.1i) of the .comb file (a
    fraction whose Krylov space is exhausted) 1e-8."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "ring.inp"
    path.write_text(hubbard_chain_text(6, 4, 1, 2, extra="TSPSites 2 0 1\n")
                    + TRANSLATION)
    args = ["-c", "n", "-c", "c", "-m", "gs|n[0]|gs", "-M",
            "c?0?0;cdagger?2?0", "-r", "2", "-g", "c"]
    outs = {}
    for label, run, extra in (("jax", jax_main.run, []),
                              ("port", lanczos_main.run,
                               ["--device", "cpu"])):
        engine = run(["-f", str(path), "-p", "17", *args, *extra])
        outs[label] = (engine, capsys.readouterr().out,
                       (read_collection if label == "port" else
                        jax_read_collection)("ring.inp0.comb"))
    (jeng, jout, jcoll), (eng, out, coll) = outs["jax"], outs["port"]
    assert eng.eigenvector(0).dtype == torch.complex128
    assert eng.scalar_dtype == torch.complex128
    assert eng.solve_sector in (jeng.solve_sector, (6 - jeng.solve_sector) % 6)
    assert jeng.solve_sector not in (0, 3)

    def values(text, pattern):
        return np.array([complex(m) for m in re.findall(pattern, text, re.M)])
    for pattern in (r"^Energy=(\S+)$", r"^gs\|.*\|gs = (\S+)$",
                    r"^<gs\|.*\|gs>=(\S+)$",
                    r"^EntanglementEntropy=(\S+)$"):
        got, want = values(out, pattern), values(jout, pattern)
        assert got.size == want.size == 1, pattern
        assert np.abs(got - want).max() <= 1e-10, pattern
    for op in ("n", "c"):
        got = eng.two_point(op)
        want = np.asarray(jeng.two_point(op))
        assert np.nanmax(np.abs(got - want)) <= 1e-10, op
    omegas = np.linspace(-6.0, 6.0, 41)
    got, want = coll.evaluate(omegas, 0.1), jcoll.evaluate(omegas, 0.1)
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


def test_mirror_sector_spectral():
    """k and -k of the 6-site ring (1 up, 2 down) are degenerate, so
    rounding picks the minimum sector between them (the card may pick the
    other one): their blocks have the same E0 (1e-12), and -g c from
    either one's state gives the same G_01(omega + 0.1i) (1e-12), since
    300 steps exhaust every Krylov space."""
    inp = parse_input(hubbard_chain_text(6, 4, 1, 2,
                                         extra="SpectralSteps=300\n")
                      + TRANSLATION)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    sym, s = eng.symmetry, eng.solve_sector
    mirror = (6 - s) % 6
    assert mirror != s
    evals, vecs = lz.lowest_states(sym.block_hamiltonian(mirror),
                                   seed=eng.config.seed)
    assert abs(float(evals[0]) - eng.ground_energy) <= \
        1e-12 * abs(eng.ground_energy)
    omegas = np.linspace(-6.0, 6.0, 41)
    want = eng.spectral_function("c", 0, 1)[0].evaluate(omegas, 0.1)
    eng._vectors = [torch.as_tensor(sym.transform(vecs[0].numpy(), mirror))]
    got = eng.spectral_function("c", 0, 1)[0].evaluate(omegas, 0.1)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
