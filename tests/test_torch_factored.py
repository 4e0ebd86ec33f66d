"""The port's factored forms (SolverOptions=factored) held against the JAX
package on the CPU: ``BlockKronHamiltonian`` matvec and matmat_t on the
JAX-built forms' own tables (1e-13; tiered equal to untiered), every
builder's dense matrix against the JAX builder's and against the port's
flat model in flat order (1e-12, at the sizes of the JAX package's own
factored tests), the Engine and the CLI with SolverOptions=factored
(energies 1e-10 against the JAX Engine and the flat path, eigenvectors in
flat order, -g against the flat path as evaluated functions), the
fallback of an input no builder serves, and the bf16 options against
the JAX package's.  The port runs the plain versions of its kernels
here."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models import (
    factored_hamiltonian_or_none as jax_factored)
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.core.blockkron import (
    BlockKronHamiltonian, CrossTerm, PermCrossTerm, PermutedHamiltonian,
    make_perm_cross, tierize)
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.spectral import read_collection
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    FactoredKitaevHamiltonian, build_factored_kitaev)
from lanczosplusplus_tpu_torch.ops import kernels
from test_torch_host import hubbard_chain_text
from test_torch_inputs import (_term, feas_so_text, heisenberg_text,
                                kitaev_text, rashba_text, tj_text)

torch.set_num_threads(2)

CPU = Config(device="cpu")

P33 = ("TotalNumberOfSites=4\nModel=FeAsBasedSc\nFeAsMode=INT_PAPER33\n"
       "NumberOfTerms=1\nDegreesOfFreedom=2\nOrbitals=2\n"
       "GeometryKind=chain\nGeometryOptions=ConstantValues\n"
       "SolverOptions=none\n"
       "hubbardU 4 4.0 3.0 -0.8 -0.4\nConnectors 2 2\n-1.0 0.2\n"
       "0.2 -1.0\n"
       "potentialV 16 " + " ".join(["0.3"] * 16) + "\n"
       "TargetElectronsUp=2\nTargetElectronsDown=2\nIsPeriodicX=1\n")
EXT = ("TotalNumberOfSites=4\nModel=FeAsBasedScExtended\n"
       "FeAsMode=INT_PAPER33\nNumberOfTerms=2\nDegreesOfFreedom=2\n"
       "Orbitals=2\nGeometryKind=chain\nGeometryOptions=ConstantValues\n"
       "Connectors 2 2\n-1.0 0.2\n0.2 -1.0\n"
       "DegreesOfFreedom=1\nGeometryKind=chain\n"
       "GeometryOptions=ConstantValues\nConnectors 1 0.7\n"
       "SolverOptions=none\nhubbardU 4 4.0 3.0 -0.8 -0.4\n"
       "potentialV 16 " + " ".join(["0.3"] * 16) + "\n"
       "TargetElectronsUp=2\nTargetElectronsDown=2\nIsPeriodicX=1\n")


def _tj(nsite, nup, ndn, periodic):
    """The JAX package's factored t-J input: t = 1, J_pm = 0.7,
    J_zz = 0.4, W = 0.3 and site potentials."""
    vals = " ".join(f"{0.1 * (i + 1):.2f}" for i in range(2 * nsite))
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + "".join(_term(v) for v in (1.0, 0.7, 0.4, 0.3))
            + f"Model=TjMultiOrb\nOrbitals=1\n"
              f"potentialV {2 * nsite} {vals}\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndn}\n"
              f"IsPeriodicX={periodic}\n")


def _rashba(n, ne, pbc, r="0.5"):
    """The JAX package's half-cut Rashba input (U = 4, two potentials)."""
    text = rashba_text(n, ne, r=r, u=4.0, periodic=pbc,
                       options="useComplex" if "(" in r else "none")
    pv = " ".join(["0.1", "-0.2"] + ["0"] * (2 * n - 2))
    return re.sub(r"potentialV \d+ [^\n]*", f"potentialV {2 * n} {pv}",
                  text)


# name -> input text, at the sizes of the JAX package's factored tests
CASES = {
    "heisenberg8_open": heisenberg_text(8, 1, 4, periodic=0),
    "heisenberg10_ring": heisenberg_text(10, 1, 5),
    "heisenberg_spin1": heisenberg_text(6, 2, 4,
                                        extra="MagneticField 6 0.1 0 0.2 0 "
                                              "0 0.3\nAnisotropyD 6 0.3 0.3 "
                                              "0.1 0.3 0.3 0.2\n"),
    "kitaev6": kitaev_text(6, 1.1, 0.7, 0.9, periodic=1),
    "kitaev8_field": kitaev_text(8, 1.0, 0.6, 0.8, periodic=1,
                                 extra="MagneticField 8 0.1 0.2 0 0 0.3 0 "
                                       "0 0.1\n"),
    "tj6_ring": _tj(6, 2, 2, 1),
    "tj6_open": _tj(6, 3, 2, 0),
    "tj7_ring": _tj(7, 3, 3, 1),
    "tj5_open": _tj(5, 2, 1, 0),
    "rashba4_open": _rashba(4, 4, 0),
    "rashba5_ring": _rashba(5, 5, 1),
    "rashba6_ring": _rashba(6, 5, 1),
    "rashba5_complex": _rashba(5, 4, 1, r="(0.3,0.4)"),
    "feas_p33": P33,
    "feas_p33_three_up": P33.replace("TargetElectronsUp=2",
                                     "TargetElectronsUp=3"),
    "feas_impurity": P33.replace("INT_PAPER33", "INT_IMPURITY").replace(
        "hubbardU 4 4.0 3.0 -0.8 -0.4", "hubbardU 4 4.0 3.0 0.0 -0.4"),
    "feas_kspace": P33.replace("INT_PAPER33", "INT_KSPACE").replace(
        "hubbardU 4 4.0 3.0 -0.8 -0.4", "hubbardU 1 2.0"),
    "feas_extended": EXT,
    "feas_spinorbit": feas_so_text(2, 2, 1),
    "feas_spinorbit_three": feas_so_text(3, 2, 1,
                                         extra="AnisotropyD=0.2\n"),
}
NAMES = sorted(CASES)


def _dtype(inp):
    return (torch.complex128 if "useComplex" in inp.solver_options()
            else torch.float64)


def _both(name):
    """(port model, basis, parts, JAX model, JAX basis) of the input's own
    sector."""
    text = CASES[name]
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    return (inp, model, model.create_basis(parts), parts, jmodel,
            jmodel.create_basis(parts))


def _jax_form(name):
    inp, model, basis, parts, jmodel, jbasis = _both(name)
    np_dtype = np.complex128 if _dtype(inp).is_complex else np.float64
    return jax_factored(jmodel, jbasis, parts, np_dtype)


def port_form(jform):
    """The port's form from a JAX-built one, every table carried across
    as a numpy array."""
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    kind = type(jform).__name__
    if kind == "PermutedHamiltonian":
        return PermutedHamiltonian(
            inner=port_form(jform.inner),
            perm=t(np.asarray(jform.perm, np.int64)),
            inv=t(np.asarray(jform.inv, np.int64)),
            sign=None if jform.sign is None else t(np.real(jform.sign)))
    if kind == "FactoredKitaevHamiltonian":
        return FactoredKitaevHamiltonian(
            diag2d=t(jform.diag2d), hl=t(jform.hl), hr_t=t(jform.hr_t),
            p=t(jform.p), q=t(jform.q))
    return BlockKronHamiltonian(
        diag=tuple(map(t, jform.diag)), row_ops=tuple(map(t, jform.row_ops)),
        col_ops=tuple(map(t, jform.col_ops)),
        cross=tuple(CrossTerm(left=t(c.left), right=t(c.right), src=c.src,
                              dst=c.dst, add_hc=c.add_hc)
                    for c in jform.cross),
        shapes=tuple(jform.shapes),
        perm_cross=tuple(PermCrossTerm(
            row_src=t(p.row_src).to(torch.int32), row_amp=t(p.row_amp),
            col_src=t(p.col_src).to(torch.int32), col_amp=t(p.col_amp),
            src=p.src,
            dst=p.dst, groups=p.groups, col_groups=p.col_groups)
            for p in jform.perm_cross),
        tiers=jform.tiers, diag_t=tuple(map(t, jform.diag_t)),
        row_t=tuple(map(t, jform.row_t)), col_t=tuple(map(t, jform.col_t)))


# the JAX forms applied under jit (a form is a pytree): one compilation a
# form instead of one per eager operation
_jax_matmat_t = jax.jit(lambda form, x: form.matmat_t(x))
_jax_matvec = jax.jit(lambda form, x: form.matvec(x))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-300)


@pytest.mark.parametrize("name", ["tj7_ring", "heisenberg10_ring",
                                  "rashba5_complex", "feas_p33",
                                  "feas_spinorbit", "kitaev8_field"])
def test_form_on_jax_tables_matches_jax(name):
    """The JAX-built form's own tables through the port's matvec and
    matmat_t (one state, a block of 3) give the JAX package's results to
    1e-13, and with tiers as without."""
    jform = _jax_form(name)
    form = port_form(jform)
    rng = np.random.default_rng(len(name))
    dtype = np.complex128 if "complex" in name or "spinorbit" in name \
        else np.float64
    x = rng.standard_normal((3, form.dim)).astype(dtype)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal(x.shape)
    want = np.asarray(_jax_matmat_t(jform, jnp.asarray(x)))
    assert _rel(form.matmat_t(torch.from_numpy(x)).numpy(), want) <= 1e-13
    assert _rel(form.matvec(torch.from_numpy(x[1])).numpy(),
                np.asarray(_jax_matvec(jform, jnp.asarray(x[1])))) <= 1e-13
    inner = getattr(form, "inner", form)
    if isinstance(inner, BlockKronHamiltonian) and inner.tiers:
        plain = dataclasses.replace(inner, tiers=None, diag_t=(), row_t=(),
                                    col_t=())
        xi = torch.from_numpy(x[:, :inner.dim])
        assert _rel(plain.matmat_t(xi).numpy(),
                    inner.matmat_t(xi).numpy()) <= 1e-13


def test_port_tierize_matches_jax_tiers():
    """``tierize`` groups the 7-site t-J half-cut's blocks as the JAX
    package does, and the tiered apply equals the untiered one."""
    jform = _jax_form("tj7_ring").inner
    inp, model, basis, parts, _, _ = _both("tj7_ring")
    form = factored_hamiltonian_or_none(model, basis, parts, torch.float64)
    assert form.inner.tiers == jform.tiers and form.inner.tiers
    plain = dataclasses.replace(form.inner, tiers=None, diag_t=(), row_t=(),
                                col_t=())
    assert tierize(plain).tiers == form.inner.tiers
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, form.dim)))
    assert _rel(plain.matmat_t(x).numpy(),
                form.inner.matmat_t(x).numpy()) <= 1e-13


@pytest.mark.parametrize("name", NAMES)
def test_builder_dense_matches_jax_and_flat(name):
    """Each builder's dense matrix, in flat order, against the JAX
    builder's and against the port's flat model, to 1e-12."""
    inp, model, basis, parts, jmodel, jbasis = _both(name)
    dtype = _dtype(inp)
    form = factored_hamiltonian_or_none(model, basis, parts, dtype)
    assert form is not None and form.dim == basis.size
    dense = form.to_dense()
    jform = jax_factored(jmodel, jbasis, parts, np.complex128
                         if dtype.is_complex else np.float64)
    jdense = np.asarray(_jax_matmat_t(jform, jnp.eye(
        jform.dim, dtype=np.asarray(dense).dtype))).T
    flat = model.hamiltonian(basis, dtype=dtype).to_dense()
    assert np.abs(dense - jdense).max() <= 1e-12
    assert np.abs(dense - flat).max() <= 1e-12


def test_rashba_block_kron_matches_jax_and_flat():
    """The (nup, ndown) block-Kronecker Rashba form, which no dispatch
    reaches."""
    inp, model, basis, parts, jmodel, jbasis = _both("rashba5_ring")
    form = model.block_kron_hamiltonian(basis)
    dense = form.to_dense()
    jform = jmodel.block_kron_hamiltonian(jbasis, dtype=np.float64)
    jdense = np.asarray(_jax_matmat_t(jform, jnp.eye(jform.dim))).T
    assert np.abs(dense - jdense).max() <= 1e-12
    assert np.abs(dense - model.hamiltonian(basis).to_dense()).max() <= 1e-12


def _factored(text):
    return text.replace("SolverOptions=none", "SolverOptions=factored") \
        .replace("SolverOptions=useComplex",
                 "SolverOptions=useComplex,factored")


@pytest.mark.parametrize("name", ["heisenberg10_ring", "kitaev8_field",
                                  "tj7_ring", "rashba6_ring",
                                  "rashba5_complex", "feas_p33_three_up",
                                  "feas_spinorbit_three"])
def test_engine_factored_matches_jax_and_flat(name):
    """Engine with SolverOptions=factored: E0 against the JAX Engine's and
    the flat path's to 1e-10; the eigenvector comes back in flat order,
    an eigenvector of the flat matrix."""
    text = _factored(CASES[name])
    inp, jinp = parse_input(text), jax_parse(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device="cpu"))
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    flat = Engine(build_model(inp, Geometry(inp)), parse_input(CASES[name]),
                  config=Config.from_input(inp, device="cpu"))
    assert engine._factored and jengine._factored
    assert engine.solve_info.factored_fallback is None
    e0 = engine.ground_energy
    for other in (jengine.ground_energy, flat.ground_energy):
        assert abs(e0 - other) <= 1e-10 * abs(other)
    v = engine.eigenvector(0)
    hv = flat.hamiltonian.matvec(v)
    assert torch.linalg.vector_norm(hv - e0 * v).item() <= 1e-7
    assert abs(torch.linalg.vector_norm(v).item() - 1.0) <= 1e-12


def test_cli_factored_energy_matches_flat(tmp_path, monkeypatch, capsys):
    """``lanczos -f`` with SolverOptions=factored prints the flat
    path's energy."""
    monkeypatch.chdir(tmp_path)
    energies = []
    for text in (CASES["tj7_ring"], _factored(CASES["tj7_ring"])):
        path = tmp_path / "input.inp"
        path.write_text(text)
        lanczos_main.run(["-f", str(path), "--device", "cpu", "-p", "15"])
        energies.append(float(re.search(r"^Energy=(\S+)$",
                                        capsys.readouterr().out,
                                        re.M).group(1)))
    assert abs(energies[0] - energies[1]) <= 1e-10 * abs(energies[0])


def test_cli_factored_spectral_matches_flat(tmp_path, monkeypatch):
    """``-g c`` with SolverOptions=factored runs its N+-1 sectors through
    their factored forms and gives the flat path's G_00(omega), as
    evaluated functions of exhausted fractions."""
    monkeypatch.chdir(tmp_path)
    # a nondegenerate ground state; every sector of -g (dims 15 to 90)
    # is exhausted within 300 steps
    text = tj_text(6, 3, 2, periodic=0) + \
        "TSPSites 2 0 0\nSpectralSteps=300\n"
    omegas = np.linspace(-6.0, 6.0, 121)
    got = []
    for run_text in (text, _factored(text)):
        path = tmp_path / "input.inp"
        path.write_text(run_text)
        engine = lanczos_main.run(["-f", str(path), "--device", "cpu",
                                   "-g", "c"])
        got.append(read_collection("input.inp0.comb").evaluate(omegas, 0.1))
    assert engine._factored
    kinds = {type(h).__name__ for h in engine._ham_cache.values()}
    assert kinds == {"PermutedHamiltonian"}
    assert len(engine._ham_cache) == 3
    assert np.abs(got[0] - got[1]).max() <= 1e-9 * np.abs(got[0]).max()


def test_asymmetric_heisenberg_falls_back_with_jax_reason():
    """Asymmetric couplings have no factored form: the Engine solves the
    flat form and records the JAX package's reason in solve_info."""
    text = heisenberg_text(6, 1, 3).replace("SolverOptions=none",
                                            "SolverOptions=factored")
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    for m in (model, jmodel):
        m.jpm = m.jpm.copy()
        m.jpm[0, 1] = 0.5
    engine = Engine(model, inp, config=CPU)
    jengine = JaxEngine(jmodel, jinp)
    assert not engine._factored and not jengine._factored
    reason = engine.solve_info.factored_fallback
    assert reason == jengine.solve_info.factored_fallback
    assert "couplings must be symmetric" in reason
    assert abs(engine.ground_energy - jengine.ground_energy) <= \
        1e-10 * abs(jengine.ground_energy)


def test_model_without_builder_falls_back():
    """The Hubbard family has no factored builder, in both packages."""
    inp = parse_input(hubbard_chain_text(6).replace(
        "SolverOptions=none", "SolverOptions=factored"))
    reasons = []
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    assert not engine._factored
    assert "HubbardModel has no factored builder" in \
        engine.solve_info.factored_fallback
    jinp = jax_parse(hubbard_chain_text(6).replace(
        "SolverOptions=none", "SolverOptions=factored"))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    jax_factored(jmodel, jmodel.create_basis(jmodel.default_parts(jinp)),
                 jmodel.default_parts(jinp), np.float64, warn=reasons.append)
    assert reasons == [engine.solve_info.factored_fallback]


def test_bf16_options_raise_naming_item_11():
    """The three bf16 calls that raised naming ROADMAP Queue 1 item 11
    until it was ported now run, each held against the JAX package: the
    bf16cross Engine on the t-J ring (quantized, its refined energy within
    1e-8 of the JAX package's bf16cross Engine), bf16 Kitaev factors
    (equal to the JAX builder's, the matvec to float32 rounding of the JAX
    one: float32 sums against its float64 ones) and make_perm_cross with
    cross_dtype=bf16 (state_cast "bf16", the same channel groups)."""
    import lanczosplusplus_tpu.core.blockkron as jbk
    from lanczosplusplus_tpu.models.kitaev_factored import (
        build_factored_kitaev as jax_build_kitaev)

    text = _factored(CASES["tj6_ring"]).replace(
        "SolverOptions=factored", "SolverOptions=factored,bf16cross")
    inp, jinp = parse_input(text), jax_parse(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp, config=CPU)
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    assert engine._cached_hamiltonian(engine.parts).quantized
    assert engine.ground_energy == pytest.approx(jengine.ground_energy,
                                                 abs=1e-8)
    inp, model, basis, parts, jmodel, jbasis = _both("kitaev6")
    form = build_factored_kitaev(model, basis, factor_dtype=torch.bfloat16)
    jform = jax_build_kitaev(jmodel, jbasis, factor_dtype=jnp.bfloat16)
    assert form.quantized and form.hl.dtype == torch.bfloat16
    assert np.array_equal(form.p.float().numpy(),
                          np.asarray(jform.p).astype(np.float32))
    x = np.random.default_rng(4).standard_normal(form.dim)
    assert _rel(form.matvec(torch.from_numpy(x)).numpy(),
                _jax_matvec(jform, jnp.asarray(x))) <= 1e-5
    rng = np.random.default_rng(7)
    tables = (rng.integers(0, 3, (3, 4)).astype(np.int32),
              rng.standard_normal((3, 4)),
              np.zeros((3, 5), np.int32), rng.standard_normal((3, 5)))
    tables[2][1] = 2
    t = make_perm_cross(*tables, 0, 0, torch.float64,
                        cross_dtype=torch.bfloat16)
    jt = jbk.make_perm_cross(*tables, 0, 0, np.float64,
                             cross_dtype=jnp.bfloat16)
    assert t.state_cast == jt.state_cast == "bf16"
    assert (t.groups, t.col_groups) == (jt.groups, jt.col_groups)


def test_factored_forms_launch_nothing_on_the_cpu():
    """On the CPU every product and gather of a factored form takes the
    plain versions."""
    inp, model, basis, parts, _, _ = _both("rashba5_complex")
    form = factored_hamiltonian_or_none(model, basis, parts,
                                        torch.complex128)
    kernels.reset_launches()
    form.matvec(torch.ones(form.dim, dtype=torch.complex128))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
