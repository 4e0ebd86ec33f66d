"""float32 and complex64 on every path the JAX package runs below float64
on its chip, held against the JAX package on the CPU.

Module by module, the port runs in float32 (complex64) on the same inputs
as the JAX function called with float32 (complex64) arrays: the batched
plain recurrence, the Chebyshev moments, the FTLM recurrence, the symmetry
blocks and the projector's weights.  End to end, the port's Engine and
command lines run with ``real_dtype`` float32 against the JAX package's
run in float64 (its Engine takes its precision from the process-wide x64
flag, which ``tests/conftest.py`` sets).  Inputs come from numpy seeds and
the JAX package's own draws.

Bars (each test names its own):
- refined energies (ground state, blocks, projection, ``#CFEnergy=``):
  1e-10 relative of the float64 E0;
- the first 5 alphas and betas of a recurrence: 1e-5 relative of the
  float64 run's (the float32 JAX run's, 1e-5 too) from the same start
  vector; plain Lanczos amplifies rounding, so later coefficients are
  held only through the functions they give;
- broadened densities (continued fractions, KPM, FTLM at delta 0.1) and
  S(q, omega): 2e-3 of the density's maximum;
- ``-c`` and Z(k): 1e-5 of their maximum;
- float32 tables built from the same float64 values: equal bit for bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu import symmetry as jax_symmetry
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import chebyshev_time as jax_ct
from lanczosplusplus_tpu.engine import ftlm as jftlm
from lanczosplusplus_tpu.engine import kpm as jkpm
from lanczosplusplus_tpu.engine.spectral import (
    read_collection as jax_read_collection)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models.kitaev_factored import (
    build_factored_kitaev as jax_build_factored_kitaev)
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu.symmetry.projected import (
    ProjectedTranslationSolver as JaxProjected)
from lanczosplusplus_tpu_torch import Config, symmetry
from lanczosplusplus_tpu_torch.cli import lanczos_main
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine import chebyshev_time as tct
from lanczosplusplus_tpu_torch.engine import ftlm as tftlm
from lanczosplusplus_tpu_torch.engine import kpm as tkpm
from lanczosplusplus_tpu_torch.engine.spectral import read_collection
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    build_factored_kitaev)
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.ops.refine import f64_twin, narrowed
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.symmetry.projected import (
    ProjectedTranslationSolver)
from chip_smoke import hubbard_chain_text as chain_text
from test_torch_engine_cli import _numbers, _run_both, _use_jax_draws
from test_torch_ftlm import docc, jax_block
from test_torch_host import INPUT0, hubbard_chain_text
from test_torch_inputs import feas_text, heisenberg_text, kitaev_text
from test_torch_inputs import rashba_text

torch.set_num_threads(2)

F32 = Config(device="cpu", real_dtype=torch.float32)
NARROW = {torch.float64: np.float32, torch.complex128: np.complex64}
E0_BAR = 1e-10
COEF_BAR = 1e-5
DENSITY_BAR = 2e-3
STATIC_BAR = 1e-5
OMEGAS = np.linspace(-8, 8, 321)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _sector(text, dtype=torch.float64, parts=None):
    """(the port's float32 or complex64 form, narrowed from its float64
    one; that float64 form; the JAX form built in float32 or complex64;
    the port's basis) of an input's default sector on the CPU."""
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = parts or model.default_parts(inp)
    basis = model.create_basis(parts)
    ham64 = model.hamiltonian(basis, dtype=dtype)
    jham = jmodel.hamiltonian(jmodel.create_basis(parts), dtype=NARROW[dtype])
    return narrowed(ham64), ham64, jham, basis


def _coefficients_close(ress, jress, count=5, bar=COEF_BAR):
    for res, jres in zip(ress, jress):
        for got, want in ((res.alphas, jres.alphas),
                          (res.betas, jres.betas)):
            assert _rel(got[:count], want[:count]) <= bar


# -- solver/lanczos: the batched plain recurrence ---------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["float32", "complex64"])
def test_batched_plain_recurrence_matches_jax_float32(dtype):
    """tridiagonalize_plain_batched on a float32 (complex64) form and
    block against JAX's called with float32 (complex64) arrays: the first
    5 coefficients of each row to 1e-5 relative, and of the float64 run
    from the same rows to 1e-5 too (but not to 1e-9: the run was float32)."""
    text = hubbard_chain_text(6) if not dtype.is_complex \
        else rashba_text(5, 4, periodic=1)
    ham, ham64, jham, basis = _sector(text, dtype)
    assert ham.dtype == {torch.float64: torch.float32,
                         torch.complex128: torch.complex64}[dtype]
    rng = np.random.default_rng(21)
    v0s = rng.standard_normal((4, ham.dim))
    if dtype.is_complex:
        v0s = v0s + 1j * rng.standard_normal((4, ham.dim))
    v0s /= np.linalg.norm(v0s, axis=1, keepdims=True)
    v0s = v0s.astype(NARROW[dtype])
    ress = lz.tridiagonalize_plain_batched(ham, v0s, 30)
    jress = jlz.tridiagonalize_plain_batched(jham, jnp.asarray(v0s), 30)
    assert [r.m for r in ress] == [r.m for r in jress] == [30] * 4
    _coefficients_close(ress, jress)
    wide = lz.tridiagonalize_plain_batched(
        ham64, v0s.astype(np.complex128 if dtype.is_complex else np.float64),
        30)
    _coefficients_close(ress, wide)
    assert max(_rel(r.alphas[:5], w.alphas[:5])
               for r, w in zip(ress, wide)) > 1e-9


# -- engine/kpm: Chebyshev moments on a float32 phi -------------------------

def test_chebyshev_moments_match_jax_float32():
    """The moments of a float32 block on the float32 form against JAX's on
    float32 arrays, both given the same bounds: 1e-5 of mu_0 (the
    Chebyshev recurrence is stable, |T_k| <= 1), summed on the host in
    float64; the density to 2e-3 of its maximum against the float64
    moments."""
    ham, ham64, jham, basis = _sector(hubbard_chain_text(6, periodic=False))
    lo, hi = tkpm.spectral_bounds(ham64)
    V = jax_block(basis.size, 3, 17, torch.float64).astype(np.float32)
    res = tkpm.chebyshev_moments(ham, V, 101, bounds=(lo, hi))
    jres = jkpm.chebyshev_moments(jham, jnp.asarray(V), 101, bounds=(lo, hi))
    assert res.moments.dtype == np.float64
    assert np.abs(res.moments - jres.moments).max() <= \
        COEF_BAR * jres.moments[0]
    wide = tkpm.chebyshev_moments(ham64, V.astype(np.float64), 101,
                                  bounds=(lo, hi))
    # inside the bounds: at them 1/sqrt(1 - x^2) magnifies any moment's
    # rounding without bound
    pad = 0.05 * (hi - lo)
    grid = np.linspace(lo + pad, hi - pad, 301)
    want = wide.density(grid)
    assert _rel(res.density(grid), want) <= DENSITY_BAR
    lo32, hi32 = tkpm.spectral_bounds(ham)
    evals = np.linalg.eigvalsh(ham64.to_dense())
    assert lo32 < evals[0] and hi32 > evals[-1]


# -- engine/ftlm: the batched recurrence on a float32 block -----------------

def test_ftlm_recurrence_matches_jax_float32():
    """_ftlm_recurrence from a float32 V0 against JAX's: alphas and betas
    kept in float32 (JAX ftlm.py:51-52), the first 5 steps and their
    Krylov dots to 1e-5 relative."""
    ham, _, jham, basis = _sector(hubbard_chain_text(6))
    V = jax_block(basis.size, 3, 2, torch.float64).astype(np.float32)
    Y = (docc(basis)[None, None, :] * V.T[None]).astype(np.float32)
    a, b, d = tftlm._ftlm_recurrence(ham, torch.as_tensor(V.T).contiguous(),
                                     torch.as_tensor(Y), 5)
    assert a.dtype == b.dtype == d.dtype == torch.float32
    ja, jb, jd = jftlm._ftlm_recurrence(jham, jnp.asarray(V.T),
                                        jnp.asarray(Y), 5)
    for got, want in ((a, ja), (b, jb), (d, jd)):
        assert _rel(got.numpy(), want) <= COEF_BAR


def test_ftlm_float32_matches_float64_and_reckons_four_bytes(monkeypatch):
    """ftlm on the float32 form against the float64 form from the same
    block: thermal energies to 1e-5 relative; the blocks it reckons
    against the budget are counted at 4 bytes an element."""
    ham, ham64, _, basis = _sector(hubbard_chain_text(6))
    V = jax_block(basis.size, 4, 3, torch.float64)
    betas = np.asarray([0.1, 1.0, 5.0])
    reckoned = []
    real = lz.check_fits
    monkeypatch.setattr(lz, "check_fits",
                        lambda n, what, dev: (reckoned.append(n),
                                              real(n, what, dev)))
    res = tftlm.ftlm(ham, betas, steps=30, start_vectors=V)
    res64 = tftlm.ftlm(ham64, betas, steps=30, start_vectors=V)
    assert reckoned[0] * 2 == reckoned[1] == 5 * 4 * basis.size * 8
    assert _rel(res.energy, res64.energy) <= COEF_BAR
    assert abs(res.e0_estimate - res64.e0_estimate) <= \
        COEF_BAR * abs(res64.e0_estimate)
    assert tftlm.ltlm_bytes(100, 10, 2, torch.float32) * 2 == \
        tftlm.ltlm_bytes(100, 10, 2, torch.float64)


# -- symmetry/blocks: float32 and complex64 blocks --------------------------

SYM_CASES = {
    "translation": (chain_text(8, 4), "UseTranslationSymmetry=1\n"),
    "reflection": (chain_text(8, 4, periodic=0), "UseReflectionSymmetry=1\n"),
    "ladder": (chain_text(8, 4, 2, 2, ladder=True),
               "UseTranslationSymmetry=2\n"),
}


def _symmetries(name):
    text, label = SYM_CASES[name]
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    basis = model.create_basis(model.default_parts(inp))
    jbasis = jmodel.create_basis(jmodel.default_parts(jinp))
    if "Reflection" in label:
        return (symmetry.ReflectionSymmetry(basis, model.geometry, model),
                jax_symmetry.ReflectionSymmetry(jbasis, jmodel.geometry,
                                                jmodel))
    use_y = label.endswith("2\n")
    return (symmetry.TranslationSymmetry(basis, model.geometry, model,
                                         use_y=use_y),
            jax_symmetry.TranslationSymmetry(jbasis, jmodel.geometry,
                                             jmodel, use_y=use_y))


@pytest.mark.parametrize("name", list(SYM_CASES))
def test_float32_blocks_equal_jax_float32_blocks(name):
    """block_hamiltonian(s, dtype=float32) against JAX
    block_hamiltonian(s, dtype=np.float32): both cast the same float64
    entries, so the dense blocks are equal bit for bit, complex64 where
    the momentum block is complex; block_pair hands out the float64 block
    the float32 one was narrowed from, and caches only the float32 one."""
    sym, jsym = _symmetries(name)
    kinds = set()
    for s in range(sym.sectors()):
        blk, wide = sym.block_pair(s, torch.float32)
        jblk = jsym.block_hamiltonian(s, dtype=np.float32)
        assert (blk is None) == (jblk is None)
        if blk is None:
            continue
        kinds.add(blk.dtype)
        assert blk.dtype in (torch.float32, torch.complex64)
        assert wide.dtype == {torch.float32: torch.float64,
                              torch.complex64: torch.complex128}[blk.dtype]
        want = np.asarray(jblk.to_dense())
        assert want.dtype == blk.to_dense().dtype
        np.testing.assert_array_equal(blk.to_dense(), want)
        assert sym.block_hamiltonian(s, torch.float32) is blk
        assert (s, torch.float64) not in sym._sector_cache
        assert f64_twin(blk).to_dense().dtype == wide.to_dense().dtype
    if name == "translation":
        assert kinds == {torch.float32, torch.complex64}


@pytest.mark.parametrize("name", list(SYM_CASES))
def test_engine_float32_symmetry_refines_each_block(name):
    """The Engine with the symmetry labels in float32: every block solved
    in float32 or complex64 and refined against its float64 block, the
    lowest refined energy within 1e-10 of the JAX Engine's float64 E0,
    the eigenvector held in the solve's precision and a solution of the
    full Hamiltonian."""
    text, label = SYM_CASES[name]
    jinp = jax_parse(text + label)
    jeng = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    inp = parse_input(text + label)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=F32)
    assert abs(eng.ground_energy - jeng.ground_energy) <= \
        E0_BAR * abs(jeng.ground_energy)
    psi = eng.eigenvector(0)
    assert psi.dtype in (torch.float32, torch.complex64)
    full = eng.model.hamiltonian(eng.basis).to_dense()
    x = psi.numpy().astype(np.complex128)
    x /= np.linalg.norm(x)
    assert np.linalg.norm(full @ x - eng.ground_energy * x) <= 1e-4


# -- symmetry/projected: float32 weights and refined sectors ----------------

def test_projected_weights_and_sectors_float32_match_jax():
    """The 8-site Kitaev ring by projection in float32: the rotation
    weights rounded to float32 as JAX rounds them (bit for bit), each
    sector solved on the float32 form and refined against the float64
    form to 1e-10 of JAX's float64 sector energy, and each vector a clean
    sector vector."""
    n = 8
    text = kitaev_text(n, 1.1, 0.7, 0.9, periodic=1)
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    basis = model.create_basis(model.default_parts(inp))
    jbasis = jmodel.create_basis(jmodel.default_parts(jinp))
    ham64 = build_factored_kitaev(model, basis, dtype=torch.float64)
    proj = ProjectedTranslationSolver(narrowed(ham64), n, twin=ham64)
    jproj32 = JaxProjected(jax_build_factored_kitaev(jmodel, jbasis,
                                                     dtype=np.float32), n)
    jproj = JaxProjected(jax_build_factored_kitaev(jmodel, jbasis,
                                                   dtype=np.float64), n)
    for s in range(proj.sectors()):
        pk = proj.projected(s)
        assert pk.weights.dtype == torch.float32
        np.testing.assert_array_equal(pk.weights.numpy(),
                                      np.asarray(jproj32.projected(s).weights))
        wide = f64_twin(pk)
        assert wide.weights.dtype == torch.float64
        assert torch.equal(wide.weights.float(), pk.weights)
        evals, vecs, _ = proj.solve_sector(s, max_steps=120)
        jevals, _, _ = jproj.solve_sector(s, max_steps=120)
        assert vecs.dtype == torch.float32
        assert abs(evals[0] - jevals[0]) <= E0_BAR * abs(jevals[0])
        assert abs(proj.purity(s, vecs[0]) - 1.0) <= 1e-5


def test_engine_projected_kitaev_float32_matches_jax():
    """SolverOptions=projected through the Engine in float32 against the
    JAX Engine's projected float64 run: the refined E0 to 1e-10."""
    text = kitaev_text(8, 1.1, 0.7, 0.9, periodic=1).replace(
        "SolverOptions=none", "SolverOptions=projected") + \
        "UseTranslationSymmetry=1\n"
    jinp = jax_parse(text)
    jeng = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    inp = parse_input(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=F32)
    assert eng.eigenvector(0).dtype == torch.float32
    assert abs(eng.projected_purity - 1.0) <= 1e-5
    assert abs(eng.ground_energy - jeng.ground_energy) <= \
        E0_BAR * abs(jeng.ground_energy)


# -- end to end: the command lines in float32 against JAX's float64 --------

def _combs(where):
    out = []
    while (where / f"input.inp{len(out)}.comb").exists():
        out.append(where / f"input.inp{len(out)}.comb")
    return out


@pytest.mark.parametrize("pairs", ["TSPSites 2 0 1\n",
                                   "ComputeDensityOfStates=1\n"],
                         ids=["serial", "batched fleet"])
def test_cli_float32_spectral_matches_jax_float64(tmp_path, monkeypatch,
                                                  capsys, pairs):
    """lanczos --dtype float32 -g c on the 6-site chain against the JAX
    CLI in float64: the same .comb files, each fraction's ``#CFEnergy=``
    the refined E0 (1e-10), each collection's -Im G(w + 0.1i)/pi to 2e-3
    of its maximum; the fleet's fractions come from float32 coefficients
    (they differ from the float64 ones past float64 rounding)."""
    from lanczosplusplus_tpu.cli import lanczos_main as jax_main
    text = hubbard_chain_text(6) + "SpectralSteps=300\n" + pairs
    (_, _, pdir), (_, _, jdir) = _run_both(
        tmp_path, monkeypatch, capsys, lanczos_main.run, jax_main.run, text,
        ["-g", "c", "-p", "17"], port_args=("--device", "cpu", "--dtype",
                                            "float32"))
    got, want = _combs(pdir), _combs(jdir)
    assert len(got) == len(want) == (6 if "Density" in pairs else 1)
    worst = 0.0
    for g, w in zip(got, want):
        e0s = [float(x) for x in re.findall(r"#CFEnergy=(\S+)",
                                            g.read_text())]
        je0s = [float(x) for x in re.findall(r"#CFEnergy=(\S+)",
                                             w.read_text())]
        assert len(e0s) == len(je0s) > 0
        assert max(abs(a - b) for a, b in zip(e0s, je0s)) <= \
            E0_BAR * abs(je0s[0])
        coll, jcoll = read_collection(str(g)), jax_read_collection(str(w))
        assert [cf.meta for cf in coll.items] == \
            [cf.meta for cf in jcoll.items]
        a = -coll.evaluate(OMEGAS, 0.1).imag
        b = -np.asarray(jcoll.evaluate(OMEGAS, 0.1)).imag
        worst = max(worst, _rel(a, b))
        assert max(abs(cf.alphas[0] - jcf.alphas[0]) for cf, jcf in
                   zip(coll.items, jcoll.items)) > 1e-12
    assert worst <= DENSITY_BAR


@pytest.mark.parametrize("flag,suffix", [(["--kpm"], "kpmdos"),
                                         (["--ftlm-dos", "1.5"], "ftlmdos")],
                         ids=["kpm", "ftlm-dos"])
def test_cli_float32_estimators_match_jax_float64(tmp_path, monkeypatch,
                                                  capsys, flag, suffix):
    """lanczos --dtype float32 -g c --kpm and --ftlm-dos on the 6-site
    chain (FTLM from the JAX draws) against the JAX CLI in float64: the
    same header and grid, the densities (delta 0.1) to 2e-3 of their
    maximum."""
    from lanczosplusplus_tpu.cli import lanczos_main as jax_main
    _use_jax_draws(monkeypatch)
    text = hubbard_chain_text(6) + (
        "TSPSites 2 1 1\nKPMOmegaBegin=-8\nKPMOmegaStep=0.05\n"
        "KPMOmegaTotal=321\nKPMMoments=128\nFTLMOmegaBegin=-8\n"
        "FTLMOmegaStep=0.05\nFTLMOmegaTotal=321\nFTLMDelta=0.1\n"
        "FTLMVectors=4\nFTLMSteps=20\n")
    (_, _, pdir), (_, _, jdir) = _run_both(
        tmp_path, monkeypatch, capsys, lanczos_main.run, jax_main.run, text,
        ["-g", "c", *flag], port_args=("--device", "cpu", "--dtype",
                                       "float32"))
    got = (pdir / f"input.inp0.{suffix}").read_text()
    want = (jdir / f"input.inp0.{suffix}").read_text()
    assert got.splitlines()[:2] == want.splitlines()[:2]
    got, want = np.loadtxt(got.splitlines()), np.loadtxt(want.splitlines())
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.abs(want[:, 1]).max() > 0.05
    assert 0 < _rel(got[:, 1], want[:, 1]) <= DENSITY_BAR


def test_cli_float32_correlator_matches_jax_float64(tmp_path, monkeypatch,
                                                    capsys):
    """-c n and -c sz from the float32 state, scattered and multiplied in
    float32 (JAX engine.py:823-826), against the JAX CLI's float64
    matrices: 1e-5 of their maximum, and not equal to them."""
    from lanczosplusplus_tpu.cli import lanczos_main as jax_main
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, lanczos_main.run, jax_main.run,
        hubbard_chain_text(8), ["-c", "n", "-c", "sz", "-p", "17"],
        port_args=("--device", "cpu", "--dtype", "float32"))
    energies = [float(re.search(r"^Energy=(\S+)$", text, re.M).group(1))
                for text in (out, jout)]
    assert abs(energies[0] - energies[1]) <= E0_BAR * abs(energies[1])
    mats, jmats = ([np.array([float(x) for x in re.findall(
        r"[-+]?\d\.?\d*(?:e[-+]?\d+)?", block)]).reshape(8, 8)
        for block in re.findall(r"\[\[.*?\]\]", text, re.S)]
        for text in (out, jout))
    assert len(mats) == len(jmats) == 2
    diff = max(np.abs(a - b).max() for a, b in zip(mats, jmats))
    scale = max(np.abs(b).max() for b in jmats)
    assert 1e-13 < diff <= STATIC_BAR * scale


@pytest.mark.parametrize("text", [
    hubbard_chain_text(6) + "SpectralSteps=40\n",
    chain_text(6, 4, 3, 2, extra="UseTranslationSymmetry=1\n"
                                  "SpectralSteps=40\n")],
    ids=["float32 state", "complex64 momentum sector"])
def test_engine_float32_fleet_runs_in_the_states_type(text):
    """The batched scatter's plans, the fleet's start vectors and every
    operand its kernels see are of the state's type: float32, or complex64
    after a complex momentum sector (whose sector Hamiltonians are then
    built complex and narrowed); no float64 row is made."""
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    inp = parse_input(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=F32)
    dtype = eng.eigenvector(0).dtype
    assert dtype == (torch.complex64 if "Symmetry" in text
                     else torch.float32)
    assert eng.scalar_dtype == dtype
    parts = (eng.parts[0] + 1, eng.parts[1])
    valid, Z = eng._batched_modified_states(
        LabeledOperator("cdagger"), eng._cached_basis(parts),
        eng.eigenvector(0), 0, 0, dressed=False)
    assert Z.dtype == dtype and len(valid) == 6
    assert all(p[3].dtype == torch.float32
               for p in eng._scatter_plan_cache.values())
    seen = set()
    saved = kernels.factor_matmul, kernels.perm_gather

    def spy_gemm(x, a, out=None, accumulate=False):
        seen.add(x.dtype)
        return saved[0](x, a, out=out, accumulate=accumulate)

    def spy_gather(x, out, *args, **kwargs):
        seen.add(x.dtype)
        return saved[1](x, out, *args, **kwargs)
    kernels.factor_matmul, kernels.perm_gather = spy_gemm, spy_gather
    try:
        got = eng.spectral_functions_batched("c", [(0, 0), (0, 1)])
    finally:
        kernels.factor_matmul, kernels.perm_gather = saved
    assert seen == {dtype}
    assert eng._cached_hamiltonian(parts).dtype == dtype
    assert all(np.isfinite(coll.evaluate(OMEGAS, 0.1)).all()
               for coll, _ in got)


@pytest.mark.parametrize("flag", [[], ["--dos"], ["--beta", "0.8"]],
                         ids=["sq", "dos", "ftlm"])
def test_sqomega_float32_matches_jax_float64(tmp_path, monkeypatch, capsys,
                                             flag):
    """sqomega --dtype float32 (the 6-site Heisenberg ring's S(q, omega)
    at T = 0 and by FTLM from the JAX draws, N(i, omega) of input0's
    chain) against the JAX CLI in float64: 2e-3 of the maximum."""
    from lanczosplusplus_tpu.cli import sqomega_main as jax_sq
    from lanczosplusplus_tpu_torch.cli import sqomega_main
    _use_jax_draws(monkeypatch)
    text = INPUT0 if flag == ["--dos"] else heisenberg_text(6, 1, 3)
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, sqomega_main.run, jax_sq.run,
        text + "FTLMVectors=3\nFTLMSteps=12\n",
        ["-b", "-1", "-e", "4", "-s", "0.25", "-d", "0.1", *flag],
        port_args=("--device", "cpu", "--dtype", "float32"))
    got, want = np.asarray(_numbers(out)), np.asarray(_numbers(jout))
    assert got.shape == want.shape and got.shape[0] == 21
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert _rel(got[:, 1:], want[:, 1:]) <= DENSITY_BAR


def test_qpz_float32_matches_jax_float64(tmp_path, monkeypatch, capsys):
    """qpz --dtype float32: the second sector's ground state solved in
    float32 and refined, Z(k) from the float32 states to 1e-5 of the
    maximum of the JAX CLI's float64 values."""
    from lanczosplusplus_tpu.cli import qpz_main as jax_qpz
    from lanczosplusplus_tpu_torch.cli import qpz_main
    text = hubbard_chain_text(8).replace("potentialV 16 " + " ".join(
        ["0"] * 16), "potentialV 16 0.1 -0.2 0 0.3 " + " ".join(["0"] * 12))
    (out, _, _), (jout, _, _) = _run_both(
        tmp_path, monkeypatch, capsys, qpz_main.run, jax_qpz.run, text,
        ["--ratio"], port_args=("--device", "cpu", "--dtype", "float32"))
    got, want = np.asarray(_numbers(out)), np.asarray(_numbers(jout))
    assert got.shape == want.shape == (8, 2)
    assert _rel(got[:, 1], want[:, 1]) <= STATIC_BAR


def test_dynamics1_float32_matches_jax_float64(tmp_path, monkeypatch,
                                               capsys):
    """dynamics1 --dtype float32 on the 2-site FeAs sector: Energy= the
    refined E0 (printed to 8 digits, as JAX prints it), the fraction
    recurred in complex64, its function at delta 0.1 to 2e-3 of its
    maximum."""
    from lanczosplusplus_tpu.cli import dynamics1_main as jax_d1
    from lanczosplusplus_tpu_torch.cli import dynamics1_main
    (out, _, pdir), (jout, _, jdir) = _run_both(
        tmp_path, monkeypatch, capsys, dynamics1_main.run, jax_d1.run,
        feas_text(2, 2, "INT_PAPER33", [1.0, 0.5, -0.2, -0.1], 2, 2),
        ["-r", "1"], port_args=("--device", "cpu", "--dtype", "float32"))
    assert out.splitlines()[0] == jout.splitlines()[0]
    omegas = np.linspace(-2, 8, 101)
    vals = []
    for text, where in ((out, pdir), (jout, jdir)):
        (where / "out.comb").write_text(text)
        vals.append(-read_collection(str(where / "out.comb"))
                    .evaluate(omegas, 0.1).imag)
    assert 0 < _rel(vals[0], vals[1]) <= DENSITY_BAR


def test_chebyshev_time_from_a_float32_state():
    """Chebyshev time evolution of the float32 ground state (a dynamics1
    engine's): complex64 on the float32 form, the autocorrelation to 1e-5
    of the JAX package's float64 evolution of the same state."""
    text = hubbard_chain_text(6)
    inp, jinp = parse_input(text), jax_parse(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp, config=F32)
    psi = eng.eigenvector(0)
    assert psi.dtype == torch.float32
    times = np.linspace(0.0, 2.0, 5)
    bounds = (-8.0, 12.0)
    got = tct.autocorrelation(eng.hamiltonian, psi, times, bounds=bounds)
    jham = jax_build_model(jinp, JaxGeometry(jinp)).hamiltonian(
        jax_build_model(jinp, JaxGeometry(jinp)).create_basis(
            eng.parts), dtype=np.float64)
    want = np.asarray(jax_ct.autocorrelation(
        jham, psi.numpy().astype(np.float64), times, bounds=bounds))
    psi_t = tct.evolve(eng.hamiltonian, psi, times[:2], bounds=bounds)
    assert psi_t.dtype == np.complex64
    assert _rel(got, want) <= STATIC_BAR
    # E0 phase: C(t) = exp(-i E0 t) for an eigenstate
    np.testing.assert_allclose(
        got, np.exp(-1j * eng.ground_energy * times), atol=1e-4)
