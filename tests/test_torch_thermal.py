"""The port's thermal engines (engine/thermal.py) held against the JAX
package's on the CPU: full spectra, the ExactDiag schedule, the
grand-canonical sweep with its correlator poles, and GrandCanonicalFTLM
(dense sectors, and FTLM sectors from the JAX package's start blocks).
Tolerances: eigenvalues and thermal averages to 1e-10 relative; pole
lists through their sum and first moments (eigenvectors of a degenerate
level differ between the two eigensolvers, so single poles are not
compared) to 1e-10; FTLM sectors to 1e-10 relative."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.engine import thermal as jthermal
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch.engine import thermal as tthermal
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_ftlm import jax_block
from test_torch_host import hubbard_chain_text
from test_torch_inputs import heisenberg_text, rashba_text, tj_text

torch.set_num_threads(2)

SCHEDULE = ("TemperatureOrBeta=beta\nTemperatureOrBetaStart=0.1\n"
            "TemperatureOrBetaTotal=5\nTemperatureOrBetaStep=0.5\n")


def models(text):
    inp, jinp = parse_input(text), jax_parse(text)
    return (inp, build_model(inp, Geometry(inp)), jinp,
            jax_build_model(jinp, JaxGeometry(jinp)))


def close(got, want, tol=1e-10):
    return abs(got - want) <= tol * max(abs(want), 1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_full_spectrum_matches_jax(dtype):
    text = hubbard_chain_text(6, periodic=False) if not dtype.is_complex \
        else rashba_text(4, 4, r="(0.3,0.4)", periodic=1,
                         options="useComplex")
    inp, model, jinp, jmodel = models(text)
    parts = model.default_parts(inp)
    spec = tthermal.full_spectrum(model, model.create_basis(parts),
                                  dtype=dtype, device="cpu")
    jspec = jthermal.full_spectrum(
        jmodel, jmodel.create_basis(parts),
        dtype=np.complex128 if dtype.is_complex else np.float64)
    np.testing.assert_allclose(spec.evals, jspec.evals, rtol=1e-10,
                               atol=1e-12)
    assert spec.nelectrons == jspec.nelectrons
    assert spec.evecs.shape == jspec.evecs.shape


def test_exact_diag_schedule_matches_jax():
    text = hubbard_chain_text(6, periodic=False) + SCHEDULE
    inp, model, jinp, jmodel = models(text)
    ed = tthermal.ExactDiag(model, inp, device="cpu")
    jed = jthermal.ExactDiag(jmodel, jinp)
    got, want = ed.schedule(), jed.schedule()
    assert [tb for tb, _ in got] == [tb for tb, _ in want]
    for (_, e), (_, je) in zip(got, want):
        assert close(e, je)


@pytest.mark.parametrize("kind,text", [
    ("hubbard", hubbard_chain_text(3, u=3.0, periodic=False)),
    ("tj", tj_text(4, 2, 1, j=0.4)),
    ("heisenberg", heisenberg_text(5, 1, 2, periodic=0))],
    ids=["hubbard", "tj", "heisenberg"])
def test_grand_canonical_matches_jax(kind, text):
    _, model, _, jmodel = models(text)
    gc = tthermal.GrandCanonical(model, model.geometry.number_of_sites(),
                                 kind=kind, device="cpu")
    jgc = jthermal.GrandCanonical(jmodel, model.geometry.number_of_sites(),
                                  kind=kind)
    assert [s.parts for s in gc.sectors] == [s.parts for s in jgc.sectors]
    for beta, mu in ((0.4, 0.0), (1.3, 0.7)):
        assert close(gc.partition(beta, mu, 0.2),
                     jgc.partition(beta, mu, 0.2))
        assert close(gc.density(beta, mu), jgc.density(beta, mu))
        assert close(gc.energy(beta, mu), jgc.energy(beta, mu))


@pytest.mark.parametrize("op_name,sites", [("c", (0, 0)), ("c", (0, 2)),
                                           ("cdagger", (1, 1))])
def test_correlation_poles_match_jax(op_name, sites):
    _, model, _, jmodel = models(hubbard_chain_text(3, u=2.0,
                                                    periodic=False))
    gc = tthermal.GrandCanonical(model, 3, device="cpu")
    jgc = jthermal.GrandCanonical(jmodel, 3)
    poles, total = gc.correlation_poles(op_name, sites, 0, 2.0, 0.4)
    jpoles, jtotal = jgc.correlation_poles(op_name, sites, 0, 2.0, 0.4)
    assert close(total, jtotal)
    om, w = np.asarray(poles).T
    jom, jw = np.asarray(jpoles).T
    for k in range(3):
        assert close((w * om ** k).sum(), (jw * jom ** k).sum())


def test_grand_canonical_ftlm_dense_path_matches_jax():
    """dense_cutoff covering every sector: exact, and equal to the JAX
    package's; a beta off the grid raises in both."""
    _, model, _, jmodel = models(hubbard_chain_text(3, u=3.0,
                                                    periodic=False))
    gf = tthermal.GrandCanonicalFTLM(model, 3, [0.4, 1.3],
                                     dense_cutoff=1 << 20, device="cpu")
    jgf = jthermal.GrandCanonicalFTLM(jmodel, 3, [0.4, 1.3],
                                      dense_cutoff=1 << 20)
    for beta in (0.4, 1.3):
        for mu in (0.0, 0.7):
            for q in ("log_partition", "energy", "density",
                      "specific_heat"):
                assert close(getattr(gf, q)(beta, mu),
                             getattr(jgf, q)(beta, mu)), q
    for g in (gf, jgf):
        with pytest.raises(ValueError, match="not on the construction"):
            g.energy(0.9, 0.0)


@pytest.mark.parametrize("factored", [False, True])
def test_grand_canonical_ftlm_sectors_match_jax(monkeypatch, factored):
    """Sectors past dense_cutoff through FTLM, each from the JAX package's
    draw (the port's random_start_block replaced by it): the flat
    Hubbard sweep, and the factored Heisenberg sweep in block order."""
    monkeypatch.setattr(lz, "random_start_block",
                        lambda dim, num, seed, dtype, device: torch.as_tensor(
                            jax_block(dim, num, seed, dtype)))
    if factored:
        text, kind, n = heisenberg_text(8, 1, 4, periodic=0), \
            "heisenberg", 8
    else:
        text, kind, n = hubbard_chain_text(4, periodic=False), "hubbard", 4
    _, model, _, jmodel = models(text)
    args = dict(kind=kind, dense_cutoff=8, num_vectors=4, steps=12,
                factored=factored)
    gf = tthermal.GrandCanonicalFTLM(model, n, [0.5, 2.0], device="cpu",
                                     **args)
    jgf = jthermal.GrandCanonicalFTLM(jmodel, n, [0.5, 2.0], **args)
    for beta in (0.5, 2.0):
        for mu in (0.0, 0.5):
            for q in ("log_partition", "energy", "density",
                      "specific_heat"):
                assert close(getattr(gf, q)(beta, mu),
                             getattr(jgf, q)(beta, mu)), q


def test_grand_canonical_ftlm_mesh_raises(tmp_path):
    """``GrandCanonicalFTLM(mesh=...)`` once raised; it now row-shards
    each large sector's FTLM recurrence over the mesh.  On a gloo world
    of 2 ranks, every rank's sweep equals the single-device sweep from the
    same blocks (the JAX package's own bar, tests/test_distributed.py:
    629-660: 1e-8, the specific heat 1e-6)."""
    from lanczosplusplus_tpu_torch.parallel.dryrun import hubbard_text
    from torch_world import run_world

    ranks = run_world(2, "torch_parallel_paths:grand_canonical", tmp_path)
    _, model, _, _ = models(hubbard_text(4, 2, 2, periodic=0))
    gf = tthermal.GrandCanonicalFTLM(model, 4, [0.5, 2.0], dense_cutoff=8,
                                     num_vectors=8, steps=24, device="cpu")
    for got in ranks:
        for (beta, mu), values in got.items():
            for q, value in values.items():
                want = getattr(gf, q)(beta, mu)
                tol = 1e-6 if q == "specific_heat" else 1e-8
                assert abs(value - want) <= tol * max(abs(want), 1e-4), q


def test_cuda_without_card_raises(monkeypatch):
    """The thermal engines run on the card by default; without one they
    raise and never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp, model, _, _ = models(hubbard_chain_text(2, periodic=False)
                              + SCHEDULE)
    with pytest.raises(RuntimeError, match="cuda"):
        tthermal.ExactDiag(model, inp)
    with pytest.raises(RuntimeError, match="cuda"):
        tthermal.GrandCanonical(model, 2)
