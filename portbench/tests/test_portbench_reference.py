"""The plain reference on small sectors: its work counts against hand
counts, its E0 and FTLM against closed forms and dense diagonalization,
and its apply against the port's."""

from math import comb

import numpy as np
import pytest
import torch

from portbench import work
from portbench.reference import sector, solvers
from portbench.tests.tiny import SMALL


def hubbard_text(nsite, u, nup, ndn):
    return "\n".join([
        f"TotalNumberOfSites={nsite}", "NumberOfTerms=1",
        "DegreesOfFreedom=1", "GeometryKind=chain",
        "GeometryOptions=ConstantValues", "Connectors 1 -1.0",
        "Model=HubbardOneBand",
        f"hubbardU {nsite} " + " ".join([str(u)] * nsite),
        f"potentialV {2 * nsite} " + " ".join(["0"] * (2 * nsite)),
        "SolverOptions=none", f"TargetElectronsUp={nup}",
        f"TargetElectronsDown={ndn}", "IsPeriodicX=1"]) + "\n"


def heisenberg_text(nsite):
    term = ["DegreesOfFreedom=1", "GeometryKind=chain",
            "GeometryOptions=ConstantValues", "Connectors 1 1.0"]
    return "\n".join([f"TotalNumberOfSites={nsite}", "NumberOfTerms=2",
                      *term, *term, "Model=Heisenberg",
                      "HeisenbergTwiceS=1", "SolverOptions=none",
                      f"TargetSzPlusConst={nsite // 2}",
                      "IsPeriodicX=1"]) + "\n"


def dense(sec) -> np.ndarray:
    eye = torch.eye(sec.dim, dtype=torch.float64)
    return sec.apply(eye).numpy().T


def test_hubbard_chain_nonzeros_by_hand():
    # 6-site ring, 3 up 3 down: a bond's hop is allowed from the words
    # that hold one of its two sites, 2 C(4, 2) of the C(6, 3) words
    sec = sector("hubbard_one_band", hubbard_text(6, 4, 3, 3), "cpu")
    words = comb(6, 3)
    hops = 6 * 2 * comb(4, 2)
    assert sec.dim == words * words == 400
    assert sec.nonzeros() == sec.dim + 2 * hops * words == 3280


def test_heisenberg_ring_nonzeros_by_hand():
    # 8-site ring at Sz = 0: a bond exchanges where its spins differ,
    # in 2 C(6, 3) of the C(8, 4) words
    sec = sector("heisenberg", heisenberg_text(8), "cpu")
    assert sec.dim == comb(8, 4) == 70
    assert sec.nonzeros() == 70 + 8 * 2 * comb(6, 3) == 390


def test_work_and_least_time_by_hand():
    f64 = torch.float64
    row = work.per_row(dim=1000, nonzeros=5000, dtype=f64)
    assert row == {"bytes": 16000, "flops": 10000}
    assert work.per_row(1000, 5000, torch.complex128)["bytes"] == 32000
    card = "NVIDIA H100 80GB HBM3"
    seconds, bound = work.least_s(10, row, card, f64)
    assert bound == "bytes" and seconds == pytest.approx(160000 / 3.35e12)
    seconds, bound = work.least_s(1, {"bytes": 8, "flops": 1e9}, card, f64)
    assert bound == "flops" and seconds == pytest.approx(1e9 / 6.7e13)
    # no reading where the table has no peak: another card, another type
    assert work.least_s(1, row, "some other card", f64) is None
    assert work.least_s(1, row, card, torch.complex128) is None


def test_hubbard_free_fermions_e0():
    # U = 0: each spin fills the three lowest of -2 cos(2 pi k / 6)
    sec = sector("hubbard_one_band", hubbard_text(6, 0, 3, 3), "cpu")
    assert solvers.lowest_energy(sec) == pytest.approx(-8.0, rel=1e-13)


@pytest.mark.parametrize("name,text", [
    ("hubbard_one_band", hubbard_text(6, 4, 3, 3)),
    ("hubbard_one_band", hubbard_text(5, 4, 3, 2)),
    ("heisenberg", heisenberg_text(8)),
    ("heisenberg", heisenberg_text(10))])
def test_e0_against_dense_eigh(name, text):
    sec = sector(name, text, "cpu")
    h = dense(sec)
    assert np.abs(h - h.T).max() == 0.0
    exact = np.linalg.eigvalsh(h)[0]
    assert solvers.lowest_energy(sec) == pytest.approx(exact, rel=1e-12)


def test_heisenberg_four_site_ring_closed_form():
    # E0 = -2 J for the 4-site S = 1/2 ring
    sec = sector("heisenberg", heisenberg_text(4), "cpu")
    assert solvers.lowest_energy(sec) == pytest.approx(-2.0, rel=1e-13)


def test_ftlm_with_a_complete_basis_is_exact():
    sec = sector("heisenberg", heisenberg_text(6), "cpu")
    values = np.linalg.eigvalsh(dense(sec))
    betas = [0.1, 1.0, 7.0]
    energy, log_z = solvers.ftlm(sec, torch.eye(sec.dim, dtype=torch.float64),
                                 betas, sec.dim)
    for b, e, lz in zip(betas, energy, log_z):
        w = np.exp(-b * values)
        assert lz == pytest.approx(np.log(w.sum()), rel=1e-12)
        assert e == pytest.approx((w * values).sum() / w.sum(), rel=1e-12)


def test_pair_gap():
    sec = sector("heisenberg", heisenberg_text(8), "cpu")
    values, vectors = np.linalg.eigh(dense(sec))
    v = torch.as_tensor(vectors[:, 0])
    assert solvers.pair_gap(sec, values[0], v, values[0]) < 1e-14
    assert solvers.pair_gap(sec, values[0] * (1 + 1e-6), v, values[0]) \
        == pytest.approx(1e-6, rel=1e-3)
    assert solvers.pair_gap(sec, values[1], torch.as_tensor(vectors[:, 1]),
                            values[0]) > 1e-3


@pytest.mark.parametrize("config", sorted(SMALL))
def test_apply_matches_the_port(config):
    """The reference's basis order and signs are the port's: the same
    apply on random rows (the port's plain CPU path)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import _schedule_ham
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    text = (hubbard_text(6, 4, 3, 3) if config == "hubbard6"
            else heisenberg_text(8))
    inp = parse_input(text)
    ham = _schedule_ham(build_model(inp, Geometry(inp)), inp, "cpu")
    sec = sector("hubbard_one_band" if config == "hubbard6" else
                 "heisenberg", text, "cpu")
    x = torch.randn(3, sec.dim, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    assert torch.allclose(sec.apply(x), ham.matmat_t(x), rtol=0,
                          atol=1e-13)


def test_reference_refuses_what_it_does_not_read():
    with pytest.raises(ValueError):
        sector("heisenberg", heisenberg_text(8).replace(
            "HeisenbergTwiceS=1", "HeisenbergTwiceS=2"), "cpu")
    with pytest.raises(ValueError):
        sector("hubbard_one_band", hubbard_text(6, 4, 3, 3).replace(
            "GeometryKind=chain", "GeometryKind=ladder"), "cpu")
