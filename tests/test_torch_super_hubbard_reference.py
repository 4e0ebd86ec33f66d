"""The t-U-J ring (Model=SuperHubbardExtended) against the benchmark's plain
reference (``portbench/reference/super_hubbard.py``): the port's
Hamiltonian on seeded random blocks, the reference's reduction to the
one-band Hubbard reference at J = W = 0 and to the Heisenberg reference at
t = 0 and large U, the exchange's sign on two sites by hand, its nonzero
count against the dense matrix, and the port's ``build.exchange_entries``
counter."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.utils import progress
from portbench.reference import sector
from portbench.tests.test_portbench_reference import dense, heisenberg_text

CONFIG = Path(__file__).resolve().parent.parent / "portbench" / "configs" \
    / "superhubbard12.json"


def chain_text(nsite, periodic, nup, ndn, model, terms, u):
    """An input of `model` on a chain with one constant coupling a term."""
    lines = [f"TotalNumberOfSites={nsite}", f"NumberOfTerms={len(terms)}"]
    for value in terms:
        lines += ["DegreesOfFreedom=1", "GeometryKind=chain",
                  "GeometryOptions=ConstantValues", f"Connectors 1 {value}"]
    return "\n".join(lines + [
        f"Model={model}", f"hubbardU {nsite} " + " ".join([str(u)] * nsite),
        f"potentialV {2 * nsite} " + " ".join(["0"] * (2 * nsite)),
        "SolverOptions=none", f"TargetElectronsUp={nup}",
        f"TargetElectronsDown={ndn}", f"IsPeriodicX={int(periodic)}"]) + "\n"


def super_text(nsite, periodic, nup, ndn, t=-1.0, u=8.0, w=-0.125, j=0.5):
    return chain_text(nsite, periodic, nup, ndn, "SuperHubbardExtended",
                      [t, w, j], u)


def port_hamiltonian(text):
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    return model.hamiltonian(model.create_basis(model.default_parts(inp)),
                             device="cpu")


def block(dim, rows=3, seed=7):
    return torch.randn(rows, dim, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))


def rel_gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


GEOMETRIES = [(6, True, 3, 3), (6, False, 3, 3), (6, True, 2, 5),
              (8, True, 4, 4), (8, False, 4, 3), (8, True, 2, 5)]
COUPLINGS = [(-1.0, 8.0, -0.125, 0.5), (-0.7, 3.0, 0.4, 1.3),
             (0.5, 0.0, 0.0, 2.0)]


@pytest.mark.parametrize("couplings", COUPLINGS)
@pytest.mark.parametrize("nsite,periodic,nup,ndn", GEOMETRIES)
def test_port_equals_reference(nsite, periodic, nup, ndn, couplings):
    t, u, w, j = couplings
    text = super_text(nsite, periodic, nup, ndn, t, u, w, j)
    sec = sector("super_hubbard", text, "cpu")
    ham = port_hamiltonian(text)
    assert ham.dim == sec.dim
    x = block(sec.dim)
    assert rel_gap(ham.matmat_t(x), sec.apply(x)) <= 1e-13


@pytest.mark.parametrize("nsite,periodic,nup,ndn", GEOMETRIES[:3])
def test_without_exchange_it_is_the_one_band_reference(nsite, periodic, nup,
                                                       ndn):
    sec = sector("super_hubbard", super_text(nsite, periodic, nup, ndn,
                                             u=4.0, w=0.0, j=0.0), "cpu")
    ref = sector("hubbard_one_band", chain_text(
        nsite, periodic, nup, ndn, "HubbardOneBand", [-1.0], 4.0), "cpu")
    assert sec.exchange_entries() == 0
    x = block(sec.dim)
    assert rel_gap(sec.apply(x), ref.apply(x)) <= 1e-15


def test_strong_coupling_ring_is_the_heisenberg_ring():
    """At t = 0 the singly occupied states do not mix with the others, and
    U = 20 puts every doubly occupied one far above them: the lowest level
    is J E0(Heisenberg ring) + W x 6 bonds, each n_i n_j = 1."""
    j, w = 1.3, -0.4
    sec = sector("super_hubbard", super_text(6, True, 3, 3, t=0.0, u=20.0,
                                             w=w, j=j), "cpu")
    heis = sector("heisenberg", heisenberg_text(6), "cpu")
    e0 = np.linalg.eigvalsh(dense(sec))[0]
    e0_heis = np.linalg.eigvalsh(dense(heis))[0]
    assert e0 == pytest.approx(j * e0_heis + 6 * w, rel=1e-13)


def test_exchange_sign_on_two_sites_by_hand():
    """Two sites, one fermion a spin: S+_0 S-_1 takes |up at 1, dn at 0> =
    c^dag_{1 up} c^dag_{0 dn}|0> to -c^dag_{0 up} c^dag_{1 dn}|0> (the
    reference's docstring), so the entry is -J/2; the diagonal of each is
    J Sz_0 Sz_1 + W = -J/4 + W."""
    j, w = 0.8, 0.3
    sec = sector("super_hubbard", super_text(2, False, 1, 1, t=0.0, u=5.0,
                                             w=w, j=j), "cpu")
    h = dense(sec)
    # entry iu + id * 2: up word 0b01 is index 0 (site 0), 0b10 index 1
    up1_dn0, up0_dn1 = 1 + 0 * 2, 0 + 1 * 2
    assert h[up0_dn1, up1_dn0] == h[up1_dn0, up0_dn1] == -j / 2
    assert h[up1_dn0, up1_dn0] == h[up0_dn1, up0_dn1] == pytest.approx(
        -j / 4 + w, rel=1e-15)
    # doubly occupied: U, and no n_0 n_1 or Sz_0 Sz_1
    assert h[0, 0] == h[3, 3] == 5.0
    assert np.count_nonzero(h) == 6


@pytest.mark.parametrize("text", [
    super_text(6, True, 3, 3), super_text(6, False, 2, 5, -0.7, 3.0, 0.4,
                                          1.3),
    super_text(6, True, 3, 3, 0.5, 0.0, 0.0, 2.0)])
def test_nonzeros_are_the_dense_matrix_s(text):
    sec = sector("super_hubbard", text, "cpu")
    assert sec.nonzeros() == np.count_nonzero(dense(sec))


@pytest.mark.parametrize("nsite,periodic,nup,ndn", GEOMETRIES)
def test_exchange_entries_counter(nsite, periodic, nup, ndn):
    """Once a sector built: the reference's exchange entries, and 0 for the
    one-band model, which has no exchange."""
    text = super_text(nsite, periodic, nup, ndn)
    progress.reset()
    port_hamiltonian(text)
    built = progress.COUNTS["build.exchange_entries"]
    assert built == sector("super_hubbard", text, "cpu").exchange_entries()
    assert built > 0
    progress.reset()
    one_band = port_hamiltonian(chain_text(nsite, periodic, nup, ndn,
                                           "HubbardOneBand", [-1.0], 8.0))
    assert one_band.ell is None
    assert progress.COUNTS == {"build.exchange_entries": 0}
    progress.reset()


def test_the_cell_s_sizes():
    """The configuration's stated sizes, counted without building the
    12-site sector."""
    from math import comb

    config = json.loads(CONFIG.read_text())
    sizes = config["sizes"]
    words = comb(12, 6)
    assert sizes["one_spin_words"] == words
    assert sizes["dim"] == words * words
    # a bond exchanges where each word holds one of its two sites, the up
    # word the other one than the down word: 2 C(10, 5)^2 a bond
    assert sizes["exchange_entries"] == (
        sizes["j_bonds"] * 2 * comb(10, 5) ** 2)
    assert config["reduced"] == []
