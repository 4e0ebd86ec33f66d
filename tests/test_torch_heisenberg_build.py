"""The S = 1/2 Heisenberg sector built from combinadic ranks: the tables
that ``HeisenbergModel._spin_half_hamiltonian`` builds in torch held bit for
bit against the generic numpy build (``_generic_hamiltonian``) on rings,
a ladder and a chain with couplings beyond nearest neighbours (bonds with
set bits between their sites, wrap bonds among them), with a field and an
anisotropy, in the empty, one-spin, half and full sectors, in float64 and
complex128; and the S = 1/2 basis, enumerated as combinations, against the
per-site DP and ``searchsorted`` over its words.

Every coupling, field and anisotropy below is a dyadic fraction, so every
term of the diagonal and each of its partial sums is exact and the bond
sum equals the generic ``einsum`` in any order; one case with decimal
couplings holds the diagonal to a tolerance fixed from float64's epsilon."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu_torch.core.combinatorics import (
    binomial_table, rank_combinations)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.heisenberg import (
    HeisenbergBasis, _enumerate_digits)
from lanczosplusplus_tpu_torch.utils import progress
from test_torch_inputs import heisenberg_text

torch.set_num_threads(2)


def _terms(kind, connectors, extra=""):
    term = (f"DegreesOfFreedom=1\nGeometryKind={kind}\n"
            f"GeometryOptions=ConstantValues\n{extra}{connectors}\n")
    return term + term


def _longrange(n, couplings):
    """An n x n ``Connectors`` matrix with couplings[d - 1] on every bond
    of distance d around the ring."""
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            d = min(abs(i - j), n - abs(i - j))
            row.append(couplings[d - 1] if 0 < d <= len(couplings) else 0)
        rows.append(" ".join(str(v) for v in row))
    return f"Connectors {n} {n}\n" + "\n".join(rows)


def _text(n, geometry, extra=""):
    """A two-term (Jpm, Jzz) S = 1/2 Heisenberg input, its sector line
    left for the test to add."""
    return (f"TotalNumberOfSites={n}\nNumberOfTerms=2\n" + geometry
            + "Model=Heisenberg\nHeisenbergTwiceS=1\nSolverOptions=none\n"
              "IsPeriodicX=1\n" + extra)


GEOMETRIES = {
    "ring10": (10, _text(10, _terms("chain", "Connectors 1 1.0"))),
    "ring12": (12, _text(12, _terms("chain", "Connectors 1 0.75"))),
    "ring16": (16, _text(16, _terms("chain", "Connectors 1 1.0"))),
    # legs i -- i + 2 and rungs, both legs wrapping round
    "ladder12": (12, _text(12, _terms("ladder", "Connectors 2 1.0 0.5"),
                           "LadderLeg=2\n")),
    # J1, J2, J3 round the ring: bonds across one and two sites
    "longrange10": (10, _text(10, _terms(
        "longrange", _longrange(10, [1.0, 0.5, -0.25])))),
    "field_aniso10": (10, _text(
        10, _terms("chain", "Connectors 1 1.0"),
        "MagneticField 10 0.25 -0.5 0 0.125 0 0 1.5 0 0 0.75\n"
        "AnisotropyD 10 0.5 0.5 0.25 0.5 0.5 0 0.5 0.5 0.5 -1.0\n")),
}

SECTORS = ["empty", "one", "half", "full"]


def _sector(n, which):
    return {"empty": 0, "one": 1, "half": n // 2, "full": n}[which]


def _model_and_basis(text, szpc):
    inp = parse_input(text + f"TargetSzPlusConst={szpc}\n")
    model = build_model(inp, Geometry(inp))
    return model, model.create_basis(model.default_parts(inp))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["float64", "complex128"])
@pytest.mark.parametrize("sector", SECTORS)
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_spin_half_tables_bit_equal_to_generic(name, sector, dtype):
    n, text = GEOMETRIES[name]
    model, basis = _model_and_basis(text, _sector(n, sector))
    built = progress.COUNTS.get("build.combinadic", 0)
    ham = model.hamiltonian(basis, dtype=dtype)
    assert progress.COUNTS.get("build.combinadic", 0) == built + 1
    generic = model._generic_hamiltonian(basis, dtype=dtype)
    for new, old in ((ham.ell.cols, generic.ell.cols),
                     (ham.ell.vals, generic.ell.vals),
                     (ham.diag, generic.diag)):
        assert new.dtype == old.dtype and new.shape == old.shape
        assert new.is_contiguous()
        assert torch.equal(new, old)
    assert ham.ell.cols.dtype == torch.int32
    assert ham.factorized is None and ham.spin_shape is None


def test_spin_half_decimal_couplings_diagonal_to_rounding():
    """Decimal couplings and field: cols and vals bit-equal, the diagonal
    (a bond sum in another order than the generic einsum) within n^2 ulps
    of its largest term's scale."""
    text = _text(10, _terms("longrange", _longrange(10, [1.0, 0.3, 0.1])),
                 "MagneticField 10 0.1 0.2 0 0 0.3 0 0 0 0.7 0\n"
                 "AnisotropyD=0.4\n")
    model, basis = _model_and_basis(text, 5)
    ham = model.hamiltonian(basis)
    generic = model._generic_hamiltonian(basis)
    assert torch.equal(ham.ell.cols, generic.ell.cols)
    assert torch.equal(ham.ell.vals, generic.ell.vals)
    scale = float(generic.diag.abs().max())
    tol = 10 * 10 * torch.finfo(torch.float64).eps * max(scale, 1.0)
    assert float((ham.diag - generic.diag).abs().max()) <= tol


@pytest.mark.parametrize("twice_s", [2, 3])
def test_spin_one_and_above_keep_the_generic_build(twice_s):
    text = heisenberg_text(6, twice_s, 6 * twice_s // 2)
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    built = progress.COUNTS.get("build.combinadic", 0)
    ham = model.hamiltonian(basis)
    assert progress.COUNTS.get("build.combinadic", 0) == built
    generic = model._generic_hamiltonian(basis)
    assert torch.equal(ham.ell.cols, generic.ell.cols)
    assert torch.equal(ham.ell.vals, generic.ell.vals)
    assert torch.equal(ham.diag, generic.diag)


@pytest.mark.parametrize("n", [10, 12, 16, 20])
@pytest.mark.parametrize("sector", SECTORS)
def test_spin_half_basis_matches_dp_and_searchsorted(n, sector):
    """Words, digits and ranks (of a random subset and of every hopped
    word of three bonds, the wrap bond among them) as the per-site DP and
    searchsorted over its words give them, and the combinadic ranks."""
    szpc = _sector(n, sector)
    basis = HeisenbergBasis(n, 1, szpc)
    words = _enumerate_digits(n, 1, 1, szpc)
    assert basis.words.dtype == words.dtype
    np.testing.assert_array_equal(basis.words, words)
    digits = ((words[:, None] >> np.arange(n, dtype=np.uint64)) & 1)
    np.testing.assert_array_equal(basis.digits, digits.astype(np.int8))
    rng = np.random.default_rng(n * 100 + szpc)
    queries = [rng.choice(words, size=min(len(words), 500))]
    for i, j in ((0, 1), (n // 2, 2), (0, n - 1)):
        hop = ((words >> np.uint64(i)) & 1 == 0) & \
            ((words >> np.uint64(j)) & 1 == 1)
        queries.append(words[hop] ^ np.uint64((1 << i) | (1 << j)))
    table = binomial_table(n + 1)
    for q in queries:
        ranks = basis.rank(q)
        np.testing.assert_array_equal(ranks, np.searchsorted(words, q))
        np.testing.assert_array_equal(ranks,
                                      rank_combinations(q, n, table))
        np.testing.assert_array_equal(words[ranks], q)


def test_out_of_range_sector_is_empty():
    for szpc in (-1, 7):
        assert HeisenbergBasis(6, 1, szpc).size == 0
        assert HeisenbergBasis(6, 1, szpc).size == \
            _enumerate_digits(6, 1, 1, szpc).size
