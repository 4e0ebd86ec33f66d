"""Host layer of the PyTorch port held against the JAX package: parsed
inputs, geometry coupling matrices, validation verdicts, one-spin words,
ranks and occupation tables.  Also the inline input texts that the other
``test_torch_*`` files share."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.core.basis import HubbardBasis as JaxHubbardBasis
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_ import input_check as jax_check
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu_torch.core.basis import HubbardBasis
from lanczosplusplus_tpu_torch.core import bits, combinatorics
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_ import input_check
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input

torch.set_num_threads(2)

# TestSuite input0 (4-site open chain, U=0), as inlined in
# benchmarks/onchip_correctness.py
INPUT0 = """
TotalNumberOfSites=4
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 4 0 0 0 0
potentialV 8 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=0
"""
E0_INPUT0 = -4.472135954999581  # benchmarks/goldens.json e0_input0


def hubbard_chain_text(nsite: int, u: float = 4.0, periodic: bool = True):
    """Half-filled one-band Hubbard chain, t = -1 (the bench's sector)."""
    return f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU {nsite} {" ".join([str(u)] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nsite // 2}
TargetElectronsDown={nsite // 2}
IsPeriodicX={int(periodic)}
"""


def super_hubbard_text(nsite: int, periodic: bool = False):
    """Half-filled SuperHubbardExtended chain with hopping, n_i n_j and J
    terms, shaped like tests/test_hubbard.py's 4-site oracle input."""
    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {}
"""
    pot = [0.1, -0.2, 0.3] + [0.0] * (2 * nsite - 3)
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + term.format(-1.0) + term.format(0.7) + term.format(1.3)
            + f"Model=SuperHubbardExtended\n"
              f"hubbardU {nsite} {' '.join(['2'] * nsite)}\n"
              f"potentialV {2 * nsite} {' '.join(map(str, pot))}\n"
              f"SolverOptions=none\nTargetElectronsUp={nsite // 2}\n"
              f"TargetElectronsDown={nsite // 2}\n"
              f"IsPeriodicX={int(periodic)}\n")


TEXTS = {"input0": INPUT0, "chain8": hubbard_chain_text(8),
         "super4": super_hubbard_text(4)}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parsed_entries_equal(name):
    assert parse_input(TEXTS[name]).entries == \
        jax_parse(TEXTS[name]).entries


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_coupling_matrices_equal(name):
    inp, jinp = parse_input(TEXTS[name]), jax_parse(TEXTS[name])
    geom, jgeom = Geometry(inp), JaxGeometry(jinp)
    assert geom.terms() == jgeom.terms()
    for t in range(geom.terms()):
        np.testing.assert_array_equal(geom.coupling_matrix(t),
                                      jgeom.coupling_matrix(t))


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_words_ranks_occupations_equal(name):
    inp = parse_input(TEXTS[name])
    n = inp.integer("TotalNumberOfSites")
    nup = inp.integer("TargetElectronsUp")
    ndn = inp.integer("TargetElectronsDown")
    basis, jbasis = HubbardBasis(n, nup, ndn), JaxHubbardBasis(n, nup, ndn)
    assert basis.spin_shape == jbasis.spin_shape
    for ours, theirs in ((basis.up, jbasis.up), (basis.down, jbasis.down)):
        np.testing.assert_array_equal(ours.words, theirs.words)
        np.testing.assert_array_equal(ours.rank(ours.words),
                                      np.arange(ours.size))
        np.testing.assert_array_equal(ours.rank(ours.words),
                                      theirs.rank(theirs.words))
        np.testing.assert_array_equal(ours.occupation_table(),
                                      theirs.occupation_table())
        assert np.all(bits.popcount(ours.words) == ours.npart)


def test_unrank_inverts_rank():
    words = combinatorics.enumerate_combinations(10, 4)
    assert words.size == combinatorics.comb(10, 4) == 210
    np.testing.assert_array_equal(
        combinatorics.unrank_combinations(
            combinatorics.rank_combinations(words, 10), 10, 4), words)


# (text, edit) pairs: each edit breaks one contract validate_input checks
_BROKEN = {
    "valid": (INPUT0, lambda t: t),
    "short_hubbardU": (INPUT0, lambda t: t.replace(
        "hubbardU 4 0 0 0 0", "hubbardU 3 0 0 0")),
    "short_potentialV": (INPUT0, lambda t: t.replace(
        "potentialV 8 0 0 0 0 0 0 0 0", "potentialV 4 0 0 0 0")),
    "unknown_model": (INPUT0, lambda t: t.replace(
        "Model=HubbardOneBand", "Model=NoSuchModel")),
    "no_sites": (INPUT0, lambda t: t.replace("TotalNumberOfSites=4", "")),
    "no_target": (INPUT0, lambda t: t.replace(
        "TargetElectronsUp=2", "").replace("TargetElectronsDown=2", "")),
    "term_count": (super_hubbard_text(4), lambda t: t.replace(
        "NumberOfTerms=3", "NumberOfTerms=2")),
    "super_valid": (super_hubbard_text(4), lambda t: t),
}


@pytest.mark.parametrize("case", sorted(_BROKEN))
def test_validate_input_verdicts_equal(case):
    text, edit = _BROKEN[case]
    text = edit(text)

    def verdict(check, parse):
        try:
            return check.validate_input(parse(text))
        except check.InputValidationError as e:
            return f"invalid: {e}"

    ours = verdict(input_check, parse_input)
    assert ours == verdict(jax_check, jax_parse)
    assert (ours is True) == case.endswith("valid")
