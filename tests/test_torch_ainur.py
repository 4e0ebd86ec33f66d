"""The port's Ainur parser (io_/ainur.py) held against the JAX package's:
every input of tests/test_ainur.py parses to equal entries in both
packages and, through both Engines on the CPU in float64, to equal ground
energies (to 1e-10); the forms outside the documented subset raise
ValueError in both."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.ainur import parse_ainur as jax_parse_ainur
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.ainur import is_ainur, parse_ainur
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_ainur import AINUR, LEGACY

torch.set_num_threads(2)

LADDER = """##Ainur1.0
TotalNumberOfSites=8;
NumberOfTerms=1;
gt0:DegreesOfFreedom=1;
gt0:GeometryKind="ladder";
gt0:LadderLeg=2;
gt0:GeometryOptions="ConstantValues";
gt0:dir0:Connectors=[-1.0];
gt0:dir1:Connectors=[-0.6];
Model="HubbardOneBand";
vector hubbardU=[1, 1, 1, 1, 1, 1, 1, 1];
vector potentialV=[0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0];
SolverOptions="none";
TargetElectronsUp=2;
TargetElectronsDown=2;
IsPeriodicX=0;
"""
MATRIX = AINUR + ('matrix SpinOrbit=[[1, 0, 0, 1], [0, 1, 1, 0], '
                  '[0, 0, 1, 1], [1, 1, 0, 0]];\n')
# a complex scalar, a quoted string with a comment after it, and two
# geometry terms, each with its own per-term labels
TWO_TERMS = """##Ainur1.0
# Heisenberg ring, two terms (Jpm, Jzz)
TotalNumberOfSites=6;
NumberOfTerms=2;
gt0:DegreesOfFreedom=1;
gt0:GeometryKind="chain";
gt0:GeometryOptions="ConstantValues";
gt0:Connectors=[1.0];
gt1:DegreesOfFreedom=1;
gt1:GeometryKind="chain";
gt1:GeometryOptions="ConstantValues";
gt1:Connectors=[0.5];
Model="Heisenberg";  # the model
HeisenbergTwiceS=1;
SolverOptions="none";
TargetSzPlusConst=3;
IsPeriodicX=1;
Unused=(1.5,-2);
"""
TEXTS = {"hubbard4": AINUR, "spin_orbit_matrix": MATRIX,
         "ladder": LADDER, "heisenberg_two_terms": TWO_TERMS}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_ainur_parses_as_jax(name):
    text = TEXTS[name]
    assert is_ainur(text)
    inp = parse_input(text)
    assert inp.entries == jax_parse(text).entries
    assert parse_ainur(text).entries == inp.entries


@pytest.mark.parametrize("name", ["hubbard4", "ladder",
                                  "heisenberg_two_terms"])
def test_ainur_energy_matches_jax(name):
    text = TEXTS[name]
    inp, jinp = parse_input(text), jax_parse(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp,
                 config=Config(device="cpu"))
    jeng = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    assert abs(eng.ground_energy - jeng.ground_energy) <= \
        1e-10 * max(abs(jeng.ground_energy), 1.0)
    assert np.isfinite(eng.ground_energy)


def test_ainur_and_legacy_agree():
    """The Ainur form of the 4-site ring and its legacy form: equal
    labels the models read, and the same energy, -4 (U = 0 levels -2, 0,
    0, 2)."""
    a, b = parse_input(AINUR), parse_input(LEGACY)
    for label in ("TotalNumberOfSites", "TargetElectronsUp", "Model"):
        assert a.scalar(label) == b.scalar(label)
    for label in ("hubbardU", "potentialV", "Connectors"):
        assert a.vector(label) == b.vector(label)
    es = [Engine(build_model(i, Geometry(i)), i,
                 config=Config(device="cpu")).ground_energy for i in (a, b)]
    assert abs(es[0] + 4.0) <= 1e-10 and abs(es[0] - es[1]) <= 1e-12


@pytest.mark.parametrize("text", [
    '##Ainur1.0\nFiniteLoops=![7, [100, 0.5, 0]];\n',
    '##Ainur1.0\ninclude "other.ain";\n',
    '##Ainur1.0\n%include other;\n',
    '##Ainur1.0\nTotalNumberOfSites 4;\n',
    '##Ainur1.0\ngt0:dir0:Connectors=[[1, 0], [0, 1]];\n'
    'NumberOfTerms=1;\n'])
def test_ainur_boundary_forms_raise_in_both(text):
    with pytest.raises(ValueError) as ours:
        parse_input(text)
    with pytest.raises(ValueError) as theirs:
        jax_parse_ainur(text)
    assert str(ours.value) == str(theirs.value)
