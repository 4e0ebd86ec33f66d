"""Input texts of the flat models for the port's tests: the functions the
JAX package's own model tests use, and inline copies of the TestSuite
inputs 10, 100 and 104 and of the 8-site t-J ring behind the ``gf_tj``
golden.  Imports nothing of jax, so the card tests can
use it where only torch is installed."""

from chip_smoke import hubbard_chain_text


def _term(value, dof=1):
    return (f"DegreesOfFreedom={dof}\nGeometryKind=chain\n"
            f"GeometryOptions=ConstantValues\nConnectors {dof} {value}\n")


def heisenberg_text(nsite, twice_s, szpc, j=1.0, periodic=1, extra=""):
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + _term(j) + _term(j)
            + f"Model=Heisenberg\nHeisenbergTwiceS={twice_s}\n"
              f"SolverOptions=none\nTargetSzPlusConst={szpc}\n"
              f"IsPeriodicX={periodic}\n{extra}")


def kitaev_text(nsite, jx, jy, jz, periodic=0, extra=""):
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + _term(jx) + _term(jy) + _term(jz)
            + f"Model=Kitaev\nSolverOptions=none\nIsPeriodicX={periodic}\n"
            + extra)


def tj_text(nsite, nup, ndown, t=-1.0, j=0.3, w=0.0, periodic=0, extra=""):
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + _term(t) + _term(j) + _term(j) + _term(w)
            + f"Model=TjMultiOrb\nOrbitals=1\n"
              f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
              f"SolverOptions=none\nTargetElectronsUp={nup}\n"
              f"TargetElectronsDown={ndown}\nIsPeriodicX={periodic}\n{extra}")


def tj_two_orbital_text(nsite, nup, ndown, jhund=0):
    mat = "Connectors 2 2\n{0} {1}\n{1} {0}\n"

    def term(a, b):
        return ("DegreesOfFreedom=2\nGeometryKind=chain\n"
                "GeometryOptions=ConstantValues\n" + mat.format(a, b))
    n4 = 4 * nsite
    pot = " ".join(str(round(0.05 * k, 2)) for k in range(n4))
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + term(-1.0, 0.2) + term(0.4, 0.1) + term(0.3, 0.05)
            + term(-0.1, 0.0)
            + f"Model=TjMultiOrb\nOrbitals=2\nJHundInfinity={jhund}\n"
              f"potentialV {n4} {pot}\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndown}\n"
              f"IsPeriodicX=0\n")


def rashba_text(nsite, ne, r=0.9, u=3.0, periodic=0, options="none"):
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + _term(-1) + _term(r)
            + f"Model=HubbardOneBandRashbaSOC\n"
              f"hubbardU {nsite} {' '.join([str(u)] * nsite)}\n"
              f"potentialV {2 * nsite} "
              f"{' '.join(str(0.1 * k) for k in range(2 * nsite))}\n"
              f"SolverOptions={options}\nTargetElectronsTotal={ne}\n"
              f"IsPeriodicX={periodic}\n")


def feas_text(nsite, orbitals, mode, uvals, nup, ndown, extra="",
              options="none"):
    n2 = nsite * orbitals * 2
    conn = "\n".join(" ".join(["-1.0" if a == b else "0.3"
                               for b in range(orbitals)])
                     for a in range(orbitals))
    pot = " ".join(str(round(0.1 + 0.01 * k, 2)) for k in range(n2))
    return (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedSc\n"
            f"FeAsMode={mode}\nNumberOfTerms=1\n"
            f"DegreesOfFreedom={orbitals}\nOrbitals={orbitals}\n"
            f"GeometryKind=chain\nGeometryOptions=ConstantValues\n"
            f"SolverOptions={options}\n"
            f"hubbardU {len(uvals)} {' '.join(str(x) for x in uvals)}\n"
            f"Connectors {orbitals} {orbitals}\n{conn}\n"
            f"potentialV {n2}\n{pot}\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndown}\nIsPeriodicX=0\n{extra}")


def feas_jterms_text(nsite, nup, ndown):
    """INT_PAPER33 with the cross-site J_PM and J_ZZ geometry terms."""
    mat = "Connectors 2 2\n-1.0 0.3\n0.3 -0.8\n"
    n2 = nsite * 4
    return (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedScExtended\n"
            f"FeAsMode=INT_PAPER33\nNumberOfTerms=3\n"
            f"DegreesOfFreedom=2\nGeometryKind=chain\n"
            f"GeometryOptions=ConstantValues\n{mat}"
            + _term(0.4) + _term(0.25)
            + f"Orbitals=2\nSolverOptions=none\n"
              f"hubbardU 6 1.0 0.6 -0.2 -0.1 0.3 0.05\n"
              f"potentialV {n2}\n{' '.join(['0.1'] * n2)}\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndown}\n"
              f"IsPeriodicX=0\nAnisotropyD=0.3\n")


SO = [0.3, 0.1, 0.1, -0.3, 0.2, 0.05, 0.07, -0.2,
      0.2, 0.07, 0.05, -0.2, -0.3, 0.1, 0.1, 0.3]


def feas_so_text(nsite, nup, ndown, so_vals=SO, extra=""):
    n2 = nsite * 4
    so_lines = "\n".join(" ".join(str(x) for x in so_vals[r * 4:(r + 1) * 4])
                         for r in range(4))
    return (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedSc\n"
            f"FeAsMode=INT_PAPER33\nNumberOfTerms=1\nDegreesOfFreedom=2\n"
            f"Orbitals=2\nGeometryKind=chain\n"
            f"GeometryOptions=ConstantValues\nSolverOptions=none\n"
            f"hubbardU 4 1.0 0.5 -0.2 -0.1\nConnectors 2 2\n-1.0 0.2\n"
            f"0.2 -0.7\npotentialV {n2}\n{' '.join(['0'] * n2)}\n"
            f"SpinOrbit 4 4\n{so_lines}\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndown}\nIsPeriodicX=0\n{extra}")


def immm_text(nsite, nup, ndown, kind="chain"):
    first = ("DegreesOfFreedom=2\nGeometryKind=chain\n"
             "GeometryOptions=ConstantValues\nConnectors 2 2\n-1.0 -0.5\n"
             "-0.5 -0.8\n" if kind == "chain" else
             "DegreesOfFreedom=1\nGeometryKind=ktwoniffour\n"
             "GeometryOptions=ConstantValues\nConnectors 2 -1.0 -0.3\n")
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n{first}"
            f"DegreesOfFreedom=1\nGeometryKind={kind}\n"
            f"GeometryOptions=ConstantValues\nConnectors 1 0.6\n"
            f"Model=Immm\nhubbardU {nsite} {' '.join(['3'] * nsite)}\n"
            f"potentialV {nsite} {' '.join(['0.2'] * nsite)}\n"
            f"SolverOptions=none\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndown}\nIsPeriodicX=0\n")


INPUT10 = """
TotalNumberOfSites=4
NumberOfTerms=2
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 7.0
Model=HubbardOneBandRashbaSOC
hubbardU 4 0 0 0 0
potentialV 8 0 0 0 0 0 0 0 0
SolverOptions=useComplex
TargetElectronsTotal=1
IsPeriodicX=0
"""

INPUT100 = """
TotalNumberOfSites=6
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom=2
Orbitals=2
GeometryKind=chain
GeometryOptions=ConstantValues
SolverOptions=useComplex
hubbardU 4 4.0 3.0 -0.8 -0.4
Connectors 2 2
-1.0 0.0
0.0 -1.0
potentialV 24
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
TargetElectronsUp=3
TargetElectronsDown=3
"""

INPUT104 = INPUT100.replace("TargetElectronsDown=3\n",
                            "TargetElectronsDown=3\nAnisotropyD=7\n")

TJ8 = tj_text(8, 3, 3, periodic=1).replace(
    f"potentialV 16 {' '.join(['0'] * 16)}\n", "")


def _all_texts():
    return {
        "heisenberg": heisenberg_text(6, 1, 3),
        "kitaev": kitaev_text(6, 1.0, 0.6, 0.8, periodic=1),
        "tj": tj_text(6, 2, 2),
        "tj_two_orbitals": tj_two_orbital_text(3, 2, 1),
        "rashba": rashba_text(4, 2),
        "feas": feas_text(2, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1], 2, 1),
        "feas_jterms": feas_jterms_text(3, 2, 1),
        "feas_spinorbit": feas_so_text(2, 1, 1),
        "immm": immm_text(4, 2, 2),
        "immm_ktwoniffour": immm_text(6, 2, 2, kind="ktwoniffour"),
        "input10": INPUT10, "input100": INPUT100, "input104": INPUT104,
        "tj8": TJ8,
        "hubbard_ladder": hubbard_chain_text(8, 4, 2, 2, ladder=True),
    }


def test_every_text_parses_validates_and_builds():
    """Each text goes through the port's parser, its input check and its
    model registry, and names a sector that is not empty."""
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_check import validate_input
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    for name, text in _all_texts().items():
        inp = parse_input(text)
        validate_input(inp)
        model = build_model(inp, Geometry(inp))
        basis = model.create_basis(model.default_parts(inp))
        assert basis.size > 1, name
    assert INPUT104 != INPUT100 and "AnisotropyD=7" in INPUT104
