"""Semantic input validation (InputCheck parity).

Counterpart of ``lanczosplusplus_tpu/io_/input_check.py``, unchanged: the
verdicts must be the same for the same input.

The reference validates vector-label lengths and the SolverOptions
vocabulary while parsing (reference: src/Engine/InputCheck.h:106-167),
so a wrong-length `hubbardU` line is a one-line diagnostic naming the
label instead of an obscure downstream error.  `validate_input` is the
equivalent hook, called by the CLI drivers right after parsing.
"""

from __future__ import annotations


class InputValidationError(ValueError):
    """One-line diagnostic naming the offending input label."""


_HUBBARD_FAMILY = {"HubbardOneBand", "HubbardOneBandExtended",
                   "SuperHubbardExtended", "KaneMeleHubbard",
                   "HubbardOneBandRashbaSOC"}
_KNOWN_MODELS = _HUBBARD_FAMILY | {
    "Heisenberg", "Kitaev", "TjMultiOrb", "FeAsBasedSc",
    "FeAsBasedScExtended", "Immm"}


def _fail(msg):
    raise InputValidationError(msg)


def _check_len(inp, label, want, why, optional=True, occurrence=0):
    if not inp.has(label):
        if optional:
            return
        _fail(f"missing required label {label} ({why})")
    got = inp.vector(label, occurrence=occurrence)
    if isinstance(got, tuple):
        return  # matrix payloads are shape-checked by _check_matrix
    if len(got) != want:
        _fail(f"{label}: expected {want} values ({why}), got {len(got)}")


def _check_matrix(inp, label, nrow, ncol, why):
    if not inp.has(label):
        return
    try:
        m = inp.matrix(label)
    except ValueError:
        _fail(f"{label}: expected a {nrow}x{ncol} matrix ({why})")
    if len(m) != nrow or any(len(r) != ncol for r in m):
        _fail(f"{label}: expected a {nrow}x{ncol} matrix ({why}), got "
              f"{len(m)}x{len(m[0]) if m else 0}")


def validate_input(inp):
    """Validate a parsed input against the model/geometry contracts the
    reference enforces in InputCheck + the model parameter readers
    (reference: src/Engine/InputCheck.h:106-129 vector labels,
    138-162 SolverOptions vocabulary).  Raises InputValidationError
    with a one-line diagnostic naming the label."""
    # -- global structure ------------------------------------------------
    if not inp.has("TotalNumberOfSites"):
        _fail("missing required label TotalNumberOfSites")
    nsite = inp.integer("TotalNumberOfSites")
    if nsite < 1:
        _fail(f"TotalNumberOfSites: must be >= 1, got {nsite}")
    if not inp.has("Model"):
        _fail("missing required label Model")
    model = inp.string("Model")
    if model not in _KNOWN_MODELS:
        _fail(f"Model: unknown model {model!r} (known: "
              f"{', '.join(sorted(_KNOWN_MODELS))})")
    nterms = inp.integer("NumberOfTerms", default=1)
    ngeo = inp.count("GeometryKind")
    if ngeo and ngeo != nterms:
        _fail(f"NumberOfTerms={nterms} but {ngeo} GeometryKind "
              "block(s) present (one geometry block per term)")
    ncon = inp.count("Connectors")
    if ncon and ncon != nterms:
        _fail(f"NumberOfTerms={nterms} but {ncon} Connectors "
              "block(s) present")
    # SolverOptions vocabulary: solver_options() warns on unknown
    # tokens (the reference's Options::Writeable is PERMISSIVE,
    # InputCheck.h:164-166)
    inp.solver_options()

    # -- reference InputCheck.h vector labels ----------------------------
    _check_len(inp, "JMVALUES", 2, "InputCheck.h:109-111")
    _check_matrix(inp, "SpinOrbit", 4, 4,
                  "onsite spin-orbit matrix, InputCheck.h:112-117")

    # -- per-model parameter vectors --------------------------------------
    norb = inp.integer("Orbitals", default=1)
    if model in _HUBBARD_FAMILY:
        _check_len(inp, "hubbardU", nsite,
                   "one U per site", optional=False)
        _check_len(inp, "potentialV", 2 * nsite,
                   "2*nsite (spin-resolved site potentials)",
                   optional=False)
        _check_len(inp, "PotentialT", nsite,
                   "one time-dependent potential per site")
    elif model == "Heisenberg":
        _check_len(inp, "MagneticField", nsite, "one field per site")
        _check_len(inp, "AnisotropyD", nsite, "one D per site")
        if not inp.has("HeisenbergTwiceS"):
            _fail("missing required label HeisenbergTwiceS")
    elif model == "Kitaev":
        _check_len(inp, "MagneticField", nsite, "one field per site")
    elif model == "TjMultiOrb":
        if inp.has("potentialV"):
            _check_len(inp, "potentialV", 2 * nsite * norb,
                       "2*nsite*orbitals spin-resolved potentials")
    elif model in ("FeAsBasedSc", "FeAsBasedScExtended"):
        if not inp.has("Orbitals"):
            _fail("missing required label Orbitals (FeAsBasedSc)")
        mode = inp.string("FeAsMode", default="INT_PAPER33")
        want_u = {"INT_PAPER33": (4, 6), "INT_IMPURITY": (4, 6),
                  "INT_V": (norb * norb,) * 2,
                  "INT_CODE2": (2 * norb * norb,) * 2,
                  "INT_KSPACE": (1, 1)}.get(mode)
        if want_u is not None and inp.has("hubbardU"):
            got = len(inp.vector("hubbardU"))
            lo, hi = want_u
            if not (lo <= got <= hi):
                _fail(f"hubbardU: FeAsMode={mode} expects "
                      f"{lo if lo == hi else f'{lo}..{hi}'} values, "
                      f"got {got}")
        _check_len(inp, "potentialV", 2 * nsite * norb,
                   "2*nsite*orbitals spin-resolved potentials",
                   optional=False)
    elif model == "Immm":
        # heterogeneous orbitals: potentialV is read per site
        if inp.has("potentialV") and \
                len(inp.vector("potentialV")) < nsite:
            _fail(f"potentialV: expected at least {nsite} values "
                  "(one per site), got "
                  f"{len(inp.vector('potentialV'))}")

    # -- target sector labels ---------------------------------------------
    if model in ("HubbardOneBandRashbaSOC",):
        if not inp.has("TargetElectronsTotal"):
            _fail("missing required label TargetElectronsTotal "
                  "(RashbaSOC conserves only total N)")
    elif model in ("Heisenberg",):
        if not (inp.has("TargetSzPlusConst") or
                inp.has("TargetElectronsUp")):
            _fail("missing required label TargetSzPlusConst")
    elif model != "Kitaev":
        if not (inp.has("TargetElectronsUp") or
                inp.has("TargetSzPlusConst") or
                inp.has("TargetElectronsTotal")):
            _fail("missing target sector labels (TargetElectronsUp/"
                  "Down, TargetSzPlusConst or TargetElectronsTotal)")
    return True


def usage(prog_name: str) -> str:
    """Usage text (reference: InputCheck.h:174-177)."""
    return f"Usage: {prog_name} [options] -f filename"
