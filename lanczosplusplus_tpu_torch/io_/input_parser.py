"""Parser for the reference's DMRG++-style input files.

Counterpart of ``lanczosplusplus_tpu/io_/input_parser.py``: the legacy
label format here, an Ainur-format input (``##Ainur`` header) through
``io_/ainur.py``.

Grammar (reference: PsimagLite InputNg legacy format as used by
TestSuite/inputs/*.inp and read at src/lanczos.cpp:191-192):

- ``Label=value`` scalar assignments;
- ``Label n v1 ... vn`` vectors (values may continue on following lines);
- ``Label nrow ncol v11 ... `` matrices for known matrix labels
  (``Connectors`` with >1 degree of freedom, ``SpinOrbit``,
  ``FiniteLoops`` rows of 3);
- repeated labels (one geometry block per term) are kept in file order.

The same input files that drive the C++ binaries drive this framework
unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_INT_RE = re.compile(r"^[+-]?\d+$")
# PsimagLite complex literal: (re,im)
_CPLX_RE = re.compile(
    r"^\(([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?),"
    r"([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)\)$")

# labels whose payload is "nrow ncol values..."
_MATRIX_LABELS = {"SpinOrbit", "RAW_MATRIX"}
# labels whose payload is "n" then n rows of fixed width
_ROWS3_LABELS = {"FiniteLoops"}


def _is_number(tok: str) -> bool:
    return bool(_NUM_RE.match(tok)) or bool(_CPLX_RE.match(tok))


def _to_num(tok: str):
    m = _CPLX_RE.match(tok)
    if m:
        return complex(float(m.group(1)), float(m.group(2)))
    if _INT_RE.match(tok):
        return int(tok)
    return float(tok)


@dataclass
class InputData:
    """Parsed input: every label maps to the list of its occurrences in
    file order (geometry labels repeat once per term)."""

    entries: dict = field(default_factory=dict)

    def _get(self, label: str, occurrence: int = 0):
        if label not in self.entries:
            raise KeyError(f"missing input label: {label}")
        occ = self.entries[label]
        if occurrence >= len(occ):
            raise KeyError(f"label {label} has only {len(occ)} occurrence(s)")
        return occ[occurrence]

    def count(self, label: str) -> int:
        return len(self.entries.get(label, ()))

    def has(self, label: str) -> bool:
        return label in self.entries

    def scalar(self, label: str, default=None, occurrence: int = 0):
        if label not in self.entries and default is not None:
            return default
        v = self._get(label, occurrence)
        if isinstance(v, list):
            raise ValueError(f"label {label} is a vector, not a scalar")
        return v

    def integer(self, label: str, default=None, occurrence: int = 0) -> int:
        v = self.scalar(label, default, occurrence)
        return int(v)

    def real(self, label: str, default=None, occurrence: int = 0) -> float:
        v = self.scalar(label, default, occurrence)
        return float(v)

    def string(self, label: str, default=None, occurrence: int = 0) -> str:
        v = self.scalar(label, default, occurrence)
        return str(v)

    def vector(self, label: str, occurrence: int = 0, default=None):
        if label not in self.entries and default is not None:
            return list(default)
        v = self._get(label, occurrence)
        if not isinstance(v, list):
            return [v]
        return v

    def matrix(self, label: str, occurrence: int = 0):
        """Vector stored as (nrow, ncol, values) -> nested list."""
        v = self._get(label, occurrence)
        if isinstance(v, tuple) and len(v) == 3:
            nrow, ncol, vals = v
            return [vals[r * ncol:(r + 1) * ncol] for r in range(nrow)]
        raise ValueError(f"label {label} is not a matrix")

    # SolverOptions vocabulary (reference: InputCheck.h:157-162 register
    # list, plus tokens that appear in TestSuite inputs and our own
    # extensions).  The reference's option parser is permissive about
    # unknown tokens (TestSuite uses e.g. MatrixVectorStored), so we
    # warn rather than raise.
    _KNOWN_SOLVER_OPTIONS = {
        "none", "InternalProductStored", "InternalProductOnTheFly",
        "printmatrix", "dumpmatrix", "setAffinities",
        # seen in TestSuite inputs
        "MatrixVectorStored", "twositedmrg", "fixLegacyBugs",
        # tpu-native extensions
        "useComplex", "factored", "reortho", "serialgf",
        "ftlm", "ltlm", "bf16cross", "projected",
    }

    def solver_options(self) -> set:
        import sys as _sys

        opts = str(self.scalar("SolverOptions", default="none"))
        out = {o.strip() for o in opts.split(",") if o.strip()}
        unknown = out - self._KNOWN_SOLVER_OPTIONS
        if unknown and not getattr(self, "_warned_opts", False):
            print(f"input: unknown SolverOptions token(s): "
                  f"{sorted(unknown)}", file=_sys.stderr)
            object.__setattr__(self, "_warned_opts", True)
        return out


def parse_input(text: str) -> InputData:
    # Ainur-format inputs (##Ainur header) route to the Ainur subset
    # parser; everything else is the legacy label format
    if text.lstrip()[:7] == "##Ainur":
        from lanczosplusplus_tpu_torch.io_.ainur import parse_ainur
        return parse_ainur(text)
    # strip comments
    lines = []
    for ln in text.splitlines():
        ln = ln.split("#", 1)[0]
        lines.append(ln)
    toks = "\n".join(lines).split()

    data = InputData()
    dof_per_term = []  # DegreesOfFreedom occurrences seen so far
    kind_per_term = []  # GeometryKind occurrences
    n_connectors_seen = 0

    def push(label, value):
        data.entries.setdefault(label, []).append(value)

    i = 0
    n = len(toks)
    while i < n:
        tok = toks[i]
        if "=" in tok:
            label, _, val = tok.partition("=")
            value = _to_num(val) if _is_number(val) else val
            push(label, value)
            if label == "DegreesOfFreedom":
                dof_per_term.append(int(value))
            elif label == "GeometryKind":
                kind_per_term.append(str(value).lower())
            i += 1
            continue
        label = tok
        i += 1
        if i >= n or not _is_number(toks[i]):
            # bare flag with no payload
            push(label, "")
            continue
        n1_tok = toks[i]
        i += 1
        if not _INT_RE.match(n1_tok):
            # single unnamed scalar payload
            push(label, _to_num(n1_tok))
            continue
        n1 = int(n1_tok)

        is_matrix = label in _MATRIX_LABELS
        if label == "DegreesOfFreedom":
            dof_per_term.append(n1)
            push(label, n1)
            continue
        if label == "Connectors":
            dof = dof_per_term[n_connectors_seen] \
                if n_connectors_seen < len(dof_per_term) else 1
            kind = kind_per_term[n_connectors_seen] \
                if n_connectors_seen < len(kind_per_term) else ""
            n_connectors_seen += 1
            # longrange/raw connectors are n x n matrices even at one
            # degree of freedom
            is_matrix = dof > 1 or kind in ("longrange", "raw")

        if label in _ROWS3_LABELS:
            vals = [_to_num(toks[i + k]) for k in range(3 * n1)]
            i += 3 * n1
            push(label, (n1, 3, vals))
        elif is_matrix:
            n2 = int(toks[i])
            i += 1
            vals = [_to_num(toks[i + k]) for k in range(n1 * n2)]
            i += n1 * n2
            push(label, (n1, n2, vals))
        else:
            vals = [_to_num(toks[i + k]) for k in range(n1)]
            i += n1
            push(label, vals)
    return data


def read_input(path: str) -> InputData:
    with open(path) as f:
        return parse_input(f.read())
