"""Ainur input format (documented subset).

Counterpart of ``lanczosplusplus_tpu/io_/ainur.py`` (``is_ainur``,
``_parse_value``, ``parse_ainur``), host code copied as it is; the port's
``io_/input_parser.parse_input`` routes ``##Ainur`` text here.

PsimagLite's InputNg reads two formats: the legacy label format (all
reference TestSuite inputs; `io_/input_parser.py`) and Ainur —
`##Ainur1.0` header, semicolon-terminated `name=value;` statements,
quoted strings, `[..]` vectors, `[[..],[..]]` matrices, optional type
keywords, and `gt<N>:`/`dir<D>:` prefixes for per-geometry-term
labels.  The reference's own code touches Ainur only to append a
semicolon (quasiparticleWeightZ.cpp:133); the full grammar lives in
PsimagLite (not available here), so this implements the subset needed
to express every label the models read, mapped onto the same InputData
the legacy parser produces:

- `Label=3;` / `Label=3.5;` / `Label=(1,2);` scalars
- `Label="text";` strings
- `vector Label=[a, b, c];` vectors
- `matrix Label=[[a, b], [c, d]];` matrices -> (nrow, ncol, flat)
- `gt0:GeometryKind="chain";` geometry labels, grouped per term in
  gt order (occurrence semantics identical to the legacy parser)
- `gt0:dir0:Connectors=[-1.0]; gt0:dir1:Connectors=[-0.6];`
  direction-resolved ConstantValues connectors merge into one
  per-term Connectors vector (matrix-valued dirs are kept as
  matrices, one occurrence per direction is not supported)

SUBSET BOUNDARY (deliberately exhaustive for this framework): the
forms above cover every label the Lanczos++ models read, which is the
capability contract (reference src/lanczos.cpp:191-192 merely hands
the file to InputNg; no reference or DMRG++-family Lanczos input in
the TestSuite uses anything further).  PsimagLite's full Ainur grammar
additionally has `![...]` evaluated expressions and file-include
forms; their semantics live in PsimagLite sources that are not
available in this environment, so rather than guessing, statements
using them raise a ValueError naming this boundary (a silent
mis-parse would corrupt physics inputs).  Extend here if a real input
ever needs them.
"""

from __future__ import annotations

import re

from lanczosplusplus_tpu_torch.io_.input_parser import (
    InputData, _is_number, _to_num)


_TYPE_WORDS = {"integer", "real", "string", "vector", "matrix",
               "complex"}


def is_ainur(text: str) -> bool:
    head = text.lstrip()[:32]
    return head.startswith("##Ainur")


def _parse_value(val: str):
    val = val.strip()
    if val.startswith('"') and val.endswith('"'):
        return val[1:-1]
    if val.startswith("[["):
        rows = re.findall(r"\[([^\[\]]*)\]", val)
        mat = [[_to_num(x.strip()) for x in row.split(",") if x.strip()]
               for row in rows]
        ncol = len(mat[0]) if mat else 0
        flat = [v for row in mat for v in row]
        return (len(mat), ncol, flat)
    if val.startswith("["):
        inner = val[1:-1]
        return [_to_num(x.strip()) for x in inner.split(",")
                if x.strip()]
    if _is_number(val):
        return _to_num(val)
    return val


def parse_ainur(text: str) -> InputData:
    # strip the header line and comments
    lines = []
    for ln in text.splitlines():
        if ln.lstrip().startswith("##"):
            continue
        ln = ln.split("#", 1)[0]
        lines.append(ln)
    body = "\n".join(lines)
    data = InputData()

    def push(label, value):
        data.entries.setdefault(label, []).append(value)

    # per-term geometry collection: gt index -> {label: value}
    terms = {}
    for stmt in body.split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        if stmt.startswith(("include", "%", "!")):
            raise ValueError(
                "ainur: `![...]` expressions and include forms are "
                "outside the documented subset (module docstring: "
                "their semantics live in PsimagLite sources "
                "unavailable here); rewrite the value literally")
        if "=" not in stmt:
            raise ValueError(f"ainur: statement without '=': {stmt!r}")
        name, _, val = stmt.partition("=")
        name = name.strip()
        if val.lstrip().startswith("!"):
            raise ValueError(
                "ainur: `![...]` expressions and include forms are "
                "outside the documented subset (module docstring: "
                "their semantics live in PsimagLite sources "
                "unavailable here); rewrite the value literally")
        # optional leading type keyword
        parts = name.split()
        if len(parts) == 2 and parts[0].lower() in _TYPE_WORDS:
            name = parts[1]
        value = _parse_value(val)
        m = re.match(r"^gt(\d+):(?:dir(\d+):)?(\w+)$", name)
        if m:
            t = int(m.group(1))
            d = m.group(2)
            label = m.group(3)
            td = terms.setdefault(t, {})
            if d is not None:
                td.setdefault((label, "dirs"), {})[int(d)] = value
            else:
                td[label] = value
            continue
        push(name, value)

    # emit geometry labels in term order with legacy occurrence
    # semantics (one block per term)
    for t in sorted(terms):
        td = terms[t]
        for label in ("DegreesOfFreedom", "GeometryKind",
                      "GeometryOptions", "LadderLeg"):
            if label in td:
                push(label, td[label])
        dirs = td.get(("Connectors", "dirs"))
        if dirs is not None:
            vals = []
            for d in sorted(dirs):
                v = dirs[d]
                if isinstance(v, tuple):
                    raise ValueError(
                        "ainur: matrix-valued dir-resolved Connectors "
                        "unsupported; use a single per-term Connectors")
                vals.extend(v if isinstance(v, list) else [v])
            push("Connectors", vals)
        elif "Connectors" in td:
            push("Connectors", td["Connectors"])
        for label, v in td.items():
            if isinstance(label, tuple) or label in (
                    "DegreesOfFreedom", "GeometryKind",
                    "GeometryOptions", "LadderLeg", "Connectors"):
                continue
            push(label, v)
    return data
