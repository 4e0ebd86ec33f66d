"""The input labels the reference reads, parsed on their own.

A line ``Label=value`` sets a scalar label; a line ``Label n v1 .. vn``
sets a vector label.  A Hamiltonian term repeats ``DegreesOfFreedom``,
``GeometryKind``, ``GeometryOptions`` and ``Connectors``, so every label
keeps the list of its occurrences in order.
"""

from __future__ import annotations

import numpy as np


def parse(text: str) -> dict[str, list]:
    """{label: [value of each occurrence]}: a scalar as its string, a
    vector as the list of its n strings."""
    labels: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" in line:
            key, value = line.split("=", 1)
            labels.setdefault(key.strip(), []).append(value.strip())
            continue
        name, count, *values = line.split()
        if len(values) != int(count):
            raise ValueError(f"{name}: {count} values announced, "
                             f"{len(values)} given")
        labels.setdefault(name, []).append(values)
    return labels


def one(labels: dict, key: str, default=None):
    """The single value of `key` (`default` where it is absent)."""
    values = labels.get(key)
    if values is None:
        if default is None:
            raise KeyError(f"input has no {key}")
        return default
    if len(values) != 1:
        raise ValueError(f"{key} given {len(values)} times")
    return values[0]


def chain_terms(labels: dict, nsite: int) -> list[np.ndarray]:
    """One (nsite, nsite) coupling matrix a term: a chain of constant
    couplings, bond (i, i+1) and, with ``IsPeriodicX=1``, (nsite-1, 0),
    both directions.  Any other geometry is refused."""
    nterms = int(one(labels, "NumberOfTerms"))
    kinds = labels.get("GeometryKind", [])
    options = labels.get("GeometryOptions", [])
    dofs = labels.get("DegreesOfFreedom", [])
    connectors = labels.get("Connectors", [])
    if not (len(kinds) == len(options) == len(dofs) == len(connectors)
            == nterms):
        raise ValueError("each term needs its DegreesOfFreedom, "
                         "GeometryKind, GeometryOptions and Connectors")
    periodic = int(one(labels, "IsPeriodicX", "0")) == 1
    bonds = [(i, i + 1) for i in range(nsite - 1)]
    if periodic and nsite > 2:
        bonds.append((nsite - 1, 0))
    terms = []
    for kind, option, dof, values in zip(kinds, options, dofs, connectors):
        if (kind, option, dof) != ("chain", "ConstantValues", "1") \
                or len(values) != 1:
            raise ValueError(f"the reference reads chains of constant "
                             f"couplings, not {kind} {option} {dof} {values}")
        t = np.zeros((nsite, nsite))
        for i, j in bonds:
            t[i, j] = t[j, i] = float(values[0])
        terms.append(t)
    return terms
