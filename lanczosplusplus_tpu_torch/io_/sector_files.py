"""Labelled-ASCII sector artifacts for the thermal pipeline.

Mirrors the files the reference's dumpmatrix path + grandCanonical.pl
produce and `thermal` consumes (reference:
src/Models/HubbardOneOrbital/HubbardOneOrbital.h:126-210 printOperators,
src/Engine/OneSector.h:18-23 '#SectorSource', '#Eigenvalues',
'#Eigenvectors'; src/thermal.cpp:83-92 readers), so downstream tooling
written against the reference's format keeps working.

Counterpart of ``lanczosplusplus_tpu/io_/sector_files.py``: each
sector's spectrum comes from ``engine/thermal.full_spectrum`` on `device`
(the card unless told otherwise), its operator matrices from
``operator_matrix`` on the host; the text written is the JAX package's,
byte for byte (the real part of every number, as ``repr(float)``).
"""

from __future__ import annotations

import numpy as np

from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.thermal import (full_spectrum,
                                                      operator_matrix)


def _write_matrix(f, m):
    """The real part of every entry as ``repr(float)``, a row a line
    (one ``tolist`` of the whole matrix, not a numpy scalar an entry)."""
    f.write(f"{m.shape[0]} {m.shape[1]}\n")
    for row in np.real(m).astype(np.float64).tolist():
        f.write(" ".join(map(repr, row)) + "\n")


def _read_matrix(lines, i):
    nrow, ncol = (int(x) for x in lines[i].split())
    m = np.zeros((nrow, ncol))
    for r in range(nrow):
        m[r] = [float(x) for x in lines[i + 1 + r].split()]
    return m, i + 1 + nrow


def write_sector(f, model, basis, spectrum=None, operator="c",
                 spins=(0,), device="cuda"):
    """One sector block: source parts, eigendata (diagonalized on
    `device` unless `spectrum` is given), per-(site, spin) operator
    matrices into the destination sector."""
    if spectrum is None:
        spectrum = full_spectrum(model, basis, device=device)
    nup, ndown = basis.parts
    f.write(f"#SectorSource 2 {nup} {ndown}\n")
    f.write(f"#Eigenvalues {len(spectrum.evals)} "
            + " ".join(repr(float(e)) for e in spectrum.evals) + "\n")
    f.write("#Eigenvectors\n")
    _write_matrix(f, spectrum.evecs)
    op = LabeledOperator(operator)
    n = model.geometry.number_of_sites()
    for spin in spins:
        for site in range(n):
            new_parts = model.has_new_parts(basis.parts, op, spin, 0)
            f.write(f"#Operator_{operator}_{spin}_{site}\n")
            if new_parts is None:
                f.write("#SectorDest 0\n#Matrix\n0 0\n")
                continue
            dst = model.create_basis(new_parts)
            f.write(f"#SectorDest 2 {new_parts[0]} {new_parts[1]}\n")
            f.write("#Matrix\n")
            a = operator_matrix(model, operator, site, spin, 0, basis,
                                dst)
            _write_matrix(f, a)


def write_all_sectors(path, model, nsite, operator="c", kind="hubbard",
                      spins=(0,), device="cuda"):
    """The grandCanonical.pl sweep: every (nup, ndown) sector
    concatenated with a #TotalSectors header (thermal.cpp:253-259), each
    diagonalized on `device`.  A sector the model cannot hold is skipped:
    a model refusing its parts raises ValueError, an orbital filled past
    its sites indexes the binomial table out of range (IndexError); any
    other error propagates."""
    sectors = []
    for nu in range(nsite + 1):
        for nd in range(nsite + 1):
            if kind == "tj" and nu + nd > nsite:
                continue
            try:
                basis = model.create_basis((nu, nd))
            except (ValueError, IndexError):
                continue
            if basis.size == 0:
                continue
            sectors.append(basis)
    with open(path, "w") as f:
        f.write(f"#TotalSectors={len(sectors)}\n")
        for basis in sectors:
            write_sector(f, model, basis, operator=operator, spins=spins,
                         device=device)
    return len(sectors)


def read_sectors(path):
    """Parse the sector file back: list of dicts with parts, evals,
    evecs, operators {(name, spin, site): (dest_parts, matrix)}."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    out = []
    cur = None
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("#TotalSectors="):
            pass
        elif ln.startswith("#SectorSource"):
            toks = ln.split()
            cur = dict(parts=(int(toks[2]), int(toks[3])), operators={})
            out.append(cur)
        elif ln.startswith("#Eigenvalues"):
            toks = ln.split()
            m = int(toks[1])
            cur["evals"] = np.array([float(x) for x in toks[2:2 + m]])
        elif ln.startswith("#Eigenvectors"):
            cur["evecs"], i = _read_matrix(lines, i + 1)
            continue
        elif ln.startswith("#Operator_"):
            _, name, spin, site = ln.split("_")
            dest_ln = lines[i + 1].split()
            if dest_ln[1] == "0":
                i += 4
                continue
            dest = (int(dest_ln[2]), int(dest_ln[3]))
            m, inew = _read_matrix(lines, i + 3)
            cur["operators"][(name, int(spin), int(site))] = (dest, m)
            i = inew
            continue
        i += 1
    return out
