"""Lattice geometry: term-wise coupling tensors.

Counterpart of ``lanczosplusplus_tpu/geometry/geometry.py``, which is
pure numpy and carries over as it is.

Replaces PsimagLite::Geometry as used by the reference
(reference: src/lanczos.cpp:79-90 builds Geometry(io); models query
``geometry(i, orb1, j, orb2, term)`` e.g. at
src/Models/HubbardOneOrbital/HubbardHelper.h:63).

Each Hamiltonian term carries a coupling tensor c[i, j, orb1, orb2]
assembled host-side as dense numpy (sites are tiny, <= ~24); models
index it to emit their sparse term lists.

Supported kinds: chain, ladder (leg-major site order: leg index fastest,
x-neighbors i<->i+legs, rungs i<->i+1), longrange/raw connector matrix,
star.
"""

from __future__ import annotations

import numpy as np


def ktwoniffour_types(n: int):
    """Site-type pattern of the K2NiF4 (KTwoNiFFour) geometry used by
    the Immm model: 'C' = copper (1 orbital), 'O' = oxygen (2 orbitals)
    (reference: src/Models/Immm/BasisImmm.h:49-57 maps TYPE_C -> 1
    orbital, else 2).

    PsimagLite's KTwoNiFFour source is not available in this
    environment (and the reference ships no Immm inputs), so the cell
    layout is a RECONSTRUCTION of the K2NiF4 structure: period-3 cells
    [O_x, O_y, Cu] — a chain of corner-sharing CuO2 plaquette units,
    one copper and two inequivalent oxygens per cell.  The pattern (and
    everything derived from it) can be overridden with an
    `OrbsPerSite` input vector."""
    return ["C" if i % 3 == 2 else "O" for i in range(n)]


class Geometry:
    def __init__(self, inp):
        self.nsites = inp.integer("TotalNumberOfSites")
        self.nterms = inp.integer("NumberOfTerms", default=1)
        self._kinds = []
        self._dofs = []
        self._couplings = []  # list of (n, n, dof, dof) arrays
        self.ladder_legs = inp.integer("LadderLeg", default=2)
        periodic_x = bool(inp.integer("IsPeriodicX", default=0))
        periodic_y = bool(inp.integer("IsPeriodicY", default=0))

        for t in range(self.nterms):
            kind = inp.string("GeometryKind", occurrence=t)
            dof = inp.integer("DegreesOfFreedom", default=1, occurrence=t)
            options = inp.string("GeometryOptions", default="ConstantValues",
                                 occurrence=t)
            self._kinds.append(kind)
            self._dofs.append(dof)
            self._couplings.append(
                self._build_term(inp, t, kind, dof, options,
                                 periodic_x, periodic_y))

    # -- construction ------------------------------------------------------

    def _connector_values(self, inp, t, dof, ndirs):
        """Connector payload for term t: for each direction a (dof, dof)
        matrix (scalar case is a 1x1 matrix)."""
        if dof == 1:
            vec = inp.vector("Connectors", occurrence=t)
            if len(vec) < ndirs:
                vec = list(vec) + [vec[-1]] * (ndirs - len(vec))
            dt = complex if any(isinstance(v, complex) for v in vec) \
                else np.float64
            return [np.array([[v]], dtype=dt) for v in vec]
        rows = inp.matrix("Connectors", occurrence=t)
        dt = complex if any(isinstance(v, complex)
                            for r in rows for v in r) else np.float64
        mat = np.array(rows, dtype=dt)
        return [mat] * ndirs

    def _build_term(self, inp, t, kind, dof, options, px, py):
        n = self.nsites
        c = np.zeros((n, n, dof, dof), dtype=np.float64)

        def add_bond(i, j, mat):
            nonlocal c
            if np.iscomplexobj(mat) and not np.iscomplexobj(c):
                c = c.astype(complex)
            c[i, j] += mat
            # hermitian coupling: the reverse bond carries the
            # conjugate transpose (matters for complex SOC hoppings)
            c[j, i] += mat.conj().T

        kl = kind.lower()
        if kl == "chain":
            mats = self._connector_values(inp, t, dof, 1)
            for i in range(n - 1):
                add_bond(i, i + 1, mats[0])
            if px and n > 2:
                add_bond(n - 1, 0, mats[0])
        elif kl in ("ladder", "ladderx"):
            legs = self.ladder_legs
            mats = self._connector_values(inp, t, dof, 2)
            for i in range(n):
                if i + legs < n:
                    add_bond(i, i + legs, mats[0])     # leg (x) direction
                if i % legs != legs - 1:
                    add_bond(i, i + 1, mats[1])        # rung (y) direction
                elif py and legs > 2:
                    add_bond(i, i - (legs - 1), mats[1])
            if px and n > 2 * legs:
                for leg in range(legs):
                    add_bond(n - legs + leg, leg, mats[0])
        elif kl == "star":
            mats = self._connector_values(inp, t, dof, 1)
            for i in range(1, n):
                add_bond(0, i, mats[0])
        elif kl == "ktwoniffour":
            # K2NiF4 reconstruction (see ktwoniffour_types): two
            # connector directions per term — [Cu-O, O-O] for the
            # hopping term, [Upd] (Cu-O only) for the density term.
            # Bonds per cell c (sites 3c=O_x, 3c+1=O_y, 3c+2=Cu):
            # Cu-O_x, Cu-O_y, O_x-O_y within the cell, and Cu-O_x of
            # the next cell (corner-sharing plaquette chain).
            mats = self._connector_values(inp, t, dof, 2)
            cu_o, o_o = mats[0], mats[1]
            if dof == 1 and len(inp.vector("Connectors", occurrence=t)) < 2:
                # one connector value = Cu-O only (the Upd term shape:
                # Immm.h:178-181 queries geometry(i,0,j,0,1) between
                # oxygens and coppers; no O-O density coupling)
                o_o = np.zeros_like(cu_o)
            ncell = (n + 2) // 3
            for cell in range(ncell):
                ox, oy, cu = 3 * cell, 3 * cell + 1, 3 * cell + 2
                if cu < n:
                    add_bond(ox, cu, cu_o)
                    add_bond(oy, cu, cu_o)
                if oy < n:
                    add_bond(ox, oy, o_o)
                nox = 3 * (cell + 1)
                if cu < n and nox < n:
                    add_bond(cu, nox, cu_o)
                elif cu < n and px and cell == ncell - 1 and ncell > 1:
                    add_bond(cu, 0, cu_o)
        elif kl in ("longrange", "raw"):
            mat = np.array(inp.matrix("Connectors", occurrence=t),
                           dtype=np.float64)
            if dof == 1:
                if mat.shape != (n, n):
                    raise ValueError("longrange Connectors must be n x n")
                if np.iscomplexobj(mat):
                    c = c.astype(complex)
                c[:, :, 0, 0] = mat
            else:
                full = mat.reshape(n, dof, n, dof).transpose(0, 2, 1, 3)
                c[:] = full
        else:
            raise ValueError(f"unsupported GeometryKind: {kind}")
        return c

    # -- queries (reference Geometry operator()) ---------------------------

    def terms(self) -> int:
        return self.nterms

    def number_of_sites(self) -> int:
        return self.nsites

    def dof(self, term: int) -> int:
        return self._dofs[term]

    def connector(self, i, orb1, j, orb2, term) -> float:
        return float(self._couplings[term][i, j, orb1, orb2])

    def coupling_matrix(self, term: int, orb1: int = 0,
                        orb2: int = 0) -> np.ndarray:
        """(n, n) site-coupling matrix for one orbital pair."""
        return self._couplings[term][:, :, orb1, orb2]

    def coupling_tensor(self, term: int) -> np.ndarray:
        """(n, n, dof, dof)."""
        return self._couplings[term]

    def kind(self, term: int = 0) -> str:
        return self._kinds[term]

    # -- symmetry support (reference: Geometry::translate / findReflection,
    #    used at src/Engine/TranslationSymmetry.h:147 and
    #    src/Engine/ReflectionSymmetry.h:87) --------------------------------

    def translate(self, site: int, direction: int, amount: int) -> int:
        n = self.nsites
        if self.kind(0).lower() == "chain":
            return (site + amount) % n
        if self.kind(0).lower() in ("ladder", "ladderx"):
            legs = self.ladder_legs
            if direction == 0:  # along the legs
                x = site // legs
                leg = site % legs
                nx = n // legs
                return ((x + amount) % nx) * legs + leg
            x = site // legs
            leg = site % legs
            return x * legs + (leg + amount) % legs
        raise ValueError("translate: unsupported geometry")

    def find_reflection(self, site: int) -> int:
        n = self.nsites
        if self.kind(0).lower() == "chain":
            return n - 1 - site
        if self.kind(0).lower() in ("ladder", "ladderx"):
            legs = self.ladder_legs
            x = site // legs
            leg = site % legs
            nx = n // legs
            return (nx - 1 - x) * legs + leg
        raise ValueError("find_reflection: unsupported geometry")

    def length(self, direction: int = 0) -> int:
        if self.kind(0).lower() == "chain":
            return self.nsites
        if self.kind(0).lower() in ("ladder", "ladderx"):
            return (self.nsites // self.ladder_legs if direction == 0
                    else self.ladder_legs)
        return self.nsites
