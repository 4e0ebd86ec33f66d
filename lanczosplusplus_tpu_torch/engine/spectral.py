"""Continued-fraction spectral functions.

Counterpart of ``lanczosplusplus_tpu/engine/spectral.py``: host numpy and
scipy only, the same ``.comb`` text.

Replaces PsimagLite ContinuedFraction/ContinuedFractionCollection and
the external `continuedFractionCollection` evaluator program the Perl
scripts shell out to (reference: src/Engine/Engine.h:460-490
calcSpectral; scripts/sqomega.pl:25-27).

A continued fraction is (a, b, E0, w, sigma):
    G(z) = w / (z - sigma*(a0 - E0) - b1^2 / (z - sigma*(a1 - E0) - ...))
with sigma=+1 for particle addition (poles at omega = E_n - E0) and
sigma=-1 for removal.  The reference encodes sigma as the `-s` argument
of cf.set (Engine.h:488).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ContinuedFraction:
    alphas: np.ndarray          # (m,)
    betas: np.ndarray           # (m,) b[j] couples j -> j+1
    e0: float                   # ground-state energy offset
    weight: float               # signed weight (<phi|phi> * s2)
    sigma: int                  # +1 addition / -1 removal
    meta: str = ""              # "spin,type,orb1,orb2" tag

    def evaluate(self, omegas: np.ndarray, delta: float) -> np.ndarray:
        """G(omega + i*delta) on a real frequency grid (vectorized
        backward recursion)."""
        z = np.asarray(omegas, dtype=np.complex128) + 1j * delta
        m = len(self.alphas)
        if m == 0 or self.weight == 0:
            return np.zeros_like(z)
        denom = z - self.sigma * (self.alphas[m - 1] - self.e0)
        for j in range(m - 2, -1, -1):
            b2 = self.betas[j] ** 2
            denom = z - self.sigma * (self.alphas[j] - self.e0) - b2 / denom
        return self.weight / denom

    def poles_and_weights(self):
        """Explicit Lehmann poles: eigen-decompose the tridiagonal.

        Returns (omega_n, w_n) with omega_n = sigma*(E_n - E0) and
        w_n = weight * |<n|v0>|^2 (used by the lorentzian CLI path,
        reference: src/lorentzian.cpp:86-125)."""
        import scipy.linalg
        m = len(self.alphas)
        if m == 0:
            return np.zeros(0), np.zeros(0)
        if m == 1:
            evals = self.alphas.copy()
            first = np.ones(1)
        else:
            evals, evecs = scipy.linalg.eigh_tridiagonal(
                self.alphas, self.betas[:m - 1])
            first = evecs[0, :]
        omegas = self.sigma * (evals - self.e0)
        return omegas, self.weight * first ** 2


@dataclasses.dataclass
class ContinuedFractionCollection:
    items: List[ContinuedFraction] = dataclasses.field(default_factory=list)

    def push(self, cf: ContinuedFraction):
        self.items.append(cf)

    def evaluate(self, omegas, delta) -> np.ndarray:
        """Sum of all member CFs on the grid (what the PsimagLite
        continuedFractionCollection program prints)."""
        total = np.zeros(len(omegas), dtype=np.complex128)
        for cf in self.items:
            total += cf.evaluate(omegas, delta)
        return total

    def write(self, path_or_file, index_to_cf=None):
        """Serialize in a .comb-compatible labelled-ASCII layout
        (reference: mainLoop3 writes #INDEXTOCF then the
        collection; scripts/extractOrbitals.pl:10-48 consumes
        #Avector-separated blocks)."""
        close = False
        if isinstance(path_or_file, str):
            f = open(path_or_file, "w")
            close = True
        else:
            f = path_or_file
        try:
            if index_to_cf:
                f.write("#INDEXTOCF " + " ".join(index_to_cf) + "\n")
            f.write(f"#CONTINUEDFRACTIONCOLLECTION={len(self.items)}\n")
            for cf in self.items:
                f.write("#Avector\n")
                f.write(f"#CFEnergy={float(cf.e0)!r}\n")
                f.write(f"#CFWeight={float(cf.weight)!r}\n")
                f.write(f"#CFSign={cf.sigma}\n")
                f.write(f"#CFMeta={cf.meta}\n")
                f.write(f"#CFAlphas={len(cf.alphas)}\n")
                for a in cf.alphas:
                    f.write(f"{float(a)!r}\n")
                f.write(f"#CFBetas={len(cf.betas)}\n")
                for b in cf.betas:
                    f.write(f"{float(b)!r}\n")
        finally:
            if close:
                f.close()


def read_collection(path: str) -> ContinuedFractionCollection:
    coll = ContinuedFractionCollection()
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    cur = None
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("#Avector"):
            cur = dict()
        elif ln.startswith("#CFEnergy="):
            cur["e0"] = float(ln.split("=", 1)[1])
        elif ln.startswith("#CFWeight="):
            cur["w"] = float(ln.split("=", 1)[1])
        elif ln.startswith("#CFSign="):
            cur["s"] = int(ln.split("=", 1)[1])
        elif ln.startswith("#CFMeta="):
            cur["meta"] = ln.split("=", 1)[1]
        elif ln.startswith("#CFAlphas="):
            m = int(ln.split("=", 1)[1])
            cur["a"] = np.array([float(lines[i + 1 + k]) for k in range(m)])
            i += m
        elif ln.startswith("#CFBetas="):
            m = int(ln.split("=", 1)[1])
            cur["b"] = np.array([float(lines[i + 1 + k]) for k in range(m)])
            i += m
            coll.push(ContinuedFraction(
                alphas=cur["a"], betas=cur["b"], e0=cur["e0"],
                weight=cur["w"], sigma=cur["s"], meta=cur.get("meta", "")))
        i += 1
    return coll
