"""Kitaev model: S=1/2, no conserved quantum number, full 2^n space.

Counterpart of ``lanczosplusplus_tpu/models/kitaev.py``.  The basis and
the arrays are built on the host in numpy and moved to the device once
(``hamiltonian_from_numpy``).

reference: src/Models/Kitaev/{Kitaev.h,BasisKitaev.h}.  Three geometry
terms Jx, Jy, Jz (Kitaev.h:52-67) recombined as
    jpm = (Jx + Jy)/4,  jpp = (Jx - Jy)/4,  jzz = Jz
so that per unordered bond
    H_bond = jpm (S+_i S-_j + S-_i S+_j) + jpp (S+_i S+_j + S-_i S-_j)
           + jzz Sz_i Sz_j,
plus a per-site MagneticField * Sz (Kitaev.h:259).

Deviation from the reference, documented: the reference's S-S- term
(Kitaev.h:338-344 setSminusSminus) reuses setSplusSminus and therefore
carries jpm instead of jpp, which makes H non-Hermitian whenever
Jx != Jy; this implementation uses jpp (the Hermitian conjugate of the
S+S+ term), which is the correct Sx Sx + Sy Sy decomposition and
coincides with the reference when Jx == Jy on every bond.

Spectral functions are unsupported for this model, as in the reference
(BasisKitaev.h:117-135 getBraIndex throws).
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy)


class KitaevBasis:
    """Identity basis over all 2^n spin-1/2 words
    (reference: BasisKitaev.h:28-34)."""

    def __init__(self, nsite: int):
        self.nsite = nsite
        self.words = np.arange(1 << nsite, dtype=WORD)

    @property
    def size(self) -> int:
        return 1 << self.nsite

    @property
    def parts(self):
        return ("full",)

    def rank(self, words: np.ndarray) -> np.ndarray:
        return words.astype(np.int64)


class KitaevModel:
    is_fermionic = False

    def __init__(self, inp, geometry):
        self.geometry = geometry
        if geometry.terms() != 3:
            raise ValueError("Kitaev: must have 3 geometry terms (Jx,Jy,Jz)")
        jx = geometry.coupling_matrix(0)
        jy = geometry.coupling_matrix(1)
        self.jpm = 0.25 * (jx + jy)
        self.jpp = 0.25 * (jx - jy)
        self.jzz = geometry.coupling_matrix(2)
        self.magnetic_field = np.array(
            inp.vector("MagneticField", default=[]), dtype=np.float64)

    def create_basis(self, parts=None) -> KitaevBasis:
        return KitaevBasis(self.geometry.number_of_sites())

    def default_parts(self, inp):
        return ("full",)

    def orbitals(self, site) -> int:
        return 1

    def has_new_parts(self, parts, op, spin, orb):
        raise NotImplementedError(
            "Kitaev: spectral functions unsupported (as in reference)")

    def diagonal(self, basis: KitaevBasis) -> np.ndarray:
        n = self.geometry.number_of_sites()
        occ = bits.bits_to_table(basis.words, n).astype(np.float64)
        m = occ - 0.5
        diag = 0.5 * np.einsum("si,ij,sj->s", m, self.jzz, m)
        if self.magnetic_field.size:
            b = np.zeros(n)
            b[:self.magnetic_field.size] = self.magnetic_field[:n]
            diag = diag + m @ b
        return diag

    def hamiltonian(self, basis: KitaevBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        n = self.geometry.number_of_sites()
        dim = basis.size
        words = basis.words
        pm_pairs = [(i, j) for i in range(n) for j in range(n)
                    if i != j and self.jpm[i, j] != 0]
        # unordered pairs: S+S+ and S-S- act symmetrically, coefficient
        # jpp once per bond (see module docstring re reference's double
        # count over ordered pairs)
        pp_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                    if self.jpp[i, j] != 0]
        k = max(len(pm_pairs) + len(pp_pairs), 1)
        cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
        vals = np.zeros((dim, k), dtype=dtype)
        slot = 0
        occ = {i: bits.get_bit(words, i) for i in range(n)}
        for (i, j) in pm_pairs:
            # S+_i S-_j: i empty, j occupied (ordered pairs cover h.c.)
            ok = (occ[i] == 0) & (occ[j] == 1)
            flip = WORD((1 << i) | (1 << j))
            tgt = np.where(ok, (words ^ flip).astype(np.int64),
                           np.arange(dim))
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, self.jpm[i, j], 0).astype(dtype)
            slot += 1
        for (i, j) in pp_pairs:
            # S+_i S+_j when both empty; S-_i S-_j generated by the row
            # whose word has both occupied (same flip), so encode both:
            both_empty = (occ[i] == 0) & (occ[j] == 0)
            both_occ = (occ[i] == 1) & (occ[j] == 1)
            ok = both_empty | both_occ
            flip = WORD((1 << i) | (1 << j))
            tgt = np.where(ok, (words ^ flip).astype(np.int64),
                           np.arange(dim))
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, self.jpp[i, j], 0).astype(dtype)
            slot += 1
        return hamiltonian_from_numpy(
            self.diagonal(basis).astype(dtype), cols, vals, None, None,
            None, None, None, device=device, dtype=torch_dtype)
