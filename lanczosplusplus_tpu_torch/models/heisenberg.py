"""Heisenberg model with arbitrary spin S.

Counterpart of ``lanczosplusplus_tpu/models/heisenberg.py``.  The basis
and the arrays are built on the host in numpy and moved to the device once
(``hamiltonian_from_numpy``).

reference: src/Models/Heisenberg/{Heisenberg.h,BasisHeisenberg.h,
ParametersHeisenberg.h}.  Site value val in [0, 2S] is packed in
`bits`-per-site fields of one word; the sector is fixed
szPlusConst = sum(val) (TargetSzPlusConst=); geometry must have 2 terms:
J_pm (term 0) and J_zz (term 1) (Heisenberg.h:49-60).

H = sum_{i<j} Jzz(i,j) Sz_i Sz_j
  + 0.5 sum_{i!=j} Jpm(i,j) S+_i S-_j
  + sum_i B_i Sz_i + D_i Sz_i^2
(diagonal per Heisenberg.h:242-276, off-diagonal 278-307).

Deviation from the reference, documented: for S >= 3/2 the reference's
raise/lower amplitude (Heisenberg.h:301-303) uses the lowering
amplitude of site j twice; this implementation uses the correct
sqrt(S(S+1)-m_i(m_i+1)) * sqrt(S(S+1)-m_j(m_j-1)).  Both agree for
S = 1/2 and S = 1 (every raise amplitude is m-independent there),
which covers all reference test inputs.

Design: the basis is a sorted word array (rank = searchsorted,
replacing the reference's linear-scan perfectIndex,
BasisHeisenberg.h:73-80); the Hamiltonian is diagonal + one generic ELL
block with one slot per ordered coupled site pair.
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.core.bits import WORD


def _bits_per_site(twice_s: int) -> int:
    # reference BasisHeisenberg.h:36-37
    b = 1 + int(np.floor(np.log2(twice_s + 1)))
    if twice_s & 1:
        b -= 1
    return max(b, 1)


class HeisenbergBasis:
    def __init__(self, nsite: int, twice_s: int, sz_plus_const: int):
        self.nsite = nsite
        self.twice_s = twice_s
        self.sz_plus_const = sz_plus_const
        self.bits = _bits_per_site(twice_s)
        self.words = self._enumerate()
        self.digits = self._digit_table()

    @property
    def parts(self):
        return (self.twice_s, self.sz_plus_const)

    @property
    def size(self):
        return self.words.shape[0]

    def _enumerate(self) -> np.ndarray:
        """All words whose per-site digits are <= 2S and sum to
        szPlusConst, ascending (the reference's scan order,
        BasisHeisenberg.h:36-47) — built by per-site DP, no 2^(bits*n)
        scan."""
        target = self.sz_plus_const
        words = np.zeros(1, dtype=WORD)
        sums = np.zeros(1, dtype=np.int64)
        for site in range(self.nsite):
            shift = WORD(site * self.bits)
            remaining_max = (self.nsite - site - 1) * self.twice_s
            cand_w = []
            cand_s = []
            for d in range(self.twice_s + 1):
                s = sums + d
                ok = (s <= target) & (target - s <= remaining_max)
                cand_w.append(words[ok] | (WORD(d) << shift))
                cand_s.append(s[ok])
            words = np.concatenate(cand_w)
            sums = np.concatenate(cand_s)
        return np.sort(words[sums == target])

    def _digit_table(self) -> np.ndarray:
        """(size, nsite) int8 site values."""
        mask = WORD((1 << self.bits) - 1)
        shifts = (np.arange(self.nsite, dtype=WORD) * WORD(self.bits))
        return ((self.words[:, None] >> shifts[None, :])
                & mask).astype(np.int8)

    def rank(self, words: np.ndarray) -> np.ndarray:
        """searchsorted perfect index (replaces linear scan)."""
        idx = np.searchsorted(self.words, words)
        return idx

    def set_digit(self, words: np.ndarray, site: int,
                  value: np.ndarray) -> np.ndarray:
        mask = WORD((1 << self.bits) - 1) << WORD(site * self.bits)
        return (words & ~mask) | \
            (value.astype(WORD) << WORD(site * self.bits))


def _raise_amp(twice_s, m_val):
    """<m+1|S+|m> = sqrt(S(S+1) - m(m+1)) with m = val - S."""
    s = 0.5 * twice_s
    m = m_val - s
    return np.sqrt(np.maximum(s * (s + 1) - m * (m + 1), 0.0))


def _lower_amp(twice_s, m_val):
    s = 0.5 * twice_s
    m = m_val - s
    return np.sqrt(np.maximum(s * (s + 1) - m * (m - 1), 0.0))


class HeisenbergModel:
    is_fermionic = False

    def __init__(self, inp, geometry):
        self.geometry = geometry
        self.twice_s = inp.integer("HeisenbergTwiceS", default=1)
        n = geometry.number_of_sites()
        if geometry.terms() != 2:
            raise ValueError("Heisenberg needs 2 geometry terms (Jpm, Jzz)")
        self.jpm = geometry.coupling_matrix(0)
        self.jzz = geometry.coupling_matrix(1)
        self.magnetic_field = np.array(
            inp.vector("MagneticField", default=[]), dtype=np.float64)
        self.anisotropy = np.array(
            inp.vector("AnisotropyD", default=[]), dtype=np.float64)

    def symmetry_form(self, basis: HeisenbergBasis,
                      dtype: torch.dtype = torch.float64, device="cpu"):
        """The form symmetry sectors read their rows from: the half-cut
        Sz blocks' flat form, which keeps its Kronecker factors
        unexpanded."""
        from lanczosplusplus_tpu_torch.models.heisenberg_factored import (
            FactoredHeisenbergChain)
        return FactoredHeisenbergChain(
            self, basis.nsite, basis.sz_plus_const, dtype=dtype,
            device=device).flat_ham(basis)

    def create_basis(self, parts) -> HeisenbergBasis:
        twice_s, szpc = parts
        return HeisenbergBasis(self.geometry.number_of_sites(),
                               twice_s, szpc)

    def default_parts(self, inp):
        szpc = inp.integer("TargetSzPlusConst")
        return (self.twice_s, szpc)

    def orbitals(self, site) -> int:
        return 1

    def has_new_parts(self, parts, op, spin, orb):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        twice_s, szpc = parts
        if op.name in (ops.SZ, ops.NIL):
            return parts
        if op.name in (ops.SPLUS, ops.SMINUS):
            c = 1 if op.name == ops.SPLUS else -1
            new = szpc + c
            if new < 0 or new > self.geometry.number_of_sites() * twice_s:
                return None
            return (twice_s, new)
        raise ValueError(f"Heisenberg hasNewParts: unsupported {op.name}")

    # -- Hamiltonian ------------------------------------------------------

    def diagonal(self, basis: HeisenbergBasis) -> np.ndarray:
        m = basis.digits.astype(np.float64) - 0.5 * basis.twice_s
        n = self.geometry.number_of_sites()
        diag = 0.5 * np.einsum("si,ij,sj->s", m, self.jzz, m)
        if self.magnetic_field.size:
            b = np.zeros(n)
            b[:self.magnetic_field.size] = self.magnetic_field[:n]
            diag = diag + m @ b
        if self.anisotropy.size:
            d = np.zeros(n)
            d[:self.anisotropy.size] = self.anisotropy[:n]
            diag = diag + (m * m) @ d
        return diag

    def hamiltonian(self, basis: HeisenbergBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        n = self.geometry.number_of_sites()
        pairs = [(i, j) for i in range(n) for j in range(n)
                 if i != j and self.jpm[i, j] != 0]
        dim = basis.size
        k = max(len(pairs), 1)
        cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
        vals = np.zeros((dim, k), dtype=dtype)
        digits = basis.digits
        for kk, (i, j) in enumerate(pairs):
            vi = digits[:, i].astype(np.int64)
            vj = digits[:, j].astype(np.int64)
            ok = (vi < basis.twice_s) & (vj > 0)
            amp = 0.5 * self.jpm[i, j] * \
                _raise_amp(basis.twice_s, vi) * \
                _lower_amp(basis.twice_s, vj)
            new = basis.set_digit(basis.words, i, vi + 1)
            new = basis.set_digit(new, j, np.maximum(vj - 1, 0))
            tgt = np.where(ok, basis.rank(new), np.arange(dim))
            cols[:, kk] = tgt
            vals[:, kk] = np.where(ok, amp, 0).astype(dtype)
        return hamiltonian_from_numpy(
            self.diagonal(basis).astype(dtype), cols, vals, None, None,
            None, None, None, device=device, dtype=torch_dtype)

    # -- operator maps ----------------------------------------------------

    def operator_map(self, op, site, spin, orb, src_basis: HeisenbergBasis,
                     dst_basis: HeisenbergBasis):
        """reference: BasisHeisenberg.h getBraIndex (S=1/2 restricted
        there); implemented for general S with proper amplitudes; spins
        are bosonic, no sign factors."""
        from lanczosplusplus_tpu_torch.engine import operators as ops

        dim = src_basis.size
        vi = src_basis.digits[:, site].astype(np.int64)
        idx = np.arange(dim, dtype=np.int64)
        if op.name == ops.SZ:
            val = vi.astype(np.float64) - 0.5 * src_basis.twice_s
            tgt = np.where(val != 0, idx, -1)
            return tgt, val, dst_basis.size
        if op.name == ops.N:
            # site value as a diagonal observable
            tgt = np.where(vi != 0, idx, -1)
            return tgt, vi.astype(np.float64), dst_basis.size
        if op.name in (ops.SPLUS, ops.SMINUS):
            if op.name == ops.SPLUS:
                ok = vi < src_basis.twice_s
                amp = _raise_amp(src_basis.twice_s, vi)
                new_v = vi + 1
            else:
                ok = vi > 0
                amp = _lower_amp(src_basis.twice_s, vi)
                new_v = np.maximum(vi - 1, 0)
            new = src_basis.set_digit(src_basis.words, site, new_v)
            tgt = np.where(ok, dst_basis.rank(new), -1)
            return tgt, np.where(ok, amp, 0.0), dst_basis.size
        raise ValueError(f"Heisenberg operator_map: unsupported {op.name}")
