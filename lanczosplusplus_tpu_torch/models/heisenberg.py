"""Heisenberg model with arbitrary spin S.

Counterpart of ``lanczosplusplus_tpu/models/heisenberg.py``.  The basis
is built on the host in numpy.  At S = 1/2 the tables are built in torch on
the device the Hamiltonian is for (``_spin_half_hamiltonian``); at S >= 1
they are built on the host and moved to the device once
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
block with one slot per ordered coupled site pair.  At S = 1/2 a word is
the set of its up spins, so the sector's ascending words are the
combinations in colex order: they are enumerated as such
(``core/combinatorics``), a hop is an XOR of two bits, and the table build
ranks its targets by the combinadic formula.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.combinatorics import (
    binomial_table, enumerate_combinations)
from lanczosplusplus_tpu_torch.core.sparse import (
    EllPart, Hamiltonian, hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.utils.progress import count


def _bits_per_site(twice_s: int) -> int:
    # reference BasisHeisenberg.h:36-37
    b = 1 + int(np.floor(np.log2(twice_s + 1)))
    if twice_s & 1:
        b -= 1
    return max(b, 1)


def _enumerate_digits(nsite: int, twice_s: int, bits: int,
                     target: int) -> np.ndarray:
    """All words of `nsite` fields of `bits` bits whose digits are <= 2S
    and sum to `target`, ascending (the reference's scan order,
    BasisHeisenberg.h:36-47) — built by per-site DP, no 2^(bits*n)
    scan."""
    words = np.zeros(1, dtype=WORD)
    sums = np.zeros(1, dtype=np.int64)
    for site in range(nsite):
        shift = WORD(site * bits)
        remaining_max = (nsite - site - 1) * twice_s
        cand_w = []
        cand_s = []
        for d in range(twice_s + 1):
            s = sums + d
            ok = (s <= target) & (target - s <= remaining_max)
            cand_w.append(words[ok] | (WORD(d) << shift))
            cand_s.append(s[ok])
        words = np.concatenate(cand_w)
        sums = np.concatenate(cand_s)
    return np.sort(words[sums == target])


class HeisenbergBasis:
    def __init__(self, nsite: int, twice_s: int, sz_plus_const: int):
        self.nsite = nsite
        self.twice_s = twice_s
        self.sz_plus_const = sz_plus_const
        self.bits = _bits_per_site(twice_s)
        if twice_s == 1:
            # the combinations of sz_plus_const up spins, in colex order
            self.words = (enumerate_combinations(nsite, sz_plus_const)
                          if 0 <= sz_plus_const <= nsite
                          else np.zeros(0, dtype=WORD))
        else:
            self.words = _enumerate_digits(nsite, twice_s, self.bits,
                                           sz_plus_const)

    @property
    def parts(self):
        return (self.twice_s, self.sz_plus_const)

    @property
    def size(self):
        return self.words.shape[0]

    @functools.cached_property
    def digits(self) -> np.ndarray:
        """(size, nsite) int8 site values, made at the first read."""
        mask = WORD((1 << self.bits) - 1)
        shifts = (np.arange(self.nsite, dtype=WORD) * WORD(self.bits))
        return ((self.words[:, None] >> shifts[None, :])
                & mask).astype(np.int8)

    def rank(self, words: np.ndarray) -> np.ndarray:
        """searchsorted perfect index (replaces linear scan).  At S = 1/2
        it equals the combinadic rank, which numpy computes several times
        slower for the nearly sorted words an operator map ranks."""
        return np.searchsorted(self.words, words)

    def set_digit(self, words: np.ndarray, site: int,
                  value: np.ndarray) -> np.ndarray:
        mask = WORD((1 << self.bits) - 1) << WORD(site * self.bits)
        return (words & ~mask) | \
            (value.astype(WORD) << WORD(site * self.bits))


def _colex_rank(words: torch.Tensor, nsite: int,
                table: torch.Tensor) -> torch.Tensor:
    """``core/combinatorics.rank_combinations`` on the words' device:
    sum over the set bits b of C(b, c_b), c_b the bits set up to and with
    b, gathered from the binomial `table`."""
    rank = torch.zeros_like(words)
    seen = torch.zeros_like(words)
    for b in range(nsite):
        bit = (words >> b) & 1
        seen += bit
        rank += bit * table[b][seen]
    return rank


def _per_site(values: np.ndarray, n: int) -> np.ndarray:
    """`values` zero-padded or cut to n sites."""
    out = np.zeros(n)
    out[:values.size] = values[:n]
    return out


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
            diag = diag + m @ _per_site(self.magnetic_field, n)
        if self.anisotropy.size:
            diag = diag + (m * m) @ _per_site(self.anisotropy, n)
        return diag

    def _pairs(self) -> list[tuple[int, int]]:
        """The ordered coupled site pairs, one ELL slot each."""
        n = self.geometry.number_of_sites()
        return [(i, j) for i in range(n) for j in range(n)
                if i != j and self.jpm[i, j] != 0]

    def hamiltonian(self, basis: HeisenbergBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        if basis.twice_s == 1:
            return self._spin_half_hamiltonian(basis, dtype, device)
        return self._generic_hamiltonian(basis, dtype, device)

    def _generic_hamiltonian(self, basis: HeisenbergBasis,
                             dtype: torch.dtype = torch.float64,
                             device="cpu") -> Hamiltonian:
        """Any S, on the host: digits raised and lowered field by field,
        targets ranked, amplitudes per row."""
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        pairs = self._pairs()
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

    def _spin_half_hamiltonian(self, basis: HeisenbergBasis,
                               dtype: torch.dtype = torch.float64,
                               device="cpu") -> Hamiltonian:
        """S = 1/2, in torch on `device`: S+_i S-_j moves the up spin of
        site j to an empty site i, an XOR of the two bits with amplitude
        Jpm(i, j) / 2 on every such row; the target is the new word's
        colex rank.  Only the rows that hop are ranked, into a (K, dim)
        buffer whose other entries point at their own row with value 0,
        transposed once into the ELL layout.  The same cols, vals and diag
        as ``_generic_hamiltonian``."""
        n = basis.nsite
        pairs = self._pairs()
        dim = basis.size
        k = max(len(pairs), 1)
        words = torch.from_numpy(basis.words.view(np.int64)).to(device)
        table = torch.from_numpy(binomial_table(n + 1)).to(device)
        cols = torch.arange(dim, dtype=torch.int32,
                            device=device).repeat(k, 1)
        vals = torch.zeros((k, dim), dtype=dtype, device=device)
        for kk, (i, j) in enumerate(pairs):
            empty_i = ((words >> i) & 1) == 0
            up_j = ((words >> j) & 1) == 1
            rows = torch.nonzero(empty_i & up_j).squeeze(1)
            hopped = words[rows] ^ ((1 << i) | (1 << j))
            cols[kk, rows] = _colex_rank(hopped, n, table).to(torch.int32)
            # the amplitude in the table's type, as numpy casts it
            vals[kk, rows] = np.asarray(0.5 * self.jpm[i, j]).astype(
                numpy_dtype(dtype)).item()
        # 0.5 sum_ij Jzz_ij m_i m_j + sum_i B_i m_i + D_i m_i^2, with m the
        # site values less 1/2, summed in elementwise passes: a BLAS
        # product would leave its workspace allocated on the card
        m = [((words >> s) & 1).to(torch.float64) - 0.5 for s in range(n)]
        diag = torch.zeros(dim, dtype=torch.float64, device=device)
        for i, j in zip(*np.nonzero(self.jzz)):
            diag += float(0.5 * self.jzz[i, j]) * (m[i] * m[j])
        fields = zip(_per_site(self.magnetic_field, n),
                     _per_site(self.anisotropy, n))
        for s, (b, d) in enumerate(fields):
            if b:
                diag += float(b) * m[s]
            if d:
                diag += float(d) * (m[s] * m[s])
        count("build.combinadic")
        return Hamiltonian(
            diag=diag.to(dtype),
            ell=EllPart(cols=cols.t().contiguous(),
                        vals=vals.t().contiguous()),
            factorized=None)

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
