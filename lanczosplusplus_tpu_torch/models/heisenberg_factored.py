"""Block-factorized Heisenberg solver: half-chain Kronecker structure,
arbitrary spin S.

Counterpart of ``lanczosplusplus_tpu/models/heisenberg_factored.py``:
``FactoredHeisenbergChain`` and ``flat_ham``.  The halves' dense
operators and transfer matrices are built on the host in numpy; the
Hamiltonian lives on the device it is built for, where every product goes
through ``factor_matmul``.

The flat sector basis (one word per state + ELL) stores O(dim * bonds)
indices and gathers over the whole sector.  Splitting
the lattice into left/right halves L, R decomposes the
sum-of-site-values sector (TargetSzPlusConst, reference
src/Models/Heisenberg/BasisHeisenberg.h:36-47) as a direct sum over the
left digit-sum a:

    H = sum_a [ H_L(a) (x) I + I (x) H_R(M-a) ]  (within-half terms,
                                                  dense half matrices,
                                                  GEMMs)
      + cross bonds (i in L, j in R):
          Jzz sz_i (x) sz_j        (rank-1 diagonal, folded into the
                                    per-block diag table)
          (Jpm/2)(S+_i (x) S-_j + h.c.)  (stacked dense transfer
                                          matrices -> GEMMs,
                                          block a -> a+1)

Each block's state is a (dimL_a, dimR_{M-a}) matrix; half bases are
exponentially smaller than the sector, so the dense half-Hamiltonians
and transfer operators all fit trivially while every hot op is a
matrix product.  This is the spin-model analogue of the Hubbard dense-factor
path and scales chains well past what the flat ELL can hold.

Arbitrary S: half bases are base-(2S+1) digit strings (reusing
HeisenbergBasis per half), raise/lower amplitudes are
sqrt(S(S+1)-m(m+-1)) (reference Heisenberg.h:278-307; see
models/heisenberg.py for the documented S>=3/2 amplitude fix), and an
S+ on the left still moves exactly one block up (a -> a+1), so the
block-tridiagonal coupling structure is S-independent.  MagneticField
and AnisotropyD (Heisenberg.h:242-276) are single-site diagonals and
fold into the dense half-Hamiltonians.

Built on core/blockkron.py (BlockKronHamiltonian), so the factored
form gets matmat_t (batch-major SpMM for FTLM/KPM fleets) and the
PermutedHamiltonian flat-order adapter for free.

Validated against the flat HeisenbergModel path for S = 1/2 .. 2
(same physics, block ordering differs).
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import (
    BlockKronHamiltonian, CrossTerm, PermutedHamiltonian, permuted,
    to_device)
from lanczosplusplus_tpu_torch.models.heisenberg import (
    HeisenbergBasis, _raise_amp, _lower_amp)


def _half_dense_h(hb: HeisenbergBasis, jpm, jzz, offset,
                  bfield, aniso) -> np.ndarray:
    """Dense Hamiltonian of one half (within-half terms only); site i of
    the half corresponds to global site offset + i.  Includes the
    within-half Jzz/Jpm bonds plus the single-site MagneticField /
    AnisotropyD diagonals."""
    n = hb.nsite
    dim = hb.size
    m = hb.digits.astype(np.float64) - 0.5 * hb.twice_s
    sub_zz = jzz[offset:offset + n, offset:offset + n]
    diag = 0.5 * np.einsum("si,ij,sj->s", m, sub_zz, m)
    if bfield is not None:
        diag = diag + m @ bfield[offset:offset + n]
    if aniso is not None:
        diag = diag + (m * m) @ aniso[offset:offset + n]
    h = np.zeros((dim, dim))
    h[np.arange(dim), np.arange(dim)] = diag
    rows = np.arange(dim)
    for i in range(n):
        for j in range(n):
            jv = jpm[offset + i, offset + j]
            if i == j or jv == 0:
                continue
            vi = hb.digits[:, i].astype(np.int64)
            vj = hb.digits[:, j].astype(np.int64)
            ok = (vi < hb.twice_s) & (vj > 0)
            amp = 0.5 * jv * _raise_amp(hb.twice_s, vi) * \
                _lower_amp(hb.twice_s, vj)
            new = hb.set_digit(hb.words, i, vi + 1)
            new = hb.set_digit(new, j, np.maximum(vj - 1, 0))
            h[rows[ok], hb.rank(new[ok])] += amp[ok]
    return h


def _transfer(hb_src: HeisenbergBasis, hb_dst: HeisenbergBasis,
              site: int, raise_: bool) -> np.ndarray:
    """S+ (raise_) or S- at `site` within a half: dense transfer matrix
    (dst x src) with the proper sqrt amplitudes."""
    vi = hb_src.digits[:, site].astype(np.int64)
    if raise_:
        ok = vi < hb_src.twice_s
        amp = _raise_amp(hb_src.twice_s, vi)
        new_v = vi + 1
    else:
        ok = vi > 0
        amp = _lower_amp(hb_src.twice_s, vi)
        new_v = np.maximum(vi - 1, 0)
    new = hb_src.set_digit(hb_src.words, site, new_v)
    t = np.zeros((hb_dst.size, hb_src.size))
    src_idx = np.arange(hb_src.size)[ok]
    t[hb_dst.rank(new[ok]), src_idx] = amp[ok]
    return t


class FactoredHeisenbergChain:
    """Builder: split the site list at nsite//2 (any geometry whose
    couplings are given as symmetric jpm/jzz matrices; bonds crossing
    the cut become the block-tridiagonal transfer couplings)."""

    def __init__(self, model, nsite: int, szpc: int,
                 dtype: torch.dtype = torch.float64, device="cpu"):
        twice_s = model.twice_s
        n_l = nsite // 2
        n_r = nsite - n_l
        self.n_l, self.n_r = n_l, n_r
        self.twice_s = twice_s
        jpm, jzz = model.jpm, model.jzz
        if not (np.allclose(jpm, jpm.T) and np.allclose(jzz, jzz.T)):
            raise NotImplementedError(
                "factored Heisenberg: couplings must be symmetric")
        bfield = None
        if getattr(model, "magnetic_field", np.array([])).size:
            bfield = np.zeros(nsite)
            bfield[:model.magnetic_field.size] = \
                model.magnetic_field[:nsite]
        aniso = None
        if getattr(model, "anisotropy", np.array([])).size:
            aniso = np.zeros(nsite)
            aniso[:model.anisotropy.size] = model.anisotropy[:nsite]
        cross = [(i, j) for i in range(n_l)
                 for j in range(n_l, nsite)
                 if jpm[i, j] != 0 or jzz[i, j] != 0]
        self.cross = cross
        amin = max(0, szpc - n_r * twice_s)
        amax = min(n_l * twice_s, szpc)
        blocks = list(range(amin, amax + 1))
        self.blocks = blocks
        halves_l = {a: HeisenbergBasis(n_l, twice_s, a) for a in blocks}
        halves_r = {szpc - a: HeisenbergBasis(n_r, twice_s, szpc - a)
                    for a in blocks}
        self.halves_l, self.halves_r = halves_l, halves_r
        self.szpc = szpc

        shapes = []
        diag, row_ops, col_ops = [], [], []
        jzz_cross = 0.5 * (jzz[:n_l, n_l:] + jzz[n_l:, :n_l].T)
        for a in blocks:
            hl, hr = halves_l[a], halves_r[szpc - a]
            shapes.append((hl.size, hr.size))
            row_ops.append(to_device(_half_dense_h(
                hl, jpm, jzz, 0, bfield, aniso), dtype, device))
            col_ops.append(to_device(_half_dense_h(
                hr, jpm, jzz, n_l, bfield, aniso), dtype, device))
            # cross Jzz: sum_(i,j) jzz[i,j] m_l[:, i] (x) m_r[:, j]
            m_l = hl.digits.astype(np.float64) - 0.5 * twice_s
            m_r = hr.digits.astype(np.float64) - 0.5 * twice_s
            diag.append(to_device(m_l @ jzz_cross @ m_r.T, dtype, device))
        cross_terms = []
        for k, a in enumerate(blocks[:-1]):
            # S+_i(L): a -> a+1 ; S-_j(R): (szpc-a) -> (szpc-a-1);
            # h.c. (the reversed bond) is CrossTerm's add_hc
            hl, hr = halves_l[a], halves_r[szpc - a]
            hl2, hr2 = halves_l[a + 1], halves_r[szpc - a - 1]
            lefts, rights = [], []
            for (i, j) in cross:
                if jpm[i, j] == 0:
                    continue
                lefts.append(0.5 * jpm[i, j] *
                             _transfer(hl, hl2, i, True))
                rights.append(_transfer(hr, hr2, j - n_l, False))
            if not lefts:
                continue
            cross_terms.append(CrossTerm(
                left=to_device(np.stack(lefts), dtype, device),
                right=to_device(np.stack(rights), dtype, device),
                src=k, dst=k + 1, add_hc=True))
        self.ham = BlockKronHamiltonian(
            diag=tuple(diag), row_ops=tuple(row_ops),
            col_ops=tuple(col_ops), cross=tuple(cross_terms),
            shapes=tuple(shapes))

    def _block_words(self, a) -> np.ndarray:
        """(dimL, dimR) full-sector words of block a (row-major block
        layout): right-half digits sit at sites n_l.. of the packed
        word."""
        hl, hr = self.halves_l[a], self.halves_r[self.szpc - a]
        shift = WORD(self.n_l * hl.bits)
        return (hr.words.astype(WORD)[None, :] << shift) \
            | hl.words.astype(WORD)[:, None]

    def flat_perm(self, basis) -> np.ndarray:
        """perm[p] = flat (sorted-word) index of block position p."""
        perm = np.empty(self.ham.dim, dtype=np.int64)
        off = 0
        for a, (dl, dr) in zip(self.blocks, self.ham.shapes):
            words = self._block_words(a)
            perm[off:off + dl * dr] = basis.rank(words.reshape(-1))
            off += dl * dr
        return perm

    def flat_ham(self, basis) -> PermutedHamiltonian:
        return permuted(self.ham, self.flat_perm(basis))

    def to_flat_order(self, x, basis):
        """Map the block-concatenated vector to the sorted-word
        HeisenbergBasis order."""
        out = np.zeros(basis.size, dtype=np.asarray(x).dtype)
        xs = np.asarray(x)
        off = 0
        for a, (dl, dr) in zip(self.blocks, self.ham.shapes):
            idx = basis.rank(self._block_words(a).reshape(-1))
            out[idx] = xs[off:off + dl * dr]
            off += dl * dr
        return out
