"""Block-factorized Kitaev solver: the full 2^n space as a Kronecker
product of two half-chains, so every hot op is a matrix product.

Counterpart of ``lanczosplusplus_tpu/models/kitaev_factored.py``:
``FactoredKitaevHamiltonian`` and ``build_factored_kitaev``.  The dense
half and cross factors are built on the host in numpy; every product of
a matvec goes through ``kernels.factor_matmul``.

The Kitaev model conserves nothing (reference: BasisKitaev.h:28-34 uses
the identity basis over 2^n words), so the state vector reshapes
losslessly into a (2^nL, 2^nR) matrix over a left/right site cut
(left = high bits, right = low bits).  The Hamiltonian splits exactly:

    H = D + H_L (x) I + I (x) H_R + sum_k P_k (x) Q_k

- D: ALL SzSz couplings and the magnetic field are diagonal in the
  product basis: one elementwise multiply of the reshaped state.
- H_L / H_R: within-half S+S- and S+S+/S-S- exchange, assembled as
  dense (2^nL, 2^nL) / (2^nR, 2^nR) matrices: one GEMM each.
- P_k (x) Q_k: each cut-crossing bond contributes up to four Kronecker
  terms (S+S-, S-S+, S+S+, S-S-) of single-site raising/lowering
  matrices: sum_k P_k X Q_k^T is two GEMMs, the first over the stacked
  P_k (a factor per batch member), the second of depth K * 2^nR over
  the Q_k side by side.

No fermion signs (spins commute), no sector bookkeeping.  Selected by
SolverOptions=factored (same flag as Heisenberg).  The factors may be
stored in bfloat16 below a real state's type (``factor_dtype``, JAX
``build_factored_kitaev(factor_dtype=)``): every product then takes
``factor_matmul``'s bf16 form, the state (and the P_k X intermediate) is
rounded to bfloat16 before it and the sums land in the state's type, and
the form is ``quantized``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import to_device
from lanczosplusplus_tpu_torch.ops import kernels


def _half_offdiag(m: int, pairs_pm, pairs_pp, jpm, jpp,
                  site_of, dtype):
    """Dense off-diagonal exchange matrix over the 2^m words of one
    half.  pairs_pm are ordered (i, j) global site pairs (S+_i S-_j
    with coefficient jpm[i, j]); pairs_pp unordered (S+S+ + S-S-,
    coefficient jpp[i, j])."""
    dim = 1 << m
    words = np.arange(dim, dtype=WORD)
    h = np.zeros((dim, dim), dtype=dtype)
    for (i, j) in pairs_pm:
        bi, bj = site_of(i), site_of(j)
        ok = (bits.get_bit(words, bi) == 0) & (bits.get_bit(words, bj) == 1)
        flip = WORD((1 << bi) | (1 << bj))
        tgt = (words ^ flip).astype(np.int64)
        np.add.at(h, (tgt[ok], words[ok].astype(np.int64)), jpm[i, j])
    for (i, j) in pairs_pp:
        bi, bj = site_of(i), site_of(j)
        occ_i = bits.get_bit(words, bi)
        occ_j = bits.get_bit(words, bj)
        ok = (occ_i == occ_j)
        flip = WORD((1 << bi) | (1 << bj))
        tgt = (words ^ flip).astype(np.int64)
        np.add.at(h, (tgt[ok], words[ok].astype(np.int64)), jpp[i, j])
    return h


def _site_op(m: int, b: int, raise_: bool, dtype):
    """Dense S+ (raise_=True) or S- single-site matrix on a 2^m half."""
    dim = 1 << m
    words = np.arange(dim, dtype=WORD)
    h = np.zeros((dim, dim), dtype=dtype)
    occ = bits.get_bit(words, b)
    ok = (occ == 0) if raise_ else (occ == 1)
    tgt = (words ^ WORD(1 << b)).astype(np.int64)
    h[tgt[ok], words[ok].astype(np.int64)] = 1.0
    return h


@dataclasses.dataclass(frozen=True)
class FactoredKitaevHamiltonian:
    diag2d: torch.Tensor  # (dimL, dimR) all diagonal terms
    hl: torch.Tensor      # (dimL, dimL) within-left exchange
    hr_t: torch.Tensor    # (dimR, dimR) transposed within-right exchange
    p: torch.Tensor       # (K, dimL, dimL) cut-crossing left factors
    q: torch.Tensor       # (K, dimR, dimR) cut-crossing right factors

    @property
    def dim(self) -> int:
        return self.diag2d.shape[0] * self.diag2d.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.diag2d.dtype

    @property
    def device(self) -> torch.device:
        return self.diag2d.device

    @property
    def quantized(self) -> bool:
        """Whether the factors are stored below the state's type (bf16),
        so that the matvec rounds the state: the solver then
        reorthogonalizes fully and refines with the factors upcast."""
        return self.hl.dtype == torch.bfloat16

    @functools.cached_property
    def q_cat(self) -> torch.Tensor:
        """(dimR, K * dimR): the Q_k side by side."""
        k, dr, _ = self.q.shape
        return self.q.permute(1, 0, 2).reshape(dr, k * dr).contiguous()

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """H applied to one (dim,) state or to every row of a batch-major
        (members, dim) block, Y = D * X + H_L X + X hr_t + sum_k P_k X
        Q_k^T: every product one ``factor_matmul`` launch (the P_k side
        one a factor for a batch).  With bf16 factors the products read
        the state, and P_k X, rounded to bf16 (JAX ``_downcast_state``)."""
        dl, dr = self.diag2d.shape
        lead = xk.shape[:-1]
        xm = xk.contiguous().view(*lead, dl, dr)
        y = self.diag2d * xm
        if self.quantized:
            xm = xm.to(torch.bfloat16)
        # right half: X hr_t = X . (hr_t^T)^T, the batch folded into rows
        kernels.factor_matmul(xm.view(-1, dr), self.hr_t.T,
                              out=y.view(-1, dr), accumulate=True)
        # left half: Y^T += X^T . hl^T
        kernels.factor_matmul(xm.transpose(-1, -2), self.hl,
                              out=y.transpose(-1, -2), accumulate=True)
        k = self.p.shape[0]
        if k:
            # px[.., a, k, d] = (P_k X)[a, d], written as (P_k X)^T =
            # X^T . P_k^T into transposed views
            px = torch.empty((*lead, dl, k, dr), dtype=y.dtype,
                             device=y.device)
            if not lead:
                kernels.factor_matmul(xm.T.expand(k, dr, dl), self.p,
                                      out=px.permute(1, 2, 0))
            else:
                for j in range(k):
                    kernels.factor_matmul(
                        xm.transpose(-1, -2), self.p[j],
                        out=px[..., j, :].transpose(-1, -2))
            # Y += [P_0 X ... P_K-1 X] [Q_0 ... Q_K-1]^T
            if self.quantized:
                px = px.to(torch.bfloat16)
            kernels.factor_matmul(px.view(*lead, dl, k * dr), self.q_cat,
                                  out=y, accumulate=True)
        return y.view(*lead, dl * dr)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)

    def to_dense(self) -> np.ndarray:
        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        return self.matmat_t(eye).T.cpu().numpy()


def build_factored_kitaev(model, basis, dtype: torch.dtype = torch.float64,
                          device="cpu", n_left=None,
                          factor_dtype=None) -> FactoredKitaevHamiltonian:
    """Split the KitaevModel Hamiltonian over a site cut.

    Right half = sites [0, nR) (low word bits), left = [nR, n).  The
    flat basis order (words ascending) IS the row-major order of the
    (2^nL, 2^nR) reshape, so no permutation wrapper is needed.

    `factor_dtype` torch.bfloat16 stores the half and cross factors in
    bf16 (a real state only); the diagonal stays in the state's type."""
    if factor_dtype not in (None, torch.bfloat16, real_dtype_of(dtype)):
        raise ValueError(f"build_factored_kitaev: factor_dtype must be None "
                         f"or torch.bfloat16, not {factor_dtype}")
    if factor_dtype == torch.bfloat16 and dtype.is_complex:
        raise ValueError(f"build_factored_kitaev: bfloat16 factors take a "
                         f"real state, not {dtype}")
    np_dtype = np.float64
    n = basis.nsite
    n_l = n_left if n_left is not None else n // 2
    n_r = n - n_l
    in_left = lambda s: s >= n_r

    jpm, jpp = model.jpm, model.jpp
    pm_pairs = [(i, j) for i in range(n) for j in range(n)
                if i != j and jpm[i, j] != 0]
    pp_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                if jpp[i, j] != 0]

    hl = _half_offdiag(
        n_l,
        [(i, j) for (i, j) in pm_pairs if in_left(i) and in_left(j)],
        [(i, j) for (i, j) in pp_pairs if in_left(i) and in_left(j)],
        jpm, jpp, lambda s: s - n_r, np_dtype)
    hr = _half_offdiag(
        n_r,
        [(i, j) for (i, j) in pm_pairs if not in_left(i) and not in_left(j)],
        [(i, j) for (i, j) in pp_pairs if not in_left(i) and not in_left(j)],
        jpm, jpp, lambda s: s, np_dtype)

    p_list, q_list = [], []

    def add_cross(lsite, rsite, coeff, l_raise, r_raise):
        if coeff == 0:
            return
        p_list.append(coeff * _site_op(n_l, lsite - n_r, l_raise, np_dtype))
        q_list.append(_site_op(n_r, rsite, r_raise, np_dtype))

    for (i, j) in pm_pairs:        # S+_i S-_j, coefficient jpm[i, j]
        if in_left(i) != in_left(j):
            if in_left(i):         # S+ on left, S- on right
                add_cross(i, j, jpm[i, j], True, False)
            else:                  # S+ on right, S- on left
                add_cross(j, i, jpm[i, j], False, True)
    for (i, j) in pp_pairs:        # jpp (S+S+ + S-S-), unordered
        if in_left(i) != in_left(j):
            l, r = (i, j) if in_left(i) else (j, i)
            add_cross(l, r, jpp[i, j], True, True)
            add_cross(l, r, jpp[i, j], False, False)

    dl, dr = 1 << n_l, 1 << n_r
    p = np.stack(p_list) if p_list else np.zeros((0, dl, dl), np_dtype)
    q = np.stack(q_list) if q_list else np.zeros((0, dr, dr), np_dtype)
    diag = model.diagonal(basis).reshape(dl, dr)
    # the factors are real; a complex state takes them through
    # factor_matmul's real-factor path
    fdt = factor_dtype or real_dtype_of(dtype)
    return FactoredKitaevHamiltonian(
        diag2d=to_device(diag, dtype, device), hl=to_device(hl, fdt, device),
        hr_t=to_device(hr.T, fdt, device), p=to_device(p, fdt, device),
        q=to_device(q, fdt, device))
