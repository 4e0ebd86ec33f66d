"""Distributed spin-factorized (Kronecker) Hamiltonian over a mesh.

Counterpart of ``lanczosplusplus_tpu/parallel/kron.py``.  The flat
row-partitioned forms (``mesh.ShardedHamiltonian``, ``halo``) broadcast
the spin-separable hopping into a dim-sized ELL before sharding.  This
form keeps the Kronecker structure: the state is X (size_down, size_up),
size_down padded to a multiple of the ranks, rank r holding dn rows
``[r * d_shard, (r + 1) * d_shard)``, and

- I (x) A_up: X_local A_up^T, a shard-local ``factor_matmul``, no
  communication;
- A_dn (x) I: the state's rows all-gathered, then the local rows of
  A_dn times all of them, one ``factor_matmul`` on transposed views with
  the rectangular (d_shard, size_down) slice of the factor;
- a spin-coupled remainder (FeAs U2/U3/Jpm, the SuperHubbardExtended J
  term): the local rows of a flat ELL through ``ell_spmv`` with the same
  all-gathered state as its gathers' source.

The order of the terms is the single-device ``Hamiltonian.matmat_t``'s
(diagonal or ELL, up, dn), so at one rank each product is the
single-device one.
"""

from __future__ import annotations

import dataclasses

import torch

from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class KronHamiltonian:
    """This rank's rows of a sector Hamiltonian kept in Kronecker form:
    diag (d_shard * size_up,), the replicated up factor (size_up,
    size_up), the local rows of the dn factor (d_shard, size_down_p) and
    of the optional flat remainder (d_shard * size_up, K; columns into
    the whole padded state)."""
    diag: torch.Tensor
    up_dense: torch.Tensor | None
    dn_dense: torch.Tensor | None
    ell: object | None            # core.sparse.EllPart or None
    mesh: Mesh
    spin_shape: tuple[int, int]   # the whole padded (size_down_p, size_up)

    @property
    def dim(self) -> int:
        return self.spin_shape[0] * self.spin_shape[1]

    @property
    def rows(self) -> int:
        return self.diag.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """H on this rank's rows of one state (rows,) or of a batch-major
        block (R, rows): the up GEMM with (R, d_shard) folded into its
        rows, one all-gather that feeds the dn GEMM and the remainder."""
        xk = xk.contiguous()
        szu = self.spin_shape[1]
        lead = xk.shape[:-1]
        full = (self.mesh.gather_rows(xk)
                if self.dn_dense is not None or self.ell is not None
                else None)
        if self.ell is not None:
            sliced = self.ell.sliced() if xk.is_cuda else None
            y = kernels.ell_spmv(self.diag, self.ell.cols, self.ell.vals, xk,
                                 sliced=sliced, src=full)
        else:
            y = self.diag * xk
        if self.up_dense is not None:
            kernels.factor_matmul(xk.reshape(-1, szu), self.up_dense,
                                  out=y.view(-1, szu), accumulate=True)
        if self.dn_dense is not None:
            # y[b, d, u] += sum_c A_dn[d, c] X[b, c, u], as
            # y[b]^T += X[b]^T . A_dn[local rows]^T on transposed views
            X = full.view(*lead, self.spin_shape[0], szu)
            y3 = y.view(*lead, self.rows // szu, szu)
            kernels.factor_matmul(X.transpose(-1, -2), self.dn_dense,
                                  out=y3.transpose(-1, -2), accumulate=True)
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)


def shard_kron_hamiltonian(ham, mesh: Mesh, max_factor_bytes: int = 4 << 30):
    """Place a spin-factorized sector Hamiltonian on `mesh` in Kronecker
    form, both one-spin factors densified (each up to `max_factor_bytes`;
    ValueError when either will not).  size_down is padded to a multiple
    of the mesh size (rows append at the top, so the flat indices of the
    existing entries are unchanged).  Returns (KronHamiltonian, the
    unpadded dimension)."""
    from lanczosplusplus_tpu_torch.core.sparse import EllPart

    if ham.factorized is None:
        raise ValueError("Hamiltonian has no spin-factorized part")
    h = ham.densify_factors(max_bytes=max_factor_bytes)
    f = h.factorized
    if f.up_dense is None or f.dn_dense is None or \
            f.up_dense.dtype == torch.bfloat16:
        raise ValueError("factors too large to densify (or stored in "
                         "bfloat16) for the distributed Kronecker form")
    szd, szu = h.spin_shape
    pad = (-szd) % mesh.size
    szd_p = szd + pad
    d_shard = szd_p // mesh.size
    lo, hi = mesh.rank * d_shard, (mesh.rank + 1) * d_shard
    dev, dtype = mesh.device, ham.dtype
    diag = torch.nn.functional.pad(h.diag.reshape(szd, szu),
                                   (0, 0, 0, pad))[lo:hi]
    dn = torch.nn.functional.pad(f.dn_dense, (0, pad, 0, pad))[lo:hi]
    ell = None
    if h.ell is not None:
        cols, vals = h.ell.cols, h.ell.vals
        k = cols.shape[1]
        if pad:
            extra = torch.arange(szd * szu, szd_p * szu, dtype=cols.dtype,
                                 device=cols.device)[:, None].expand(-1, k)
            cols = torch.cat([cols, extra])
            vals = torch.cat([vals, vals.new_zeros((pad * szu, k))])
        ell = EllPart(
            cols=cols[lo * szu:hi * szu].to(dev).contiguous(),
            vals=vals[lo * szu:hi * szu].to(device=dev,
                                              dtype=dtype).contiguous())
    return KronHamiltonian(
        diag=diag.reshape(-1).to(device=dev, dtype=dtype).contiguous(),
        up_dense=f.up_dense.to(dev).contiguous(),
        dn_dense=dn.to(dev).contiguous(), ell=ell, mesh=mesh,
        spin_shape=(szd_p, szu)), szd * szu


def kron_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                       seed: int = 7239443, max_steps: int = 200,
                       **solve_kw):
    """Distributed lowest_states in Kronecker form: the single-device
    selective Lanczos with the Krylov basis and the state row-sharded.
    Extra keywords (tol, krylov_budget_bytes, return_info, strict) reach
    ``mesh.sharded_selective_solve``."""
    from lanczosplusplus_tpu_torch.parallel.mesh import \
        sharded_selective_solve

    kham, _ = shard_kron_hamiltonian(ham, mesh)
    return sharded_selective_solve(kham, mesh, ham.dim, num_states, seed,
                                   max_steps, **solve_kw)
