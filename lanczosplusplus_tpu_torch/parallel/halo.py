"""Halo-exchange distributed SpMV.

Counterpart of ``lanczosplusplus_tpu/parallel/halo.py``.  The flat
row-sharded matvec (``mesh.ShardedHamiltonian``) all-gathers the whole
state.  ED Hamiltonians touch a bounded set of off-shard columns a row,
so the communication can be the halo: for each (owner, consumer) pair of
ranks, the unique state entries the consumer's rows read from the
owner's shard.

``HaloPlan`` precomputes on the host, from the ELL column structure (the
JAX package's numpy code, copied): per-rank send index lists padded to
the global maximum, so one ``all_to_all_single`` moves them, and the ELL
columns remapped into the concatenated [local shard | halo buffer] index
space.  A matvec is one all-to-all of the halo values and one
``ell_spmv`` of the local rows with [local ; halo] as the gathers'
source.  Whether the exchange overlaps the local SpMV is not measured.

``KronHaloPlan`` plans on the (size_down, Kd) dn factor alone: shards
align to whole dn rows, so the up factor is shard-local, the exchange
moves whole (max_rows, size_up) dn rows, and the dn gather
``y += sum_k vd[:, k] * combined[ncd[:, k], :]`` is ``perm_gather`` with
the rows gathered and the columns the identity.  A spin-coupled flat
remainder rides a second, scalar all-to-all planned on its own columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.parallel.mesh import Mesh, _to_device


class HaloPlan:
    """Host plan of the flat halo exchange (see the module docstring)."""

    def __init__(self, ham, ndev: int):
        from lanczosplusplus_tpu_torch.core.sparse import flatten_to_ell_host

        diag, cols, vals = flatten_to_ell_host(ham, ndev)
        dim = diag.shape[0]
        shard = dim // ndev

        # Vectorized: a (ndev, dim) needed-column bitmask built with one
        # scatter pass per ELL slot; the per-consumer unique remote
        # columns fall out of np.nonzero sorted (so grouped by owner,
        # owner = col // shard).  Slots that never leave their shard are
        # detected with one compare pass and skip the scatter and the
        # remap.  O(nnz) work, O(ndev * dim) memory.
        kslots = cols.shape[1]
        row_dev = (np.arange(dim, dtype=np.int64) // shard).astype(
            np.int32)
        local_lo = row_dev.astype(np.int64) * shard
        remote_slots = []
        need = np.zeros((ndev, dim), dtype=bool)
        for kk in range(kslots):
            c = cols[:, kk].astype(np.int64)
            off = c - local_lo
            if ((off >= 0) & (off < shard)).all():
                continue                       # slot is all-local
            remote_slots.append(kk)
            need[row_dev, c] = True
        for d in range(ndev):
            need[d, d * shard:(d + 1) * shard] = False

        halo_sizes = np.zeros((ndev, ndev), dtype=np.int64)
        remap = np.empty((ndev, dim), dtype=np.int32) \
            if remote_slots else None
        uniq_per_dev = [np.nonzero(need[d])[0] for d in range(ndev)]
        for d in range(ndev):
            halo_sizes[d] = np.bincount(uniq_per_dev[d] // shard,
                                        minlength=ndev)
        maxcount = max(int(halo_sizes.max(initial=0)), 1)

        # halo buffer layout per consumer: ndev slots of maxcount each
        # (slot s holds what owner s sent; own slot unused)
        send_idx = np.zeros((ndev, ndev, maxcount), dtype=np.int32)
        for d in range(ndev):
            uniq = uniq_per_dev[d]
            u_s = (uniq // shard).astype(np.int64)
            starts = np.searchsorted(u_s, np.arange(ndev))
            pos = np.arange(uniq.shape[0]) - starts[u_s]
            if remap is not None:
                remap[d] = np.arange(dim, dtype=np.int32) - d * shard
                remap[d, uniq] = shard + u_s * maxcount + pos
            send_idx[u_s, d, pos] = (uniq - u_s * shard).astype(np.int32)

        new_cols = (cols.astype(np.int64) - local_lo[:, None]).astype(
            np.int32)
        for kk in remote_slots:
            new_cols[:, kk] = remap[row_dev, cols[:, kk]]
        self.ndev = ndev
        self.shard = shard
        self.maxcount = maxcount
        self.dim = dim
        self.orig_dim = ham.dim
        self.new_cols = new_cols.astype(np.int32)
        self.vals = vals
        self.diag = diag
        self.send_idx = send_idx
        # communication volume relative to an all-gather of x (which
        # moves dim * (ndev - 1) values in total)
        self.halo_fraction = float(halo_sizes.sum()) / \
            max(dim * (ndev - 1), 1)

    def device_arrays(self, mesh: Mesh) -> dict:
        """This rank's tensors on its device: diag (shard,), cols and
        vals (shard, K), send_idx (ndev, maxcount)."""
        lo, hi = mesh.rank * self.shard, (mesh.rank + 1) * self.shard
        dtype = torch.as_tensor(self.vals[:0]).dtype
        return dict(
            diag=_to_device(self.diag[lo:hi], mesh, dtype),
            cols=_to_device(self.new_cols[lo:hi], mesh),
            vals=_to_device(self.vals[lo:hi], mesh),
            send_idx=_to_device(self.send_idx[mesh.rank], mesh,
                                torch.int64))

    def hamiltonian(self, mesh: Mesh) -> "HaloHamiltonian":
        from lanczosplusplus_tpu_torch.core.sparse import EllPart

        arrays = self.device_arrays(mesh)
        return HaloHamiltonian(
            diag=arrays["diag"],
            ell=EllPart(cols=arrays["cols"], vals=arrays["vals"]),
            send_idx=arrays["send_idx"], mesh=mesh, padded_dim=self.dim)

    def matvec_fn(self, mesh: Mesh):
        """f(diag, cols, vals, send_idx, x) -> y on this rank's rows, from
        ``device_arrays``' tensors (the plan's functional form)."""
        from lanczosplusplus_tpu_torch.core.sparse import EllPart

        def halo_matvec(diag, cols, vals, send_idx, x):
            return HaloHamiltonian(
                diag=diag, ell=EllPart(cols=cols, vals=vals),
                send_idx=send_idx, mesh=mesh,
                padded_dim=self.dim).matvec(x)
        return halo_matvec


def _exchange(mesh: Mesh, xk: torch.Tensor, send_idx: torch.Tensor,
              row_dims: int) -> torch.Tensor:
    """The halo of this rank: send_idx (ndev, count) picks from the
    trailing `row_dims` axes of xk (..., rows, *inner) what each peer
    needs; one all-to-all; returns (..., ndev * count, *inner), slab s
    what rank s sent."""
    lead = xk.dim() - row_dims
    sent = xk[(slice(None),) * lead + (send_idx,)]  # (..., ndev, count, ..)
    sent = sent.movedim(lead, 0)                    # (ndev, ..., count, ..)
    recv = mesh.all_to_all(sent).movedim(0, lead)
    return recv.flatten(lead, lead + 1)


@dataclasses.dataclass(frozen=True)
class HaloHamiltonian:
    """This rank's rows of the flat halo form: local ELL rows whose
    columns index [local shard | halo buffer]; a matvec is one
    all-to-all and one ``ell_spmv``."""
    diag: torch.Tensor        # (shard,)
    ell: object               # EllPart (shard, K), cols into [x ; halo]
    send_idx: torch.Tensor    # (ndev, maxcount) int64, local indices
    mesh: Mesh
    padded_dim: int

    @property
    def dim(self) -> int:
        return self.padded_dim

    @property
    def rows(self) -> int:
        return self.diag.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        xk = xk.contiguous()
        halo = _exchange(self.mesh, xk, self.send_idx, 1)
        src = torch.cat([xk, halo], dim=-1)
        sliced = self.ell.sliced() if xk.is_cuda else None
        return kernels.ell_spmv(self.diag, self.ell.cols, self.ell.vals, xk,
                                sliced=sliced, src=src)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)


class KronHaloPlan:
    """Halo exchange for spin-factorized Hamiltonians, planned on the
    (size_down, Kd) dn factor alone (see the module docstring): shards
    align to whole dn rows (size_down padded to a multiple of ndev), the
    all-to-all moves whole (max_rows, size_up) rows, and a spin-coupled
    flat remainder rides a second, scalar all-to-all planned on its own
    columns."""

    def __init__(self, ham, ndev: int):
        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        f = ham.factorized
        if f is None or f.dn_cols is None:
            raise ValueError("KronHaloPlan needs a spin-factorized "
                             "Hamiltonian with a dn factor")
        szd, szu = ham.spin_shape
        pad = (-szd) % ndev
        szd_p = szd + pad
        d_shard = szd_p // ndev
        cd = host(f.dn_cols).astype(np.int64)
        vd = host(f.dn_vals)
        if pad:
            cd = np.vstack([cd, np.broadcast_to(
                np.arange(szd, szd_p, dtype=np.int64)[:, None],
                (pad, cd.shape[1]))])
            vd = np.vstack([vd, np.zeros((pad, vd.shape[1]), vd.dtype)])
        kd = cd.shape[1]
        row_dev = np.arange(szd_p, dtype=np.int64) // d_shard

        # unique remote dn rows per consumer (sorted, so grouped by
        # owner, owner = dn_row // d_shard)
        need = np.zeros((ndev, szd_p), dtype=bool)
        for kk in range(kd):
            need[row_dev, cd[:, kk]] = True
        for d in range(ndev):
            need[d, d * d_shard:(d + 1) * d_shard] = False
        halo_rows = np.zeros((ndev, ndev), dtype=np.int64)
        uniq_per_dev = [np.nonzero(need[d])[0] for d in range(ndev)]
        for d in range(ndev):
            halo_rows[d] = np.bincount(uniq_per_dev[d] // d_shard,
                                       minlength=ndev)
        max_rows = max(int(halo_rows.max(initial=0)), 1)

        # dn-row remap: local -> dn_row - D*d_shard; remote ->
        # d_shard + s*max_rows + pos (position in owner s's sent tile)
        remap = np.empty((ndev, szd_p), dtype=np.int32)
        send_rows = np.zeros((ndev, ndev, max_rows), dtype=np.int32)
        for d in range(ndev):
            uniq = uniq_per_dev[d]
            u_s = uniq // d_shard
            starts = np.searchsorted(u_s, np.arange(ndev))
            pos = np.arange(uniq.shape[0]) - starts[u_s]
            remap[d] = np.arange(szd_p, dtype=np.int32) - d * d_shard
            remap[d, uniq] = d_shard + u_s * max_rows + pos
            send_rows[u_s, d, pos] = (uniq - u_s * d_shard).astype(
                np.int32)
        ncd = remap[row_dev[:, None], cd]              # (szd_p, Kd)

        # optional spin-coupled flat remainder: an entry-wise halo
        # planned on the remainder's own (small) column structure
        rem_cols = rem_vals = rem_send = None
        halo_entries = 0
        if ham.ell is not None:
            fshard = d_shard * szu
            dimp = szd_p * szu
            rc = host(ham.ell.cols).astype(np.int64)
            rv = host(ham.ell.vals)
            if pad:
                kr = rc.shape[1]
                rc = np.vstack([rc, np.broadcast_to(
                    np.arange(szd * szu, dimp,
                              dtype=np.int64)[:, None],
                    (pad * szu, kr))])
                rv = np.vstack([rv,
                                np.zeros((pad * szu, kr), rv.dtype)])
            frow_dev = np.arange(dimp, dtype=np.int64) // fshard
            rneed = np.zeros((ndev, dimp), dtype=bool)
            for kk in range(rc.shape[1]):
                rneed[frow_dev, rc[:, kk]] = True
            for d in range(ndev):
                rneed[d, d * fshard:(d + 1) * fshard] = False
            halo_ent = np.zeros((ndev, ndev), dtype=np.int64)
            runiq = [np.nonzero(rneed[d])[0] for d in range(ndev)]
            for d in range(ndev):
                halo_ent[d] = np.bincount(runiq[d] // fshard,
                                          minlength=ndev)
            max_ent = max(int(halo_ent.max(initial=0)), 1)
            rremap = np.empty((ndev, dimp), dtype=np.int32)
            rem_send = np.zeros((ndev, ndev, max_ent), dtype=np.int32)
            for d in range(ndev):
                uniq = runiq[d]
                u_s = uniq // fshard
                starts = np.searchsorted(u_s, np.arange(ndev))
                posn = np.arange(uniq.shape[0]) - starts[u_s]
                rremap[d] = (np.arange(dimp, dtype=np.int64)
                             - d * fshard).astype(np.int32)
                rremap[d, uniq] = (fshard + u_s * max_ent
                                   + posn).astype(np.int32)
                rem_send[u_s, d, posn] = (uniq - u_s * fshard).astype(
                    np.int32)
            rem_cols = rremap[frow_dev[:, None], rc].astype(np.int32)
            rem_vals = rv
            halo_entries = int(halo_ent.sum())

        diag = host(ham.diag).reshape(szd, szu)
        if pad:
            diag = np.vstack([diag, np.zeros((pad, szu), diag.dtype)])
        self.ndev = ndev
        self.spin_shape = (szd_p, szu)
        self.d_shard = d_shard
        self.max_rows = max_rows
        self.dim = szd_p * szu
        self.orig_dim = ham.dim
        self.diag2d = diag
        self.ncd = ncd
        self.vd = vd
        self.up_cols = host(f.up_cols)
        self.up_vals = host(f.up_vals)
        self.up_dense = host(f.up_dense)
        self.send_rows = send_rows
        self.rem_cols = rem_cols
        self.rem_vals = rem_vals
        self.rem_send = rem_send
        self.dtype = ham.dtype
        self.halo_fraction = \
            float(halo_rows.sum() * szu + halo_entries) / \
            max(self.dim * (ndev - 1), 1)

    def hamiltonian(self, mesh: Mesh) -> "KronHaloHamiltonian":
        """This rank's tensors on its device, the up factor densified (it
        is small beside the sector and turns the local hot loop into a
        GEMM)."""
        from lanczosplusplus_tpu_torch.core.sparse import EllPart

        up_dense = self.up_dense
        if up_dense is None and self.up_cols is not None:
            szu = self.spin_shape[1]
            a = np.zeros((szu, szu), self.up_vals.dtype)
            r = np.repeat(np.arange(szu), self.up_cols.shape[1])
            np.add.at(a, (r, self.up_cols.reshape(-1)),
                      self.up_vals.reshape(-1))
            up_dense = a
        lo, hi = mesh.rank * self.d_shard, (mesh.rank + 1) * self.d_shard
        szu = self.spin_shape[1]
        rem = None
        if self.rem_cols is not None:
            rem = EllPart(
                cols=_to_device(self.rem_cols[lo * szu:hi * szu], mesh),
                vals=_to_device(self.rem_vals[lo * szu:hi * szu], mesh,
                                self.dtype))
        return KronHaloHamiltonian(
            diag=_to_device(self.diag2d[lo:hi].reshape(-1), mesh,
                            self.dtype),
            up_dense=None if up_dense is None else
            _to_device(up_dense, mesh),
            ncd_t=_to_device(self.ncd[lo:hi].T, mesh, torch.int32),
            vd_t=_to_device(self.vd[lo:hi].T, mesh, self.dtype),
            send_rows=_to_device(self.send_rows[mesh.rank], mesh,
                                 torch.int64),
            rem=rem,
            rem_send=None if self.rem_send is None else
            _to_device(self.rem_send[mesh.rank], mesh, torch.int64),
            mesh=mesh, spin_shape=self.spin_shape)


@dataclasses.dataclass(frozen=True)
class KronHaloHamiltonian:
    """This rank's rows of the spin-factorized halo form: the local up
    GEMM (``factor_matmul``), one all-to-all of whole dn rows, the dn
    gather from [local rows ; received rows] (``perm_gather``), and with a
    remainder one scalar all-to-all and ``ell_spmv`` over [x ; halo]."""
    diag: torch.Tensor                # (d_shard * szu,)
    up_dense: torch.Tensor | None     # (szu, szu)
    ncd_t: torch.Tensor               # (Kd, d_shard) int32 remapped dn rows
    vd_t: torch.Tensor                # (Kd, d_shard)
    send_rows: torch.Tensor           # (ndev, max_rows) int64
    rem: object | None                # EllPart (d_shard * szu, Kr) or None
    rem_send: torch.Tensor | None     # (ndev, max_ent) int64
    mesh: Mesh
    spin_shape: tuple[int, int]       # the whole padded (szd_p, szu)

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
        xk = xk.contiguous()
        szu = self.spin_shape[1]
        lead = xk.shape[:-1]
        X = xk.view(*lead, self.rows // szu, szu)
        combined = torch.cat([X, _exchange(self.mesh, X, self.send_rows, 2)],
                             dim=-2)
        if self.rem is not None:
            src = torch.cat([xk, _exchange(self.mesh, xk, self.rem_send, 1)],
                            dim=-1)
            sliced = self.rem.sliced() if xk.is_cuda else None
            y = kernels.ell_spmv(self.diag, self.rem.cols, self.rem.vals, xk,
                                 sliced=sliced, src=src)
        else:
            y = self.diag * xk
        if self.up_dense is not None:
            kernels.factor_matmul(xk.reshape(-1, szu), self.up_dense,
                                  out=y.view(-1, szu), accumulate=True)
        # y[b, d, u] += sum_k vd[d, k] combined[b, ncd[d, k], u]
        kernels.perm_gather(combined, y.view(*lead, self.rows // szu, szu),
                            rs=self.ncd_t, a=self.vd_t)
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)


def halo_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                       seed: int = 7239443, max_steps: int = 200,
                       **solve_kw):
    """Distributed lowest_states with halo-exchange communication instead
    of a whole all-gather: the Kronecker-structured halo when the
    Hamiltonian factorizes with a dn factor, the flat ELL halo otherwise.
    Extra keywords (tol, krylov_budget_bytes, return_info, strict) reach
    ``mesh.sharded_selective_solve``."""
    from lanczosplusplus_tpu_torch.parallel.mesh import \
        sharded_selective_solve

    if getattr(ham, "factorized", None) is not None and \
            ham.factorized.dn_cols is not None:
        plan = KronHaloPlan(ham, mesh.size)
        return sharded_selective_solve(plan.hamiltonian(mesh), mesh,
                                       plan.orig_dim, num_states, seed,
                                       max_steps, **solve_kw)
    return _halo_lowest_states_flat(ham, mesh, num_states, seed,
                                    max_steps, **solve_kw)


def _halo_lowest_states_flat(ham, mesh: Mesh, num_states: int = 1,
                             seed: int = 7239443, max_steps: int = 200,
                             **solve_kw):
    """The flat-ELL halo solve."""
    from lanczosplusplus_tpu_torch.parallel.mesh import \
        sharded_selective_solve

    plan = HaloPlan(ham, mesh.size)
    return sharded_selective_solve(plan.hamiltonian(mesh), mesh,
                                   plan.orig_dim, num_states, seed,
                                   max_steps, **solve_kw)
