"""Block-Kronecker Hamiltonians: direct sums of Kronecker blocks with
rectangular cross-block Kronecker couplings.

Counterpart of ``lanczosplusplus_tpu/core/blockkron.py``: ``CrossTerm``,
``PermCrossTerm``, ``make_perm_cross``, ``BlockKronHamiltonian`` (``dim``,
``dtype``, ``quantized``, ``nnz``, ``matvec``, ``matmat_t`` with its tiers,
``to_dense``), ``tierize`` and ``PermutedHamiltonian``.

Several models that are not Kronecker products as a whole are once the
sector is seen as a direct sum of product blocks: the Rashba union over
(nup, ndown), the t-J and Rashba sectors under a spatial half-cut, the
FeAs spin-orbit union, the Heisenberg Sz sector under a half-cut.  The
state splits into per-block (rows, cols) matrices X_b at fixed offsets
(row-major), and

    Y_b = diag_b * X_b + row_op_b X_b + X_b col_op_b^T
        + sum_{cross: src=b'} sum_n L_n X_b' R_n^T   (+ h.c.)
        + sum_{perm cross: src=b'} sum_n a_n(r) beta_n(c) X_b'[rs_n(r), cs_n(c)]

On every device each product goes through ``kernels.factor_matmul`` and
each partial permutation through ``kernels.perm_gather``: the CPU takes
their plain versions, a CUDA tensor launches the hand-written kernels.

Launches.  A block's row and column products are one launch each, over
a batch of states too.  A tier (blocks of one padded shape, see
``tierize``) gathers its blocks into one padded (blocks, R, batch, C)
stack and runs its row and column products as one launch each, with a
factor per block through ``factor_matmul``'s batch stride on the factor.
A ``CrossTerm`` is two launches for one state (the first over its nb
factors R_n at once, the second with depth nb * rows over the L_n side by
side) and nb + 1 for a batch.  A ``PermCrossTerm`` is one ``perm_gather``
launch for all its channels.

Every term runs in the form's type: float64, float32, complex128 or
complex64.  The bf16 cross gathers (``make_perm_cross(cross_dtype=
torch.bfloat16)``, ``state_cast="bf16"``, real types only) round the
state to bfloat16 once a matvec and gather from that copy through the
kernel's bfloat16-source form, the amplitudes and sums staying in the
state's type (JAX ``_cross_state``): such a form is ``quantized``, and
the solver reorthogonalizes it fully and refines its energies with the
unquantized operator (``ops/refine``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import numpy_dtype, real_dtype_of
from lanczosplusplus_tpu_torch.ops import kernels


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous tensor of `dtype` (int32, a scalar type or bfloat16,
    which numpy lacks: rounded from the host array on the way) on
    `device` from a host array."""
    if dtype == torch.bfloat16:
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
    host = np.int32 if dtype == torch.int32 else numpy_dtype(dtype)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).astype(host)),
                           device=device)


@dataclasses.dataclass(frozen=True)
class CrossTerm:
    """Y_dst += sum_n left[n] X_src right[n]^T, plus (when add_hc) the
    Hermitian partners Y_src += sum_n left[n]^H X_dst conj(right[n])."""
    left: torch.Tensor    # (nb, rows_dst, rows_src)
    right: torch.Tensor   # (nb, cols_dst, cols_src)
    src: int
    dst: int
    add_hc: bool = True

    @functools.cached_property
    def left_cat(self) -> torch.Tensor:
        """(rows_dst, nb * rows_src): the left[n] side by side."""
        nb, rd, rs = self.left.shape
        return self.left.permute(1, 0, 2).reshape(rd, nb * rs).contiguous()

    @functools.cached_property
    def left_h_cat(self) -> torch.Tensor:
        """(rows_src, nb * rows_dst): the left[n]^H side by side."""
        nb, rd, rs = self.left.shape
        return self.left.conj().permute(2, 0, 1).reshape(
            rs, nb * rd).contiguous()

    @functools.cached_property
    def right_h(self) -> torch.Tensor:
        """(nb, cols_src, cols_dst): right[n]^H."""
        return self.right.conj().transpose(1, 2).contiguous()


@dataclasses.dataclass(frozen=True)
class PermCrossTerm:
    """Cross coupling for operators that are partial permutations on each
    factor (c / c^dag / S+- maps: at most one nonzero per row and column):

      Y_dst[r, c] += sum_n row_amp[n, r] * col_amp[n, c]
                            * X_src[row_src[n, r], col_src[n, c]]

    O(rows + cols) storage a channel, applied by one ``perm_gather``.
    Invalid destinations carry amplitude 0 (index 0).  `groups` (channels
    sharing a row map) and `col_groups` (channels sharing a column map and
    amplitudes) are the JAX package's dedup of its bond loop; the plain
    version follows them, the kernel needs none.  `state_cast` "bf16"
    gathers from the source block rounded to bfloat16 (the amplitude
    tables stay in the state's type, so the refinement applies the true
    operator)."""
    row_src: torch.Tensor   # (nb, rows_dst) int32 into src rows
    row_amp: torch.Tensor   # (nb, rows_dst)
    col_src: torch.Tensor   # (nb, cols_dst) int32 into src cols
    col_amp: torch.Tensor   # (nb, cols_dst)
    src: int
    dst: int
    groups: tuple | None = None
    col_groups: tuple | None = None
    state_cast: str | None = None


def _signature_groups(keys) -> tuple:
    """Indices grouped by equal key, in order of first appearance."""
    sig, groups = {}, []
    for k, key in enumerate(keys):
        if key in sig:
            groups[sig[key]].append(k)
        else:
            sig[key] = len(groups)
            groups.append([k])
    return tuple(tuple(g) for g in groups)


def make_perm_cross(row_src, row_amp, col_src, col_amp, src, dst,
                    dtype: torch.dtype, device="cpu",
                    cross_dtype=None) -> PermCrossTerm:
    """PermCrossTerm from host channel tables, on `device`: computes the
    shared-row-map channel groups and the shared-(column map, column
    amplitude) groups on the host.  `cross_dtype` torch.bfloat16 gathers
    a real state's source block in bfloat16 (``state_cast="bf16"``; a
    complex state is never cast, as in the JAX package)."""
    if cross_dtype not in (None, torch.bfloat16):
        raise ValueError(f"make_perm_cross: cross_dtype must be None or "
                         f"torch.bfloat16, not {cross_dtype}")
    row_src = np.asarray(row_src)
    col_src = np.asarray(col_src)
    col_amp = np.asarray(col_amp)
    groups = _signature_groups(r.tobytes() for r in row_src)
    col_groups = _signature_groups(
        c.tobytes() + a.tobytes() for c, a in zip(col_src, col_amp))
    return PermCrossTerm(
        row_src=to_device(row_src, torch.int32, device),
        row_amp=to_device(row_amp, dtype, device),
        col_src=to_device(col_src, torch.int32, device),
        col_amp=to_device(col_amp, dtype, device),
        src=src, dst=dst, groups=groups, col_groups=col_groups,
        state_cast=("bf16" if cross_dtype == torch.bfloat16
                    and not dtype.is_complex else None))


def _cross_half(x, y, right, left_cat) -> None:
    """y += sum_n L_n x R_n^T, with right (nb, cols_y, cols_x) and the
    L_n side by side in left_cat (rows_y, nb * rows_x), for one block x or
    a batch of them: T_n = x R_n^T first (one launch over the nb factors
    for one state, one launch a factor for a batch), then
    y += [L_0 ... L_nb-1] [T_0; ...; T_nb-1], one launch of depth
    nb * rows_x on transposed views."""
    nb, cy, cx = right.shape
    *lead, rx, _ = x.shape
    t = torch.empty((*lead, nb, rx, cy), dtype=x.dtype, device=x.device)
    if not lead:
        kernels.factor_matmul(x.expand(nb, rx, cx), right, out=t)
    else:
        for n in range(nb):
            kernels.factor_matmul(x, right[n], out=t[:, n])
    kernels.factor_matmul(t.view(*lead, nb * rx, cy).transpose(-1, -2),
                          left_cat, out=y.transpose(-1, -2), accumulate=True)


@dataclasses.dataclass(frozen=True)
class BlockKronHamiltonian:
    """Direct sum of Kronecker blocks with cross couplings.

    Optional tiers (see ``tierize``): blocks of one padded shape run their
    diagonal, row and column products together from the stacked tensors
    `diag_t`/`row_t`/`col_t`; blocks outside every tier (the large ones)
    keep the per-block path."""
    diag: tuple           # per block (rows, cols)
    row_ops: tuple        # per block (rows, rows) or None
    col_ops: tuple        # per block (cols, cols) or None
    cross: tuple          # CrossTerm
    shapes: tuple
    perm_cross: tuple = ()
    # tiers = ((block_idxs, R, C), ...), with per tier (k, R, C) diag_t,
    # (k, R, R) row_t and (k, C, C) col_t (or None)
    tiers: tuple | None = None
    diag_t: tuple = ()
    row_t: tuple = ()
    col_t: tuple = ()

    @property
    def dim(self) -> int:
        return sum(r * c for (r, c) in self.shapes)

    @property
    def dtype(self) -> torch.dtype:
        return self.diag[0].dtype

    @property
    def device(self) -> torch.device:
        return self.diag[0].device

    @property
    def quantized(self) -> bool:
        """Whether a stage quantizes the state below the compute type (the
        bf16 cross gathers): the solver then reorthogonalizes fully, since
        the selective omega recurrence assumes an exact three-term
        recurrence (JAX ``BlockKronHamiltonian.quantized``)."""
        return any(t.state_cast is not None for t in self.perm_cross)

    @property
    def nnz(self) -> int:
        """Couplings the equivalent flat ELL would hold (diagonal,
        per-block Kronecker rows, cross terms)."""
        def host(t):
            return t.detach().cpu().numpy()
        n = self.dim
        for b, (r, c) in enumerate(self.shapes):
            if self.row_ops[b] is not None:
                n += int(np.sum(host(self.row_ops[b]) != 0)) * c
            if self.col_ops[b] is not None:
                n += int(np.sum(host(self.col_ops[b]) != 0)) * r
        for t in self.cross:
            nl = int(np.sum(np.abs(host(t.left)) > 0, axis=(1, 2))
                     @ np.sum(np.abs(host(t.right)) > 0, axis=(1, 2)))
            n += nl * (2 if t.add_hc else 1)
        for t in self.perm_cross:
            n += int(np.sum(host(t.row_amp) != 0, axis=1)
                     @ np.sum(host(t.col_amp) != 0, axis=1))
        return n

    def _split(self, x: torch.Tensor) -> list:
        """Per-block (..., rows, cols) views of a (..., dim) tensor."""
        out, off = [], 0
        for (r, c) in self.shapes:
            out.append(x[..., off:off + r * c].view(*x.shape[:-1], r, c))
            off += r * c
        return out

    @functools.cached_property
    def _tier_maps(self) -> tuple:
        """Per tier, (gather, valid, dest): gather (k, R, C) int64 holds
        each padded slot's flat index in the state, or dim for a padding
        slot; valid (n,) the slots that are not padding, as (block * R +
        row) * C + col; dest (n,) their flat indices in the state."""
        offsets = np.cumsum([0] + [r * c for (r, c) in self.shapes])
        maps = []
        for idxs, rt, ct in self.tiers or ():
            gather = np.full((len(idxs), rt, ct), self.dim, np.int64)
            for pos, b in enumerate(idxs):
                r, c = self.shapes[b]
                gather[pos, :r, :c] = offsets[b] + np.arange(
                    r * c).reshape(r, c)
            valid = np.flatnonzero(gather.reshape(-1) < self.dim)
            maps.append(tuple(torch.as_tensor(a, device=self.device) for a in
                              (gather, valid, gather.reshape(-1)[valid])))
        return tuple(maps)

    def _apply_tier(self, t: int, xk: torch.Tensor, y: torch.Tensor) -> None:
        """The diagonal, row and column products of tier t for the
        (members, dim) block xk into y: the tier's blocks gathered into a
        zero-padded (k, R, members, C) stack, so its column products are
        one launch with (R, members) as rows and its row products one
        launch on transposed views with (members, C) as rows, each with a
        factor per block; then scattered back."""
        gather, valid, dest = self._tier_maps[t]
        members, dim = xk.shape
        k, rt, ct = gather.shape
        # member m's slots index the (members, dim + 1) padded block
        stride = torch.arange(members, device=xk.device) * (dim + 1)
        index = gather[:, :, None, :] + stride[None, None, :, None]
        xpad = torch.nn.functional.pad(xk, (0, 1))
        xt = xpad.reshape(-1)[index]                  # (k, R, members, C)
        yt = self.diag_t[t][:, :, None, :] * xt
        if self.col_t[t] is not None:
            kernels.factor_matmul(xt.view(k, rt * members, ct), self.col_t[t],
                                  out=yt.view(k, rt * members, ct),
                                  accumulate=True)
        if self.row_t[t] is not None:
            kernels.factor_matmul(
                xt.view(k, rt, members * ct).transpose(1, 2), self.row_t[t],
                out=yt.view(k, rt, members * ct).transpose(1, 2),
                accumulate=True)
        # slot (block, row, col) of member m sits at ((block * R + row) *
        # members + m) * C + col of yt
        blk_row, col = valid // ct, valid % ct
        src = (blk_row * members * ct + col)[None, :] + \
            (torch.arange(members, device=xk.device) * ct)[:, None]
        y.view(members, dim)[:, dest] = yt.reshape(-1)[src]

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """H applied to one (dim,) state or to every row of a batch-major
        (members, dim) block, in the same launches for any batch (see the
        module docstring)."""
        xk = xk.contiguous()
        y = torch.empty_like(xk)
        xs, ys = self._split(xk), self._split(y)
        in_tier = {b for idxs, _, _ in self.tiers or () for b in idxs}
        for b in range(len(xs)):
            if b not in in_tier:
                torch.mul(self.diag[b], xs[b], out=ys[b])
        for t in range(len(self.tiers or ())):
            self._apply_tier(t, xk.view(-1, self.dim), y.view(-1, self.dim))
        for b in range(len(xs)):
            if b in in_tier:
                continue
            if self.row_ops[b] is not None:
                # Y += row_op X, as Y^T += X^T row_op^T
                kernels.factor_matmul(xs[b].transpose(-1, -2),
                                      self.row_ops[b],
                                      out=ys[b].transpose(-1, -2),
                                      accumulate=True)
            if self.col_ops[b] is not None:
                kernels.factor_matmul(xs[b], self.col_ops[b], out=ys[b],
                                      accumulate=True)
        for t in self.cross:
            _cross_half(xs[t.src], ys[t.dst], t.right, t.left_cat)
            if t.add_hc:
                _cross_half(xs[t.dst], ys[t.src], t.right_h, t.left_h_cat)
        # the bf16cross source blocks: the state rounded once a matvec
        xs_bf16 = (self._split(xk.to(torch.bfloat16)) if self.quantized
                   else None)
        for t in self.perm_cross:
            src = xs[t.src] if t.state_cast is None else xs_bf16[t.src]
            kernels.perm_gather(src, ys[t.dst], rs=t.row_src,
                                a=t.row_amp, cs=t.col_src, beta=t.col_amp,
                                groups=t.groups, col_groups=t.col_groups)
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)

    def to_dense(self) -> np.ndarray:
        """Dense matrix (small sizes only): every unit vector applied in
        one batched call."""
        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        return self.matmat_t(eye).T.cpu().numpy()


def tierize(bk: BlockKronHamiltonian,
            max_elems: int = 1 << 18) -> BlockKronHamiltonian:
    """Group small blocks (rows * cols <= max_elems, both at least 2) into
    tiers of one padded shape (each side rounded up to a power of two, at
    least 8) and stack their diagonal, row and column tensors.  Blocks
    larger than the threshold keep the per-block path.  The per-block
    fields stay populated (nnz, to_dense and the plain versions use them)."""
    def up2(v):
        p = 8
        while p < v:
            p *= 2
        return p

    def stacked(ops, idxs, size, side):
        if all(ops[b] is None for b in idxs):
            return None
        out = torch.zeros((len(idxs), size, size), dtype=bk.dtype,
                          device=bk.device)
        for pos, b in enumerate(idxs):
            if ops[b] is not None:
                n = bk.shapes[b][side]
                out[pos, :n, :n] = ops[b]
        return out

    groups = {}
    for b, (r, c) in enumerate(bk.shapes):
        if r * c > max_elems or r < 2 or c < 2:
            continue
        groups.setdefault((up2(r), up2(c)), []).append(b)
    tiers, diag_t, row_t, col_t = [], [], [], []
    for (rt, ct), idxs in sorted(groups.items()):
        if len(idxs) < 2:
            continue
        tiers.append((tuple(idxs), rt, ct))
        d = torch.zeros((len(idxs), rt, ct), dtype=bk.dtype, device=bk.device)
        for pos, b in enumerate(idxs):
            r, c = bk.shapes[b]
            d[pos, :r, :c] = bk.diag[b]
        diag_t.append(d)
        row_t.append(stacked(bk.row_ops, idxs, rt, 0))
        col_t.append(stacked(bk.col_ops, idxs, ct, 1))
    if not tiers:
        return bk
    return dataclasses.replace(
        bk, tiers=tuple(tiers), diag_t=tuple(diag_t), row_t=tuple(row_t),
        col_t=tuple(col_t))


@dataclasses.dataclass(frozen=True)
class PermutedHamiltonian:
    """Order adapter: applies an inner (block-ordered) Hamiltonian to
    states given in the flat basis order (a gather before and one after
    the inner apply).  `sign` (optional, inner order, +-1) is the per-state
    phase of an inner form whose Jordan-Wigner mode order differs from the
    flat basis's (the Rashba half-cut's (-1)^(au bu) twist): flat state
    |f> = sign[inv[f]] * inner state, so H_flat = S P^T H_inner P S with
    S = diag(sign).  The solvers solve the inner form and map only their
    eigenvectors (``solver/lanczos.lowest_states``)."""
    inner: BlockKronHamiltonian
    perm: torch.Tensor   # block position p -> flat index perm[p]
    inv: torch.Tensor    # flat index f -> block position inv[f]
    sign: torch.Tensor | None = None   # (dim,) inner order, +-1 of the
    #                                     inner form's real type

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    @property
    def quantized(self) -> bool:
        return self.inner.quantized

    def to_inner(self, x: torch.Tensor) -> torch.Tensor:
        """A flat-order state (or batch-major block) in inner order."""
        xp = x[..., self.perm]
        return xp if self.sign is None else xp * self.sign

    def to_flat(self, x: torch.Tensor) -> torch.Tensor:
        """An inner-order state (or batch-major block) in flat order."""
        if self.sign is not None:
            x = x * self.sign
        return x[..., self.inv]

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        return self.to_flat(self.inner.matmat_t(self.to_inner(xk)))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)

    def to_dense(self) -> np.ndarray:
        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        return self.matmat_t(eye).T.cpu().numpy()


def permuted(inner: BlockKronHamiltonian, perm: np.ndarray,
             sign: np.ndarray | None = None) -> PermutedHamiltonian:
    """PermutedHamiltonian on the inner form's device from the host map
    perm (block position -> flat index); a sign of all +1 is dropped."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    dev = inner.device
    if sign is not None and bool((np.asarray(sign) == 1.0).all()):
        sign = None
    return PermutedHamiltonian(
        inner=inner, perm=torch.as_tensor(perm, device=dev),
        inv=torch.as_tensor(inv, device=dev),
        sign=None if sign is None else to_device(
            sign, real_dtype_of(inner.dtype), dev))
