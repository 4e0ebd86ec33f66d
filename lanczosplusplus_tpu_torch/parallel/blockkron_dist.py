"""Distributed block-Kronecker (factored) Hamiltonians.

Counterpart of ``lanczosplusplus_tpu/parallel/blockkron_dist.py``.  The
factored forms (t-J and Rashba half-cuts, Heisenberg, Kitaev, FeAs
spin-orbit; ``core/blockkron.py``) are bound by their dense GEMMs, not by
index traffic, so they are distributed the other way round from the
ELL forms: the state, small beside the work, is all-gathered once a
matvec and the work is sharded by columns.  Every block's column axis is
split over the ranks (rank r takes columns ``[r c // n, (r + 1) c // n)``
of a block of c columns; a block narrower than the mesh leaves some
ranks none), and on its columns each rank runs

- the diagonal, and the row product A_b X_b[:, cols] (``factor_matmul``);
- the column product X_b C_b[cols, :]^T against its rows of C_b;
- each ``CrossTerm`` against its rows of the right factors, each
  ``PermCrossTerm`` (``perm_gather``) on its slice of the column tables.

The rank's output is a set of column slices of the blocks, which are not
contiguous in flat order, so reassembling y into row shards is a second
collective: each rank writes its slices into a zero flat vector and one
``all_to_all_single`` sends every rank the part of it in that rank's row
shard, which the rank sums over the senders.  Every entry has exactly
one rank that wrote it, so the sum adds zeros to it and the result is
the single-device apply's, bit for bit where the products are.  gloo has
no reduce-scatter that both torch versions of the port's hosts take
without a deprecation warning; the all-to-all moves the same bytes.  The
tier stacking of ``tierize`` is not used: its stacks interleave padding
columns, which breaks the column split, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from lanczosplusplus_tpu_torch.core.blockkron import _cross_half
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.parallel.mesh import Mesh, _pad_to


@dataclasses.dataclass(frozen=True)
class DistBlockKron:
    """Column-sharded block-Kronecker matvec with row-sharded vectors at
    the boundary; the boundary dimension is padded up to a multiple of
    the mesh size with decoupled zero rows.  ``blocks`` is the form
    being sharded (its per-block fields; its tiers unused); per block b,
    ``col_range[b]`` is this rank's column range, and ``diag``,
    ``col_ops``, ``right``/``right_h`` and the ``PermCrossTerm`` column
    tables are this rank's slices of them."""
    blocks: object                # core.blockkron.BlockKronHamiltonian
    mesh: Mesh
    col_range: tuple              # per block (c0, c1)
    diag: tuple                   # per block (rows, c1 - c0)
    col_ops: tuple                # per block (c1 - c0, cols) or None
    cross_right: tuple            # per CrossTerm (right, right_h) slices
    perm_cols: tuple              # per PermCrossTerm (col_src, col_amp)

    @property
    def dim(self) -> int:
        return _pad_to(self.blocks.dim, self.mesh.size)

    @property
    def rows(self) -> int:
        return self.dim // self.mesh.size

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """H on this rank's rows of one state (rows,) or of a batch-major
        block (R, rows)."""
        bk, mesh = self.blocks, self.mesh
        lead = xk.shape[:-1]
        xf = mesh.gather_rows(xk.contiguous())[..., :bk.dim].contiguous()
        xs = bk._split(xf)
        xs_bf16 = bk._split(xf.to(torch.bfloat16)) if bk.quantized else None
        ys = []
        for b, (c0, c1) in enumerate(self.col_range):
            x_cols = xs[b][..., c0:c1]
            yb = self.diag[b] * x_cols
            if bk.row_ops[b] is not None:
                # Y[:, cols] += A X[:, cols], as Y^T += X^T A^T
                kernels.factor_matmul(x_cols.transpose(-1, -2),
                                      bk.row_ops[b],
                                      out=yb.transpose(-1, -2),
                                      accumulate=True)
            if self.col_ops[b] is not None:
                kernels.factor_matmul(xs[b], self.col_ops[b], out=yb,
                                      accumulate=True)
            ys.append(yb)
        for t, (right, right_h) in zip(bk.cross, self.cross_right):
            _cross_half(xs[t.src], ys[t.dst], right, t.left_cat)
            if t.add_hc:
                _cross_half(xs[t.dst], ys[t.src], right_h, t.left_h_cat)
        for t, (cs, beta) in zip(bk.perm_cross, self.perm_cols):
            src = xs[t.src] if t.state_cast is None else xs_bf16[t.src]
            kernels.perm_gather(src, ys[t.dst], rs=t.row_src, a=t.row_amp,
                                cs=cs, beta=beta, groups=t.groups,
                                col_groups=t.col_groups)
        # reassemble: this rank's column slices into a zero flat vector,
        # then every rank's part of its row shard, summed over the senders
        partial = xk.new_zeros((*lead, self.dim))
        pieces = bk._split(partial[..., :bk.dim])
        for b, (c0, c1) in enumerate(self.col_range):
            pieces[b][..., c0:c1] = ys[b]
        slabs = partial.view(*lead, mesh.size, self.rows).movedim(-2, 0)
        return mesh.all_to_all(slabs).sum(0)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)


def shard_blockkron(bk, mesh: Mesh) -> DistBlockKron:
    """Place a ``BlockKronHamiltonian`` for column-sharded application:
    row operators, left factors and row tables whole, this rank's column
    slices of the diagonals, the column operators' rows, the right
    factors' rows and the column tables, all on the mesh's device."""
    def split(c):
        return (mesh.rank * c // mesh.size, (mesh.rank + 1) * c // mesh.size)

    ranges = tuple(split(c) for (_, c) in bk.shapes)

    def cols_of(t, b, axis):
        """Rows or columns (`axis`) `ranges[b]` of t, a contiguous copy."""
        if t is None:
            return None
        c0, c1 = ranges[b]
        return t.narrow(axis, c0, c1 - c0).contiguous()

    cross_right = tuple(
        (cols_of(t.right, t.dst, 1), cols_of(t.right_h, t.src, 1))
        for t in bk.cross)
    perm_cols = tuple(
        (cols_of(t.col_src, t.dst, 1), cols_of(t.col_amp, t.dst, 1))
        for t in bk.perm_cross)
    return DistBlockKron(
        blocks=dataclasses.replace(bk, tiers=None, diag_t=(), row_t=(),
                                   col_t=()),
        mesh=mesh, col_range=ranges,
        diag=tuple(cols_of(d, b, 1) for b, d in enumerate(bk.diag)),
        col_ops=tuple(cols_of(c, b, 0) for b, c in enumerate(bk.col_ops)),
        cross_right=cross_right, perm_cols=perm_cols)


def blockkron_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                            seed: int = 7239443, max_steps: int = 200,
                            **solve_kw):
    """Distributed lowest_states for factored forms: a
    ``BlockKronHamiltonian``, or a ``PermutedHamiltonian`` wrapping one,
    solved in the inner block order (as the single-device solver does)
    with its eigenvectors returned in the wrapper's flat order."""
    from lanczosplusplus_tpu_torch.parallel.mesh import (
        _is_wrapped, sharded_selective_solve)

    wrapper = None
    if _is_wrapped(ham):
        wrapper, ham = ham, ham.inner
    out = sharded_selective_solve(shard_blockkron(ham, mesh), mesh, ham.dim,
                                  num_states, seed, max_steps, **solve_kw)
    if wrapper is None:
        return out
    evals, vecs, *rest = out
    return (evals, wrapper.to_flat(vecs.to(wrapper.device)), *rest)
