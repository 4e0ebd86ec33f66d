"""Sector Hamiltonians as tensors: diagonal, generic ELL, Kronecker factors.

Counterpart of ``lanczosplusplus_tpu/core/sparse.py``, the parts on the
ground-state path: ``coo_to_ell``, ``one_spin_ell``, ``EllPart``,
``SpinFactorizedPart`` in its gather and dense forms, and ``Hamiltonian``
with ``matvec``, ``densify_factors`` and ``to_dense``.  The reference
stores each sector Hamiltonian as a CRS matrix (reference:
src/Engine/DefaultSymmetry.h:54-57, src/Models/HubbardOneOrbital/
HubbardHelper.h:75-103).

Layout.  ED Hamiltonians have bounded row sparsity, so the generic part
is ELL: padded (dim, K) ``cols``/``vals`` with padding pointing at its
own row with value 0.  Terms acting on one spin species are Kronecker
products I (x) A_up and A_dn (x) I, applied to the state viewed as the
(size_down, size_up) matrix X: either as per-bond gathers of the
one-spin ELL maps (the CPU form), or, after ``densify_factors``, as two
GEMMs Y += X . A_up^T and Y += A_dn . X through the hand-written
``factor_matmul`` kernel (the accelerator form).  The diagonal plus the
generic ELL part go through the ``ell_spmv`` kernel.  A ``Hamiltonian``'s
generic ELL tensors are stored K-major: (K, dim) contiguous storage seen
as (dim, K) through a transposed view, so that the kernel's one thread
per row reads neighbouring addresses for each k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lanczosplusplus_tpu_torch.ops import kernels

DEFAULT_DENSE_FACTOR_BYTES = 2 << 30
GATHER_ON_CUDA = ("the one-spin gather apply has no CUDA kernel yet "
                  "(ROADMAP Queue 2 item 3); on the card every one-spin "
                  "factor must be densified")


def coo_to_ell(dim: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, min_k: int = 1):
    """Merge-duplicate COO -> padded ELL (cols, vals) numpy arrays.

    Padding entries point at their own row with value 0 so the gather
    stays in-bounds.  Equivalent to SparseRow::finalize's duplicate
    merging (reference: PsimagLite SparseRow, used at
    HubbardHelper.h:99).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if rows.size == 0:
        k = max(min_k, 1)
        return (np.tile(np.arange(dim, dtype=np.int32)[:, None], (1, k)),
                np.zeros((dim, k), dtype=vals.dtype if vals.size else np.float64))
    key = rows * np.int64(dim) + cols
    order = np.argsort(key, kind="stable")
    key_s, vals_s = key[order], vals[order]
    uniq, inv = np.unique(key_s, return_inverse=True)
    merged = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(merged, inv, vals_s)
    nz = merged != 0
    uniq, merged = uniq[nz], merged[nz]
    r = (uniq // dim).astype(np.int64)
    c = (uniq % dim).astype(np.int64)
    counts = np.bincount(r, minlength=dim)
    k = max(int(counts.max(initial=0)), min_k)
    # position of each entry within its row
    offsets = np.zeros(dim + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(r.shape[0], dtype=np.int64) - offsets[r]
    ell_cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
    ell_vals = np.zeros((dim, k), dtype=vals.dtype)
    ell_cols[r, pos] = c
    ell_vals[r, pos] = merged
    return ell_cols.astype(np.int32), ell_vals


def one_spin_ell(words: np.ndarray, rank_fn, bonds, dtype) -> tuple:
    """Build the one-spin hopping ELL map for a set of directed bonds.

    For each directed bond (i, j, t): rows where site i is occupied and
    site j empty hop with amplitude t * doSign(ket,i) * doSign(ket^bit_i,j)
    (reference: HubbardHelper.h:191-243 setHoppingTerm).

    Returns numpy (cols, vals) of shape (len(words), nbonds), padded with
    the row's own column and value 0.  `dtype` is a numpy dtype.
    """
    from lanczosplusplus_tpu_torch.core import bits

    sz = words.shape[0]
    nb = max(len(bonds), 1)
    cols = np.tile(np.arange(sz, dtype=np.int64)[:, None], (1, nb))
    vals = np.zeros((sz, nb), dtype=dtype)
    for k, (i, j, t) in enumerate(bonds):
        occ_i = bits.get_bit(words, i)
        occ_j = bits.get_bit(words, j)
        ok = (occ_i == 1) & (occ_j == 0)
        sign = bits.parity_sign_below(words, i)
        mid = bits.flip_bit(words, i)
        sign = sign * bits.parity_sign_below(mid, j)
        new_words = bits.flip_bit(mid, j)
        tgt = np.where(ok, rank_fn(new_words), np.arange(sz))
        cols[:, k] = tgt
        vals[:, k] = np.where(ok, t * sign, 0).astype(dtype)
    # H[ket, bra] = amp is already gather form: y[r] = sum_k vals[r, k] *
    # x[cols[r, k]]; the bond list carries both directions.
    return cols.astype(np.int32), vals


@dataclasses.dataclass(frozen=True)
class EllPart:
    """Generic ELL block: y[i] += sum_k vals[i, k] * x[cols[i, k]].
    ``hamiltonian_from_numpy`` stores both tensors K-major, strides
    (1, dim)."""
    cols: torch.Tensor  # (dim, K) int32
    vals: torch.Tensor  # (dim, K)


def _dense_from_ell(cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(size, size) matrix of a one-spin ELL map (duplicates summed)."""
    size, k = cols.shape
    a = torch.zeros((size, size), dtype=vals.dtype, device=vals.device)
    rows = torch.arange(size, device=cols.device).repeat_interleave(k)
    a.index_put_((rows, cols.reshape(-1).long()), vals.reshape(-1),
                 accumulate=True)
    return a


@dataclasses.dataclass(frozen=True)
class SpinFactorizedPart:
    """Kronecker-structured one-spin hop maps.

    x is viewed as X[size_down, size_up]; `up` acts along axis 1
    (I_down (x) A_up), `dn` along axis 0 (A_dn (x) I_up).  Gather form:
    the ELL maps `*_cols`/`*_vals`.  Dense form: `up_dense`/`dn_dense`,
    the (size, size) one-spin matrices, applied through ``factor_matmul``.
    """
    up_cols: torch.Tensor | None  # (size_up, Ku) int32
    up_vals: torch.Tensor | None
    dn_cols: torch.Tensor | None  # (size_down, Kd) int32
    dn_vals: torch.Tensor | None
    up_dense: torch.Tensor | None = None  # (size_up, size_up)
    dn_dense: torch.Tensor | None = None  # (size_down, size_down)

    def apply_(self, x2d: torch.Tensor, y2d: torch.Tensor) -> None:
        """y2d += (I (x) A_up + A_dn (x) I) x2d, in place on y2d.  On CUDA
        every factor must be dense: the gather form has no kernel on the
        card yet, so it raises there."""
        if x2d.is_cuda and ((self.up_cols is not None and
                             self.up_dense is None) or
                            (self.dn_cols is not None and
                             self.dn_dense is None)):
            raise NotImplementedError(GATHER_ON_CUDA)
        if self.up_dense is not None:
            # y[d, u] += sum_c x[d, c] A_up[u, c]
            kernels.factor_matmul(x2d, self.up_dense, out=y2d,
                                  accumulate=True)
        elif self.up_cols is not None:
            for k in range(self.up_cols.shape[1]):
                y2d += self.up_vals[:, k] * x2d[:, self.up_cols[:, k]]
        if self.dn_dense is not None:
            # y[d, u] += sum_c A_dn[d, c] x[c, u], as y^T += x^T . A_dn^T
            # on transposed views
            kernels.factor_matmul(x2d.T, self.dn_dense, out=y2d.T,
                                  accumulate=True)
        elif self.dn_cols is not None:
            for k in range(self.dn_cols.shape[1]):
                y2d += self.dn_vals[:, k, None] * x2d[self.dn_cols[:, k], :]


@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    """Sector Hamiltonian H = diag + ELL + spin-factorized parts, all
    tensors on one device.  This is what the Lanczos solver applies
    (reference: src/Engine/InternalProductStored.h:104-132,
    HubbardHelper.h:105-134)."""
    diag: torch.Tensor                         # (dim,)
    ell: EllPart | None
    factorized: SpinFactorizedPart | None
    spin_shape: tuple[int, int] | None = None  # (size_down, size_up)

    @property
    def dim(self) -> int:
        return self.diag.shape[0]

    @property
    def device(self) -> torch.device:
        return self.diag.device

    @property
    def dtype(self) -> torch.dtype:
        if self.ell is not None:
            return self.ell.vals.dtype
        if self.factorized is not None:
            for v in (self.factorized.up_vals, self.factorized.dn_vals):
                if v is not None:
                    return v.dtype
        return self.diag.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.ell is not None:
            y = kernels.ell_spmv(self.diag, self.ell.cols, self.ell.vals, x)
        else:
            y = self.diag * x
        if self.factorized is not None:
            self.factorized.apply_(x.view(self.spin_shape),
                                   y.view(self.spin_shape))
        return y

    def densify_factors(self, max_bytes: int | None = None) -> "Hamiltonian":
        """Materialize the Kronecker one-spin factors as dense matrices
        when each fits in `max_bytes`, so matvec runs as GEMMs.  By
        default a factor may take a quarter of the card's free memory
        (``torch.cuda.mem_get_info``), or 2 GiB on the CPU.  On the CPU a
        factor too large stays in gather form; on CUDA it raises
        ``NotImplementedError``, since the gather form has no kernel on
        the card.  The ELL maps are kept alongside, so ``to_dense`` keeps
        working."""
        f = self.factorized
        if f is None:
            return self
        on_cuda = self.device.type == "cuda"
        if max_bytes is None:
            max_bytes = (torch.cuda.mem_get_info(self.device)[0] // 4
                         if on_cuda else DEFAULT_DENSE_FACTOR_BYTES)

        def densify(cols, vals):
            if cols is None:
                return None
            size = cols.shape[0]
            nbytes = size * size * vals.element_size()
            if nbytes > max_bytes:
                if on_cuda:
                    raise NotImplementedError(
                        f"dense one-spin factor {size}x{size} needs "
                        f"{nbytes} B, over the {max_bytes} B allowed; "
                        + GATHER_ON_CUDA)
                return None
            return _dense_from_ell(cols, vals)

        up_d = densify(f.up_cols, f.up_vals)
        dn_d = densify(f.dn_cols, f.dn_vals)
        if up_d is None and dn_d is None:
            return self
        return dataclasses.replace(
            self, factorized=dataclasses.replace(f, up_dense=up_d,
                                                 dn_dense=dn_d))

    def to_dense(self) -> np.ndarray:
        """Dense matrix for oracle tests (reference dumpmatrix path,
        src/Engine/DefaultSymmetry.h:61-94)."""
        def host(t):
            return t.detach().cpu().numpy()

        dim = self.dim
        m = np.zeros((dim, dim), dtype=host(self.diag).dtype
                     if self.ell is None else host(self.ell.vals).dtype)
        m[np.arange(dim), np.arange(dim)] += host(self.diag)
        if self.ell is not None:
            cols = host(self.ell.cols)
            r = np.repeat(np.arange(dim), cols.shape[1])
            np.add.at(m, (r, cols.reshape(-1)), host(self.ell.vals).reshape(-1))
        if self.factorized is not None:
            szd, szu = self.spin_shape
            f = self.factorized
            if f.up_cols is not None:
                a = host(_dense_from_ell(f.up_cols, f.up_vals)).astype(m.dtype)
                m += np.kron(np.eye(szd, dtype=m.dtype), a)
            if f.dn_cols is not None:
                a = host(_dense_from_ell(f.dn_cols, f.dn_vals)).astype(m.dtype)
                m += np.kron(a, np.eye(szu, dtype=m.dtype))
        return m


def hamiltonian_from_numpy(diag, ell_cols, ell_vals, up_cols, up_vals,
                           dn_cols, dn_vals, spin_shape, device,
                           dtype: torch.dtype) -> Hamiltonian:
    """A ``Hamiltonian`` on `device` from host arrays in the JAX package's
    layout (``np.asarray`` of its ``Hamiltonian`` fields).  Any of the ELL
    or one-spin pairs may be None; indices become int32, values `dtype`.
    The generic ELL pair keeps its (dim, K) shape but is laid out K-major
    on every device: the host array is transposed once, before the
    transfer, and only that layout is kept."""
    device = torch.device(device)

    def idx(a):
        return None if a is None else torch.tensor(
            np.asarray(a, dtype=np.int32), device=device)

    def val(a):
        return None if a is None else torch.tensor(
            np.asarray(a), device=device).to(dtype)

    def k_major(a):
        return np.ascontiguousarray(np.asarray(a).T)

    ell = None
    if ell_cols is not None:
        ell = EllPart(cols=idx(k_major(ell_cols)).T,
                      vals=val(k_major(ell_vals)).T)
    fact = None
    if up_cols is not None or dn_cols is not None:
        fact = SpinFactorizedPart(up_cols=idx(up_cols), up_vals=val(up_vals),
                                  dn_cols=idx(dn_cols), dn_vals=val(dn_vals))
    return Hamiltonian(diag=val(diag), ell=ell, factorized=fact,
                       spin_shape=None if spin_shape is None
                       else tuple(int(s) for s in spin_shape))
