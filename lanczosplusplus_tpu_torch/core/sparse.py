"""Sector Hamiltonians as tensors: diagonal, generic ELL, Kronecker factors.

Counterpart of ``lanczosplusplus_tpu/core/sparse.py``, the parts on the
ground-state and spectral paths: ``coo_to_ell``, ``one_spin_ell``,
``EllPart``, ``SpinFactorizedPart`` in its gather and dense forms,
``Hamiltonian`` with ``matvec``, the batched ``matmat_t`` and ``matmat``,
``densify_factors``, ``flatten_to_ell``, ``padded`` and ``to_dense``, and
``flatten_to_ell_host``, ``apply_block_t`` (and ``apply_vec``, its
one-state form, for the solvers) and ``ell_spgemm``.  The
reference stores each sector Hamiltonian as a CRS matrix (reference:
src/Engine/DefaultSymmetry.h:54-57, src/Models/HubbardOneOrbital/
HubbardHelper.h:75-103).

Layout.  ED Hamiltonians have bounded row sparsity, so the generic part
is ELL: padded (dim, K) ``cols``/``vals`` with padding pointing at its
own row with value 0 (the kernel reads a sliced form of it without the
padding, ``EllPart.sliced``).  Terms acting on one spin species are Kronecker
products I (x) A_up and A_dn (x) I, applied to the state viewed as the
(size_down, size_up) matrix X: either as gathers of the one-spin ELL
maps, or, after ``densify_factors``, as two GEMMs Y += X . A_up^T and
Y += A_dn . X through the hand-written ``factor_matmul`` kernel.  A real
sector's gathers go through the hand-written ``spin_hop`` kernel, both
maps compacted to their nonzero entries and the diagonal with them where
there is no ELL part, in one launch; a complex one's through
``perm_gather``.  On the card ``densify_factors`` keeps a real factor in
``spin_hop``'s form and makes a complex one dense where it fits; the CPU
keeps the gather form.  A sector may mix the two.  The diagonal plus
the generic ELL part go through the ``ell_spmv`` kernel.  A batch of
states is a batch-major (R, dim) block, viewed as (R, size_down,
size_up): the up GEMM folds (R, size_down) into its rows, the dn GEMM,
``spin_hop`` and the ELL kernel take the batch in one launch each
(``matmat_t``).

Every form runs in float64, float32, complex128 or complex64.  Dense
factors may be stored in bfloat16 below a real state's type
(``densify_factors(factor_dtype=torch.bfloat16)``): the state is then
rounded to bfloat16 before the GEMMs, which sum in float32 into the
state's type (JAX ``_downcast_state``), and the form is ``quantized``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lanczosplusplus_tpu_torch import native
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis
from lanczosplusplus_tpu_torch.core.combinatorics import binomial_table
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.utils.progress import count, span

DEFAULT_DENSE_FACTOR_BYTES = 2 << 30
# one-spin hop maps at least this long build natively (the JAX package's
# threshold)
NATIVE_MIN_WORDS = 1 << 16


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
    the row's own column and value 0.  `dtype` is a numpy dtype.  At
    ``NATIVE_MIN_WORDS`` words or more, real bonds over a ``OneSpinBasis``
    go through the native host runtime where it builds, as in the JAX
    package.
    """
    from lanczosplusplus_tpu_torch.core import bits

    sz = words.shape[0]
    nb = max(len(bonds), 1)
    # the native path ranks by the colex combinadic itself, so it applies
    # only when rank_fn is a plain combination basis's rank
    if (sz >= NATIVE_MIN_WORDS and bonds
            and isinstance(getattr(rank_fn, "__self__", None), OneSpinBasis)
            and not np.iscomplexobj(np.zeros(0, dtype))):
        out = native.one_spin_hop_ell(words, bonds, binomial_table(64 + 1))
        if out is not None:
            return out[0], out[1].astype(dtype)
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
    """Generic ELL block: y[i] += sum_k vals[i, k] * x[cols[i, k]].  The
    padded (cols, vals) are what the model code and host consumers read;
    the ``ell_spmv`` kernel reads the block's sliced form, made once, at
    the first apply on the card (``sliced``)."""
    cols: torch.Tensor  # (dim, K) int32, contiguous
    vals: torch.Tensor  # (dim, K), contiguous
    _sliced: kernels.SlicedEll | None = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    def sliced(self) -> kernels.SlicedEll:
        """The sliced form of (cols, vals) (``kernels.slice_ell``), made at
        the first call and kept; each making counts in
        ``kernels.SLICINGS["ell_spmv"]``."""
        if self._sliced is None:
            object.__setattr__(self, "_sliced",
                               kernels.slice_ell(self.cols, self.vals))
            kernels.SLICINGS["ell_spmv"] = (
                kernels.SLICINGS.get("ell_spmv", 0) + 1)
        return self._sliced


def _dense_from_ell(cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(size, size) matrix of a one-spin ELL map (duplicates summed).  A
    complex map whose imaginary part is zero throughout (the hop factors
    of a real model solved with useComplex) comes back real, so that
    ``factor_matmul`` runs one product over the state's two planes."""
    if vals.is_complex():
        a_re = _dense_from_ell(cols, vals.real)
        if not bool(vals.imag.any()):
            return a_re
        return torch.complex(a_re, _dense_from_ell(cols, vals.imag))
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
    the ELL maps `*_cols`/`*_vals`; a real map is applied through
    ``spin_hop`` from its nonzero entries (``kernels.compact_hops``), a
    complex one through ``perm_gather`` from its (K, size) transposes.
    Either table set is made once, on the maps' device, when the part is
    built, for a factor with no dense form only.  Dense form:
    `up_dense`/`dn_dense`, the (size, size) one-spin matrices, applied
    through ``factor_matmul``.
    """
    up_cols: torch.Tensor | None  # (size_up, Ku) int32
    up_vals: torch.Tensor | None
    dn_cols: torch.Tensor | None  # (size_down, Kd) int32
    dn_vals: torch.Tensor | None
    up_dense: torch.Tensor | None = None  # (size_up, size_up)
    dn_dense: torch.Tensor | None = None  # (size_down, size_down)
    # spin_hop's tables (kernels.HopTables), for a real factor in gather
    # form
    up_hop: kernels.HopTables | None = dataclasses.field(init=False,
                                                         default=None)
    dn_hop: kernels.HopTables | None = dataclasses.field(init=False,
                                                         default=None)
    # (cols^T, vals^T), each (K, size) contiguous: perm_gather's tables,
    # for a complex factor in gather form
    up_gather: tuple | None = dataclasses.field(init=False, default=None)
    dn_gather: tuple | None = dataclasses.field(init=False, default=None)
    # set once ``densify_factors`` has counted this part's hop tables in
    # ``build.hop_form``, so that a second call counts nothing
    hops_counted: bool = dataclasses.field(init=False, default=False)

    def __post_init__(self):
        for side in ("up", "dn"):
            cols = getattr(self, f"{side}_cols")
            if cols is None or getattr(self, f"{side}_dense") is not None:
                continue
            vals = getattr(self, f"{side}_vals")
            if vals.is_complex():
                object.__setattr__(self, f"{side}_gather", (
                    cols.T.contiguous(), vals.T.contiguous()))
            else:
                object.__setattr__(self, f"{side}_hop",
                                   kernels.compact_hops(cols, vals))

    @property
    def takes_diagonal(self) -> bool:
        """Whether the first map applied is in ``spin_hop``'s form, so that
        its launch can write the diagonal's product too (``apply_``)."""
        return self.up_hop is not None or (
            self.up_cols is None and self.dn_hop is not None)

    def apply_(self, x: torch.Tensor, y: torch.Tensor,
               diag: torch.Tensor | None = None) -> None:
        """y += (I (x) A_up + A_dn (x) I) x, in place on y, for one state
        viewed as (size_down, size_up) or a block of them viewed as
        (R, size_down, size_up); with `diag` (only where
        ``takes_diagonal``) y is written, diag * x plus the same.  Each
        factor takes one launch over the whole block: a dense up factor
        with (R, size_down) folded into the GEMM's rows, a dense dn factor
        batched over transposed views; a real factor in gather form
        ``spin_hop``, one launch for both where both are, the diagonal in
        it; a complex one one ``perm_gather``, up with the rows the
        identity and the columns gathered, dn the other way round.  The
        up factor goes first.  A bfloat16 dense factor meets the state
        rounded to bfloat16 once."""
        xq = x
        if any(d is not None and d.dtype == torch.bfloat16
               for d in (self.up_dense, self.dn_dense)):
            xq = x.to(torch.bfloat16)
        dn_done = False
        if self.up_dense is not None:
            # y[b, d, u] += sum_c x[b, d, c] A_up[u, c]
            szu = x.shape[-1]
            xu = xq if self.up_dense.dtype == torch.bfloat16 else x
            kernels.factor_matmul(xu.reshape(-1, szu), self.up_dense,
                                  out=y.view(-1, szu), accumulate=True)
        elif self.up_hop is not None:
            # y[b, d, u] (+)= sum_k vu[k, u] x[b, d, cu[k, u]], and the dn
            # sum with it where the dn map is in the same form
            kernels.spin_hop(x, y, diag=diag, up=self.up_hop, dn=self.dn_hop)
            dn_done = self.dn_hop is not None
        elif self.up_gather is not None:
            # y[b, d, u] += sum_k vals[u, k] x[b, d, cols[u, k]]
            cs, beta = self.up_gather
            kernels.perm_gather(x, y, cs=cs, beta=beta)
        if self.dn_dense is not None:
            # y[b, d, u] += sum_c A_dn[d, c] x[b, c, u], as
            # y[b]^T += x[b]^T . A_dn^T on transposed views
            xd = xq if self.dn_dense.dtype == torch.bfloat16 else x
            kernels.factor_matmul(xd.transpose(-1, -2), self.dn_dense,
                                  out=y.transpose(-1, -2), accumulate=True)
        elif self.dn_hop is not None and not dn_done:
            # y[b, d, u] (+)= sum_k vd[k, d] x[b, cd[k, d], u]
            kernels.spin_hop(x, y, diag=diag if self.up_cols is None
                             else None, dn=self.dn_hop)
        elif self.dn_gather is not None:
            # y[b, d, u] += sum_k vals[d, k] x[b, cols[d, k], u]
            rs, a = self.dn_gather
            kernels.perm_gather(x, y, rs=rs, a=a)


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

    @property
    def quantized(self) -> bool:
        """Whether a dense factor is stored below the state's type
        (bfloat16), so that the matvec rounds the state: the solver then
        reorthogonalizes fully and refines the energies with the factors'
        gather maps in float64."""
        f = self.factorized
        return f is not None and any(
            d is not None and d.dtype == torch.bfloat16
            for d in (f.up_dense, f.dn_dense))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """H x for one contiguous (dim,) state."""
        return self.matmat_t(x)

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """Batch-major SpMM: H applied to every row of the contiguous
        block xk (R, dim) (or to one (dim,) state).  The diagonal and the
        generic ELL part are one batched ``ell_spmv`` launch (on the card
        from the part's sliced form), in a ``hamiltonian.ell`` span; each
        dense one-spin factor one ``factor_matmul`` launch over the whole
        block and the real maps in gather form one ``spin_hop`` launch, in
        a ``hamiltonian.factors`` span.  Without an ELL part the diagonal
        goes into ``spin_hop``'s launch where the part takes it
        (``SpinFactorizedPart.takes_diagonal``), else it is one
        elementwise pass in the ``hamiltonian.ell`` span.  Batched
        recurrences keep their states in this layout."""
        f = self.factorized
        fused = self.ell is None and f is not None and f.takes_diagonal
        if fused:
            y = torch.empty_like(xk)
        else:
            with span("hamiltonian.ell"):
                if self.ell is not None:
                    sliced = self.ell.sliced() if xk.is_cuda else None
                    y = kernels.ell_spmv(self.diag, self.ell.cols,
                                         self.ell.vals, xk, sliced=sliced)
                else:
                    y = self.diag * xk
        if f is not None:
            shape = (*xk.shape[:-1], *self.spin_shape)
            with span("hamiltonian.factors"):
                f.apply_(xk.view(shape), y.view(shape),
                         diag=self.diag if fused else None)
        return y

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """H applied to the columns of x (dim, k): ``matmat_t`` on a
        batch-major copy, seen transposed again."""
        return self.matmat_t(x.T.contiguous()).T

    def densify_factors(self, max_bytes: int | None = None,
                        factor_dtype: torch.dtype | None = None
                        ) -> "Hamiltonian":
        """Materialize the Kronecker one-spin factors as dense matrices
        when each fits in `max_bytes`, so matvec runs as GEMMs.  By
        default a factor may take a quarter of the card's free memory
        (``torch.cuda.mem_get_info``), or 2 GiB on the CPU, except that on
        the card a real factor stays in gather form: ``spin_hop`` over its
        nonzero entries is faster than the GEMM at every factor size the
        models build (PERF.md §6).  A factor not densified stays in
        gather form, applied through ``spin_hop`` (real) or
        ``perm_gather`` (complex), so a sector may mix the two forms;
        ``max_bytes=0`` keeps both in gather form, and an explicit
        `max_bytes` alone decides.  Each real factor left in gather form
        counts one in ``build.hop_form``, once a part.  The ELL maps are
        kept alongside, so ``to_dense`` keeps working.  A Hamiltonian that
        is densified already comes back as it is.

        `factor_dtype` torch.bfloat16 stores the dense factors in bf16
        below a real state's type (JAX ``densify_factors(factor_dtype=)``),
        within the budget alone: their GEMMs take ``factor_matmul``'s bf16
        form, and the state is rounded to bf16 for them
        (``quantized``)."""
        f = self.factorized
        if f is None or f.up_dense is not None or f.dn_dense is not None:
            return self
        if factor_dtype not in (None, torch.bfloat16, self.dtype):
            raise ValueError(f"densify_factors: factor_dtype must be None, "
                             f"torch.bfloat16 or {self.dtype}, not "
                             f"{factor_dtype}")
        if factor_dtype == torch.bfloat16 and self.dtype.is_complex:
            raise ValueError("densify_factors: bfloat16 factors take a real "
                             f"state, not {self.dtype}")
        on_cuda = self.device.type == "cuda"
        # the card keeps a real factor in spin_hop's form, where no budget
        # or bf16 store was asked for
        keep_hops = (on_cuda and max_bytes is None
                     and factor_dtype != torch.bfloat16)
        if max_bytes is None:
            max_bytes = (torch.cuda.mem_get_info(self.device)[0] // 4
                         if on_cuda else DEFAULT_DENSE_FACTOR_BYTES)

        def densify(cols, vals, hop):
            if cols is None:
                return None
            size = cols.shape[0]
            if size * size * vals.element_size() > max_bytes:
                return None
            if keep_hops and hop is not None:
                return None
            dense = _dense_from_ell(cols, vals)
            return dense if factor_dtype is None else dense.to(factor_dtype)

        up_d = densify(f.up_cols, f.up_vals, f.up_hop)
        dn_d = densify(f.dn_cols, f.dn_vals, f.dn_hop)
        if up_d is None and dn_d is None:
            if not f.hops_counted:
                count("build.hop_form",
                      (f.up_hop is not None) + (f.dn_hop is not None))
                object.__setattr__(f, "hops_counted", True)
            return self
        count("build.hop_form", (up_d is None and f.up_hop is not None)
              + (dn_d is None and f.dn_hop is not None))
        return dataclasses.replace(
            self, factorized=dataclasses.replace(f, up_dense=up_d,
                                                 dn_dense=dn_d))

    def flatten_to_ell(self) -> "Hamiltonian":
        """Merge the Kronecker one-spin parts into the generic ELL block
        (one (cols, vals) layout for consumers that want a single one);
        the Kronecker indices expand by broadcasting."""
        f = self.factorized
        if f is None:
            return self
        szd, szu = self.spin_shape
        dim = szd * szu
        blocks_c, blocks_v = [], []
        if f.up_cols is not None:
            ku = f.up_cols.shape[1]
            base = (torch.arange(szd, dtype=torch.int32, device=self.device)
                    * szu)[:, None, None]
            blocks_c.append((f.up_cols[None] + base).reshape(dim, ku))
            blocks_v.append(f.up_vals[None].expand(szd, szu, ku)
                            .reshape(dim, ku))
        if f.dn_cols is not None:
            kd = f.dn_cols.shape[1]
            iu = torch.arange(szu, dtype=torch.int32,
                              device=self.device)[None, :, None]
            blocks_c.append((f.dn_cols[:, None, :] * szu + iu)
                            .reshape(dim, kd))
            blocks_v.append(f.dn_vals[:, None, :].expand(szd, szu, kd)
                            .reshape(dim, kd))
        if self.ell is not None:
            blocks_c.append(self.ell.cols)
            blocks_v.append(self.ell.vals)
        ell = EllPart(cols=torch.cat(blocks_c, dim=1).to(torch.int32),
                      vals=torch.cat(blocks_v, dim=1))
        return Hamiltonian(diag=self.diag, ell=ell, factorized=None,
                           spin_shape=None)

    def padded(self, multiple: int) -> "Hamiltonian":
        """Rows padded to a multiple (for even partitions), in flattened
        ELL form; padding rows are zero with their own column."""
        h = self.flatten_to_ell()
        dim = h.dim
        rem = (-dim) % multiple
        if rem == 0:
            return h
        k = h.ell.cols.shape[1]
        pad_cols = torch.arange(dim, dim + rem, dtype=torch.int32,
                                device=self.device)[:, None].expand(rem, k)
        cols = torch.cat([h.ell.cols, pad_cols], dim=0)
        vals = torch.cat([h.ell.vals, h.ell.vals.new_zeros((rem, k))], dim=0)
        diag = torch.cat([h.diag, h.diag.new_zeros((rem,))])
        return Hamiltonian(diag=diag, ell=EllPart(cols=cols, vals=vals),
                           factorized=None, spin_shape=None)

    def to_dense(self) -> np.ndarray:
        """Dense matrix for oracle tests (reference dumpmatrix path,
        src/Engine/DefaultSymmetry.h:61-94)."""
        def host(t):
            return t.detach().cpu().numpy()

        dim = self.dim
        m = np.zeros((dim, dim), dtype=np.result_type(
            host(self.diag).dtype, numpy_dtype(self.dtype)))
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


def flatten_to_ell_host(ham: Hamiltonian, multiple: int = 1):
    """Padded ELL flatten as host arrays (diag, cols, vals), rows padded
    to `multiple` with zero rows pointing at themselves: the layout of
    ``Hamiltonian.padded(multiple)``, built with numpy broadcasts for
    consumers that plan on the host."""
    def host(t):
        return t.detach().cpu().numpy()

    dim = ham.dim
    blocks_c, blocks_v = [], []
    if ham.factorized is not None:
        szd, szu = ham.spin_shape
        f = ham.factorized
        if f.up_cols is not None:
            cu = host(f.up_cols).astype(np.int64)
            vu = host(f.up_vals)
            ku = cu.shape[1]
            base = (np.arange(szd, dtype=np.int64) * szu)[:, None, None]
            blocks_c.append(np.ascontiguousarray(
                np.broadcast_to(cu[None], (szd, szu, ku)) + base
            ).reshape(dim, ku))
            blocks_v.append(np.ascontiguousarray(np.broadcast_to(
                vu[None], (szd, szu, ku))).reshape(dim, ku))
        if f.dn_cols is not None:
            cd = host(f.dn_cols).astype(np.int64)
            vd = host(f.dn_vals)
            kd = cd.shape[1]
            iu = np.arange(szu, dtype=np.int64)[None, :, None]
            blocks_c.append(np.ascontiguousarray(
                cd[:, None, :] * szu + iu).reshape(dim, kd))
            blocks_v.append(np.ascontiguousarray(np.broadcast_to(
                vd[:, None, :], (szd, szu, kd))).reshape(dim, kd))
    if ham.ell is not None:
        blocks_c.append(host(ham.ell.cols).astype(np.int64))
        blocks_v.append(host(ham.ell.vals))
    cols = np.concatenate(blocks_c, axis=1)
    vals = np.concatenate(blocks_v, axis=1)
    diag = host(ham.diag)
    rem = (-dim) % multiple
    if rem:
        k = cols.shape[1]
        pad_cols = np.broadcast_to(
            np.arange(dim, dim + rem, dtype=np.int64)[:, None], (rem, k))
        cols = np.concatenate([cols, pad_cols], axis=0)
        vals = np.concatenate(
            [vals, np.zeros((rem, k), vals.dtype)], axis=0)
        diag = np.concatenate([diag, np.zeros((rem,), diag.dtype)])
    return diag, cols.astype(np.int32), vals


def apply_vec(ham, x: torch.Tensor) -> torch.Tensor:
    """H x for one (dim,) state, at the solver-to-apply boundary: a
    ``hamiltonian.apply`` span, one row counted in ``hamiltonian.rows``."""
    with span("hamiltonian.apply"):
        count("hamiltonian.rows")
        return ham.matvec(x)


def apply_block_t(ham, xk: torch.Tensor) -> torch.Tensor:
    """Apply a Hamiltonian-like object to a batch-major (R, dim) block:
    its ``matmat_t`` when it has one, else its ``matvec`` row by row.  A
    ``hamiltonian.apply`` span; the block's rows (1 for a (dim,) state)
    are counted in ``hamiltonian.rows``."""
    with span("hamiltonian.apply"):
        count("hamiltonian.rows", xk.shape[0] if xk.dim() == 2 else 1)
        if hasattr(ham, "matmat_t"):
            return ham.matmat_t(xk)
        return torch.stack([ham.matvec(row) for row in xk])


def ell_spgemm(a_cols: torch.Tensor, a_vals: torch.Tensor,
               b_cols: torch.Tensor, b_vals: torch.Tensor):
    """SpGEMM of bounded-row ELL operands, C = A @ B, as an ELL with
    duplicates of width Ka * Kb: two gathers and one elementwise product
    (duplicates are legal in this layout: every consumer sums over K)."""
    n, ka = a_cols.shape
    kb = b_cols.shape[1]
    mid = a_cols.long()                                  # (n, Ka)
    c_cols = b_cols[mid].reshape(n, ka * kb)             # rows of B
    c_vals = (a_vals[:, :, None] * b_vals[mid]).reshape(n, ka * kb)
    return c_cols, c_vals


def hamiltonian_from_numpy(diag, ell_cols, ell_vals, up_cols, up_vals,
                           dn_cols, dn_vals, spin_shape, device,
                           dtype: torch.dtype) -> Hamiltonian:
    """A ``Hamiltonian`` on `device` from host arrays in the JAX package's
    layout (``np.asarray`` of its ``Hamiltonian`` fields).  Any of the ELL
    or one-spin pairs may be None; indices become int32, values `dtype`,
    every tensor contiguous."""
    device = torch.device(device)

    def idx(a):
        return None if a is None else torch.tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device)

    def val(a):
        return None if a is None else torch.tensor(
            np.ascontiguousarray(a), device=device).to(dtype)

    ell = None
    if ell_cols is not None:
        ell = EllPart(cols=idx(ell_cols), vals=val(ell_vals))
    fact = None
    if up_cols is not None or dn_cols is not None:
        fact = SpinFactorizedPart(up_cols=idx(up_cols), up_vals=val(up_vals),
                                  dn_cols=idx(dn_cols), dn_vals=val(dn_vals))
    return Hamiltonian(diag=val(diag), ell=ell, factorized=fact,
                       spin_shape=None if spin_shape is None
                       else tuple(int(s) for s in spin_shape))
