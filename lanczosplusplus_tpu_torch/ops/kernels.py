"""The hot-path kernels, their plain PyTorch versions and the dispatch.

Counterpart of ``lanczosplusplus_tpu/ops/pallas_kernels.py``.  Four
kernels, each written by hand in CUDA C++ for Hopper (``csrc/``):

- ``factor_matmul``: ``Y[b] (+)= X[b] . A[b]^T`` on strided operands, A
  shared or one per batch member: the dense Kronecker hop factors of every
  Lanczos matvec and, with a batch of states, of every batched step, and
  every product of the block-Kronecker forms, on the FP64 tensor cores in
  float64, on the FP32 units on the same ``cp.async`` ring in float32, and
  in the TPU kernel's bf16 form (bfloat16 operands, float32 sums) on
  ``wgmma`` fed by TMA (``csrc/factor_matmul.cu``);
- ``ell_spmv``: ``y[b] = diag * x[b] + sum_k vals[:, k] * x[b, cols[:, k]]``
  over a padded ELL matrix and one vector or a batch-major block of them,
  real or complex, read on the card from the matrix's sliced form
  (``slice_ell``: the padding dropped, rows in slices of 32, one warp
  each; ``csrc/ell_spmv.cu``);
- ``perm_gather``: ``Y[b, r, c] += sum_n a[n, r] beta[n, c]
  X[b, rs[n, r], cs[n, c]]``, the partial permutations of the
  block-Kronecker forms and the one-spin hop maps in gather form, real or
  complex, and from a bfloat16 source block (bf16cross)
  (``csrc/perm_gather.cu``; it has no TPU counterpart: the JAX package
  runs these gathers outside Pallas);
- ``spin_hop``: ``y[b, d, u] = diag * x[b, d, u] + sum_k vu[k, u]
  x[b, d, cu[k, u]] + sum_k vd[k, d] x[b, cd[k, d], u]`` (or the same
  sums added into y), a Hubbard-family sector's two one-spin hop maps in
  gather form, compacted to their nonzero entries (``compact_hops``), and
  its diagonal, in one pass over a real block (``csrc/spin_hop.cu``; no
  TPU counterpart: the JAX package runs these maps as dense GEMMs).

Each takes the batch in one launch; a single matrix or vector is the case
batch = 1 of the same kernel.  A complex state goes through
``factor_matmul`` as its real and imaginary planes, a batch of two for the
real kernel.

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain version (``*_ref``), a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.  Each wrapper adds
one to ``FORM_LAUNCHES["<name> <form>"]`` where it launches its kernel,
the form being the launcher's type suffix (``f64``, ``f32``, ``c128``,
``c64``, ``bf16_f32``, ...), so a run can show that its main path went
through the kernels; ``LAUNCHES[name]`` reads the sum over a kernel's
forms.  ``REPACKS["factor_matmul bf16"]`` counts the bf16 operands the
wrapper copied into a padded layout TMA can address before a launch (no
path's operand needs one), ``SLICINGS["ell_spmv"]`` the sliced forms the
path made (``core/sparse.EllPart.sliced``: once per ELL on the card).
``uncounted()`` leaves a block's launches out of all three.
"""

from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping
from typing import NamedTuple

import torch

FORM_LAUNCHES: dict[str, int] = {}
REPACKS: dict[str, int] = {}
SLICINGS: dict[str, int] = {}


class _KernelLaunches(Mapping):
    """Launches by kernel, read from ``FORM_LAUNCHES``: the sum over the
    kernel's forms."""

    _NAMES = ("factor_matmul", "ell_spmv", "perm_gather", "spin_hop")

    def __getitem__(self, name: str) -> int:
        if name not in self._NAMES:
            raise KeyError(name)
        return sum(n for key, n in FORM_LAUNCHES.items()
                   if key.split(" ", 1)[0] == name)

    def __iter__(self):
        return iter(self._NAMES)

    def __len__(self) -> int:
        return len(self._NAMES)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = _KernelLaunches()

_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.complex128: "c128", torch.complex64: "c64"}
_INT_MAX = 2**31 - 1
H100_SMS = 132
BIG_TILE, SMALL_TILE = 128, 64
# the bf16 kernel's tile rows, its stage's k and one TMA box of 64 rows by
# 64 k in bytes (csrc/factor_matmul.cu GBM, GBK, GBOX); its tiles are 256
# columns wide
WGMMA_TILE_M, WGMMA_STAGE_K, WGMMA_BOX = 128, 64, 64 * 64 * 2
# the sliced ELL: rows a slice, one warp with a lane a row
# (csrc/ell_spmv.cu C), and the window of rows within which rows are
# sorted by their count of entries
SLICE_ROWS, SLICE_WINDOW = 32, 256
# padded entries a step of slice_ell's scatter takes at most
_SLICE_CHUNK = 1 << 24
# spin_hop: the staged rows of x a block holds at most, so that two blocks
# fit an SM's 228 KB beside their rows' dn entries, and the rows a block
# owns at most (csrc/spin_hop.cu)
SPIN_HOP_STAGE_BYTES, SPIN_HOP_MAX_GROUP = 108 * 1024, 2


def reset_launches() -> None:
    FORM_LAUNCHES.clear()
    REPACKS.clear()
    SLICINGS.clear()


@contextlib.contextmanager
def uncounted():
    """Within this block launches, repacks and slicings go uncounted: the
    counts are as they were before it once it ends.  For the single-device
    references a run holds its path against, so that the counts read after
    the run are the path's alone."""
    saved = [(d, dict(d)) for d in (FORM_LAUNCHES, REPACKS, SLICINGS)]
    try:
        yield
    finally:
        for d, before in saved:
            d.clear()
            d.update(before)


def _launched(name: str, form: str) -> None:
    key = f"{name} {form}"
    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1


def factor_matmul_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of ``factor_matmul``: ``x @ a^T``, for one (m, k)
    matrix or a (batch, m, k) block against the shared factor or a
    (batch, n, k) stack of them; a complex state may meet a real
    factor.  bfloat16 operands are widened to float32 (exactly) and their
    product summed in float32, as the kernel's bf16 form does."""
    if x.dtype == torch.bfloat16:
        return x.float() @ a.transpose(-1, -2).float()
    return x @ a.transpose(-1, -2).to(x.dtype)


def ell_spmv_ref(diag: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor, src: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Plain version of ``ell_spmv``, for one (dim,) vector or a
    batch-major (batch, dim) block, the gathers from `src` where one is
    given (x otherwise)."""
    return diag * x + (vals * (x if src is None else src)[..., cols]).sum(-1)


class SlicedEll(NamedTuple):
    """The sliced form (SELL-C-sigma, C = ``SLICE_ROWS``) of a padded
    (dim, K) ELL matrix, which the ``ell_spmv`` kernel reads
    (``slice_ell``).  Sorted position p = C s + i is lane i of slice s and
    holds row ``perm[p]``; entry j of that row lies at slot
    ``offsets[s] + C j + i`` of `cols` and `vals`, for j below the row's
    count of entries; the slice's other slots, up to its width, are
    padding: the row's own index, value 0."""
    cols: torch.Tensor     # (slots,) int32
    vals: torch.Tensor     # (slots,)
    offsets: torch.Tensor  # (slices,) int64: a slice's first slot
    widths: torch.Tensor   # (slices,) int32: its slots a lane
    perm: torch.Tensor     # (dim,) int32: the row at each sorted position
    width: int             # the widest slice's width
    # the narrowest width of slices that hold 9 in 10 of the slots: the
    # kernel keeps a row of a slice no wider than its unroll in registers
    # across a batch, and takes the smallest unroll (4, 8, 16) that does
    # so for these
    typical_width: int
    nnz: int               # the entries kept: the matrix's nonzeros

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.vals, self.offsets, self.widths, self.perm))


def slice_ell(cols: torch.Tensor, vals: torch.Tensor) -> SlicedEll:
    """The sliced form of the padded ELL (cols, vals) on their device.
    Every entry whose value is exactly 0 is dropped (the padding, which
    adds nothing to a sum); each row keeps the others in their k order
    (a flattened ELL's padding may sit between two parts' entries).  Rows
    are sorted, stably, by their count of entries, the longest first,
    within windows of ``SLICE_WINDOW`` rows, and cut into slices of
    ``SLICE_ROWS``, each as wide as its longest row and stored
    column-major (``SlicedEll``).  The columns index whatever the kernel
    gathers from: x, or a longer source (``ell_spmv(..., src=)``), so a
    row shard's entries may point past its own rows."""
    dim, k = cols.shape
    dev = cols.device
    c = SLICE_ROWS
    counts = (vals != 0).sum(1)
    window = torch.arange(dim, device=dev) // SLICE_WINDOW
    order = torch.argsort(window * (k + 1) + (k - counts), stable=True)
    slices = -(-dim // c)
    lane_counts = counts.new_zeros(slices * c)
    lane_counts[:dim] = counts[order]
    widths = lane_counts.view(slices, c).amax(1)
    sizes = widths * c
    offsets = torch.cumsum(sizes, 0) - sizes
    lane_rows = torch.zeros(slices * c, dtype=torch.int32, device=dev)
    lane_rows[:dim] = order.to(torch.int32)
    s_cols = lane_rows.view(slices, c).repeat_interleave(widths, 0).view(-1)
    s_vals = vals.new_zeros(s_cols.shape)
    # the slot of each row's first entry
    position = torch.empty_like(order)
    position[order] = torch.arange(dim, device=dev)
    first_slot = offsets[position // c] + position % c
    step = max(1, _SLICE_CHUNK // max(k, 1))
    for a in range(0, dim, step):
        part = vals[a:a + step]
        r, j = (part != 0).nonzero(as_tuple=True)
        n = counts[a:a + step]
        q = torch.arange(r.numel(), device=dev) - (torch.cumsum(n, 0) - n)[r]
        slot = first_slot[a + r] + c * q
        s_cols[slot] = cols[a:a + step][r, j]
        s_vals[slot] = part[r, j]
    return SlicedEll(s_cols, s_vals, offsets, widths.to(torch.int32),
                     order.to(torch.int32),
                     int(widths.max()) if slices else 0,
                     _typical_width(widths), int(counts.sum()))


def _typical_width(widths: torch.Tensor) -> int:
    """The narrowest w such that slices no wider than w hold at least 9
    in 10 of the slots (0 for no slots)."""
    w, n = torch.unique(widths, return_counts=True)
    slots = torch.cumsum(w * n, 0)
    if slots.numel() == 0 or int(slots[-1]) == 0:
        return 0
    return int(w[torch.searchsorted(slots, 0.9 * slots[-1])])


def ell_spmv_sliced_ref(diag: torch.Tensor, sliced: SlicedEll,
                        x: torch.Tensor, src: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain version of ``ell_spmv`` on the sliced form, for one (dim,)
    vector or a batch-major (batch, dim) block: each slot's product, its
    gather from `src` where one is given (x otherwise), summed into its
    lane's row in slot order, the diagonal term added."""
    c = SLICE_ROWS
    slices = sliced.widths.numel()
    lane = torch.arange(slices * c, device=x.device).view(slices, c)
    lane = lane.repeat_interleave(sliced.widths.long(), 0).view(-1)
    acc = x.new_zeros((*x.shape[:-1], slices * c))
    gathered = (x if src is None else src)[..., sliced.cols.long()]
    acc.index_add_(-1, lane, sliced.vals * gathered)
    y = diag * x
    rows = sliced.perm.long()
    y[..., rows] = y[..., rows] + acc[..., :diag.shape[0]]
    return y


def _check_cuda_operands(name: str, *tensors: torch.Tensor,
                         dtypes=tuple(_SUFFIX)) -> None:
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operands of {t.dtype} and {dt}")
    if dt not in dtypes:
        raise TypeError(f"{name}: the CUDA kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}, not {dt}")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two tensors intersect."""
    def span(t):
        lo = t.data_ptr()
        hi = lo + t.element_size() * (1 + sum(
            (s - 1) * st for s, st in zip(t.shape, t.stride())))
        return lo, hi
    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _sm_count(device_index: int | None) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


class MatmulPlan(NamedTuple):
    """How the float64 or float32 ``factor_matmul`` kernel runs one
    product."""
    x_kmajor: bool  # X staged [row][k] (else [k][row])
    x_vec16: bool   # X copied 16 bytes at a time (else an element)
    a_kmajor: bool
    a_vec16: bool
    y_vec16: bool   # Y read and written 16 bytes at a time
    tile: int       # 128: the large tile, 64: the small one

    @property
    def bits(self) -> int:
        """The bit set ``csrc/factor_matmul.cu`` reads (PLAN_*)."""
        return (self.x_kmajor | self.x_vec16 << 1 | self.a_kmajor << 2
                | self.a_vec16 << 3 | self.y_vec16 << 4
                | (self.tile == BIG_TILE) << 5)


def _staging(ptr: int, row_stride: int, k_stride: int,
             batch_stride: int = 0, elem_size: int = 8) -> tuple[bool, bool]:
    """(k-major, 16-byte copies) for an (rows, k) operand of `elem_size`
    bytes at byte address `ptr` with strides in elements.  The operand is
    staged along its contiguous axis; 16-byte copies need that axis at
    stride 1, a pitch on the other and, under a batch, a batch stride that
    are multiples of 16 bytes, and a 16-byte aligned base.  With no
    contiguous axis the nearer one is walked, one element at a time."""
    vec = 16 // elem_size
    aligned = ptr % 16 == 0 and batch_stride % vec == 0
    if k_stride == 1:
        return True, aligned and row_stride % vec == 0
    if row_stride == 1:
        return False, aligned and k_stride % vec == 0
    return k_stride <= row_stride, False


def factor_matmul_plan(x_ptr: int, x_strides: tuple[int, ...],
                       a_ptr: int, a_strides: tuple[int, ...],
                       y_ptr: int, y_strides: tuple[int, ...],
                       m: int, n: int, sm_count: int = H100_SMS,
                       batch: int = 1, elem_size: int = 8) -> MatmulPlan:
    """The float64 (`elem_size` 8) or float32 (4) kernel's path for one
    product, from pointers (byte addresses), strides (in elements) and
    shape alone.  `x_strides`, `a_strides` and `y_strides` are (row, k)
    pairs, or (batch, row, k) triples for a batched product (a batch
    stride of 0 shares the operand).  Both kernels stage through the same
    ``cp.async`` ring: 16-byte copies take a pitch that is a multiple of
    2 doubles or 4 floats (3432 and 924 do, 3003 and 257 do not).

    Tile rule: the large tile (128 x 128 in float64, 256 x 128 in
    float32) when the whole batch has at least one 128 x 128 tile for
    every SM of the card, else 64 x 64 (many more blocks, two of which
    fit an SM): 3432^2 gives 729 and takes the large tiles, 924^2 gives
    64 and takes 225 small ones, a batch of 14 such products gives 896
    and takes the large ones."""
    *xb, xs0, xs1 = x_strides
    *yb, ys0, ys1 = y_strides
    *ab, as0, as1 = a_strides
    vec = 16 // elem_size
    x_kmajor, x_vec16 = _staging(x_ptr, xs0, xs1, *xb, elem_size=elem_size)
    a_kmajor, a_vec16 = _staging(a_ptr, as0, as1, *ab, elem_size=elem_size)
    y_vec16 = (ys1 == 1 and ys0 % vec == 0 and y_ptr % 16 == 0
               and all(s % vec == 0 for s in yb))
    big_tiles = batch * -(-m // BIG_TILE) * -(-n // BIG_TILE)
    return MatmulPlan(x_kmajor, x_vec16, a_kmajor, a_vec16, y_vec16,
                      BIG_TILE if big_tiles >= sm_count else SMALL_TILE)


class Bf16Plan(NamedTuple):
    """How the bf16 ``factor_matmul`` kernel (``wgmma`` fed by TMA, 128 x
    256 output tiles) runs one product."""
    x_kmajor: bool  # X staged k-major (k contiguous), else MN-major
    x_tma: bool     # TMA addresses X where it lies (else it is repacked)
    a_kmajor: bool
    a_tma: bool
    x_3d: bool      # a 3-D tensor map, one X per batch member (else 2-D)
    a_3d: bool

    @property
    def bits(self) -> int:
        """The bit set ``csrc/factor_matmul.cu`` reads (BPLAN_*)."""
        return (self.x_kmajor | self.a_kmajor << 1 | self.x_3d << 2
                | self.a_3d << 3)


def _pad8(k: int) -> int:
    return -(-k // 8) * 8


def _tma_layout(ptr: int, rows: int, k: int, strides: tuple[int, ...],
                batch: int = 1) -> tuple[bool, bool]:
    """(k-major, TMA can address it) for an (rows, k) bfloat16 operand at
    byte address `ptr`, strides (row, k) or (batch, row, k) in elements.
    The operand is staged along its contiguous axis, k-major when that is
    k; TMA takes a 16-byte aligned base, a pitch that is a multiple of 8
    elements (16 bytes) and no shorter than a row and, for an operand per
    batch member, a batch stride that is a multiple of 8 and no shorter
    than a member.  With no contiguous axis it cannot: the wrapper
    repacks such an operand k-major."""
    *sb, s0, s1 = strides
    sb = sb[0] if sb and batch > 1 else 0
    if s1 == 1:
        kmajor, inner, outer, pitch = True, k, rows, s0
    elif s0 == 1:
        kmajor, inner, outer, pitch = False, rows, k, s1
    else:
        return True, False
    ok = ptr % 16 == 0 and pitch % 8 == 0 and pitch >= inner
    if sb:
        ok = ok and sb % 8 == 0 and sb >= pitch * outer
    return kmajor, ok


def factor_matmul_bf16_plan(x_ptr: int, x_strides: tuple[int, ...],
                            a_ptr: int, a_strides: tuple[int, ...],
                            m: int, n: int, k: int,
                            batch: int = 1) -> Bf16Plan:
    """The bf16 kernel's path for one product, from pointers (byte
    addresses), strides (in elements) and shape alone: each operand's
    majorness and whether TMA can address it (``_tma_layout``), and the
    batch handling, a 2-D tensor map for a shared operand (batch stride 0,
    or batch 1) and a 3-D one for an operand per member.  The tile is
    always 128 x 256."""
    x_kmajor, x_tma = _tma_layout(x_ptr, m, k, x_strides, batch)
    a_kmajor, a_tma = _tma_layout(a_ptr, n, k, a_strides, batch)
    return Bf16Plan(x_kmajor, x_tma, a_kmajor, a_tma,
                    batch > 1 and len(x_strides) == 3 and x_strides[0] != 0,
                    batch > 1 and len(a_strides) == 3 and a_strides[0] != 0)


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """`t`, a (rows, k) or (batch, rows, k) bfloat16 operand, itself where
    TMA can address it, else a k-major copy into a zero-padded buffer
    whose pitch is a multiple of 8 elements (one member's copy, expanded,
    for a shared operand of batch stride 0): the same values."""
    rows, k = t.shape[-2:]
    batch = t.shape[0] if t.dim() == 3 else 1
    if _tma_layout(t.data_ptr(), rows, k, t.stride(), batch)[1]:
        return t
    if batch > 1 and t.stride(0) == 0:
        return tma_operand(t[0]).expand_as(t)
    buf = t.new_zeros((*t.shape[:-1], _pad8(max(k, 1))))
    buf[..., :k] = t
    return buf[..., :k]


def dmma_fragment_map() -> dict[str, dict[tuple[int, int], tuple[int, int]]]:
    """Register-fragment layout of ``mma.sync.aligned.m16n8k4.row.col.f64
    .f64.f64.f64`` as ``csrc/factor_matmul.cu`` uses it: for each operand,
    (lane, register) -> (row, column) of its tile.  A is the 16 x 4 row
    operand, B the 4 x 8 column operand, C the 16 x 8 accumulator.  With
    g = lane // 4 and t = lane % 4: a[j] = A[g + 8 j][t], b[0] = B[t][g],
    c[2 j + i] = C[g + 8 j][2 t + i]."""
    frag = {"A": {}, "B": {}, "C": {}}
    for lane in range(32):
        g, t = divmod(lane, 4)
        frag["B"][lane, 0] = (t, g)
        for j in range(2):
            frag["A"][lane, j] = (g + 8 * j, t)
            for i in range(2):
                frag["C"][lane, 2 * j + i] = (g + 8 * j, 2 * t + i)
    return frag


def wgmma_accumulator_map(n: int) -> dict[tuple[int, int], tuple[int, int]]:
    """The float32 accumulator of ``wgmma.mma_async.sync.aligned.m64nNk16
    .f32.bf16.bf16`` (the kernel runs N = 256) as ``csrc/factor_matmul.cu``
    stores it: (thread of the warpgroup, register) -> (row, column) of its
    64 x n tile.  Register
    i of thread t holds row 16 (t // 32) + (t % 32) // 4 + 8 ((i // 2) % 2),
    column 8 (i // 4) + 2 (t % 4) + i % 2; n // 2 registers a thread."""
    acc = {}
    for thread in range(128):
        warp, lane = divmod(thread, 32)
        g, t = divmod(lane, 4)
        for i in range(n // 2):
            acc[thread, i] = (16 * warp + g + 8 * ((i // 2) % 2),
                              8 * (i // 4) + 2 * t + i % 2)
    return acc


# The bf16 kernel's staging (csrc/factor_matmul.cu): a stage is 64 k deep;
# a k-major tile is one TMA box [row][64 k], an MN-major tile boxes of 64
# rows [k][64 rows], WGMMA_BOX bytes apart; both in the 128-byte swizzle.
# The wgmma descriptors: k-major SBO 1024, k16 step 32 bytes; MN-major LBO
# WGMMA_BOX, SBO 1024, k16 step 2048 bytes.
WGMMA_DESC = {True: dict(lbo=16, sbo=1024, step=32),
              False: dict(lbo=WGMMA_BOX, sbo=1024, step=2048)}


def _swizzle128(offset: int) -> int:
    """Byte offset under the 128-byte swizzle (CUTLASS's Swizzle<3,4,3>):
    the 16-byte chunk within a 128-byte row XOR the row within 8."""
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_smem_offset(kmajor: bool, row: int, k: int) -> int:
    """Byte offset from a staged tile's start at which TMA puts element
    (row, k) of the tile, k < 64: a k-major box has 128-byte rows of k, an
    MN-major box (64 rows) 128-byte rows of 64 rows, one a k."""
    if kmajor:
        return _swizzle128(128 * row + 2 * k)
    box, r = divmod(row, 64)
    return box * WGMMA_BOX + _swizzle128(128 * k + 2 * r)


def wgmma_smem_offset(kmajor: bool, row: int, k: int) -> int:
    """Byte offset from a staged tile's start from which wgmma reads
    element (row, k), k < 64, through the kernel's descriptor for the k16
    step k // 16 (start, LBO, SBO of ``WGMMA_DESC``), by the canonical
    layouts of the 128-byte swizzle (CUTLASS make_gmma_desc), in 16-byte
    units T = 8 elements:
    k-major  ((8, m), (T, 2)) : ((8T, SBO), (1, T)),
    MN-major ((T, 8, m), (8, 2)) : ((1, T, LBO), (8T, SBO))."""
    d = WGMMA_DESC[kmajor]
    step, kk = divmod(k, 16)
    start = step * d["step"]
    if kmajor:
        r0, r1 = row % 8, row // 8
        k0, k1 = kk % 8, kk // 8
        offset = 128 * r0 + d["sbo"] * r1 + 2 * k0 + 16 * k1
    else:
        a, b, c = row % 8, (row // 8) % 8, row // 64
        k0, k1 = kk % 8, kk // 8
        offset = 2 * a + 16 * b + d["lbo"] * c + 128 * k0 + d["sbo"] * k1
    return _swizzle128(start + offset)


def factor_matmul(x: torch.Tensor, a: torch.Tensor,
                  out: torch.Tensor | None = None,
                  accumulate: bool = False) -> torch.Tensor:
    """``Y[m, n] = sum_k X[m, k] * A[n, k]``, or ``out += X . A^T`` with
    ``accumulate``.  Same semantics as the TPU ``factor_matmul``.

    x: (m, k), a: (n, k), out: (m, n); or a batch, x: (batch, m, k) and
    out: (batch, m, n) against the one shared a or a factor per member,
    a: (batch, n, k), in a single launch.  Any of them may be a strided
    view (a transpose, an expanded operand of batch stride 0, for
    instance).  The kernel
    reads and writes through each operand's strides, so ``A_dn . X`` runs
    as ``factor_matmul(X.T, A_dn, out=Y.T, accumulate=True)`` with no
    copy, and for a block of states as
    ``factor_matmul(X.transpose(1, 2), A_dn, out=Y.transpose(1, 2), ...)``.
    ``out`` must not overlap ``x`` or ``a``.  In float64 and float32 the
    kernel runs along the path ``factor_matmul_plan`` picks.

    bfloat16 ``x`` and ``a`` (the TPU kernel's bf16 operands; the caller
    rounds the state) run on ``wgmma`` with float32 sums, into a float32
    (the default) or float64 ``out``, along the path
    ``factor_matmul_bf16_plan`` picks; an operand TMA cannot address is
    first copied by ``tma_operand`` (counted in ``REPACKS``).

    Complex ``x`` and ``out`` (complex128 or complex64) run through the
    same real kernel: the state is split into contiguous real and
    imaginary planes, a batch of two.  A real factor `a` (the one-spin
    hop factors are real-valued unless the hoppings are complex) takes one
    launch over both planes; a complex one three (both planes times
    Re a, then Im x times -Im a into the real plane and Re x times Im a
    into the imaginary one).  A real factor per batch member takes two
    launches, the planes apart.
    """
    if x.dim() not in (2, 3) or a.dim() not in (2, x.dim()):
        raise ValueError(f"factor_matmul: x of 2 or 3 dimensions and a 2-D "
                         f"factor or one per batch member expected, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    *lead, m, k = x.shape
    n = a.shape[-2]
    if a.shape[-1] != k or (a.dim() == 3 and a.shape[0] != x.shape[0]):
        raise ValueError(f"factor_matmul: contraction mismatch "
                         f"{tuple(x.shape)} . {tuple(a.shape)}^T")
    bf16 = x.dtype == torch.bfloat16
    if out is None:
        if accumulate:
            raise ValueError("factor_matmul: accumulate needs an out tensor")
        out = torch.empty((*lead, m, n), device=x.device,
                          dtype=torch.float32 if bf16 else x.dtype)
    elif tuple(out.shape) != (*lead, m, n):
        raise ValueError(f"factor_matmul: out has shape {tuple(out.shape)}, "
                         f"expected {(*lead, m, n)}")

    if x.device.type == "cpu":
        y = factor_matmul_ref(x, a)
        if accumulate:
            out += y
        else:
            out.copy_(y)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"factor_matmul: no kernel for device {x.device}")
    if x.is_complex():
        return _factor_matmul_planes(x, a, out, accumulate)

    if bf16:
        _check_cuda_operands("factor_matmul", x, a,
                             dtypes=(torch.bfloat16,))
        _check_cuda_operands("factor_matmul", out,
                             dtypes=(torch.float32, torch.float64))
        if out.device != x.device:
            raise ValueError(f"factor_matmul: out on {out.device}, x on "
                             f"{x.device}")
    else:
        _check_cuda_operands("factor_matmul", x, a, out,
                             dtypes=(torch.float64, torch.float32))
    if _overlaps(out, x) or _overlaps(out, a):
        raise ValueError("factor_matmul: out overlaps an input")
    batch = lead[0] if lead else 1
    if max(batch, m, n, k) > _INT_MAX or min(
            (*x.stride(), *a.stride(), *out.stride())) < 0:
        raise ValueError("factor_matmul: a size over int32 range or a "
                         "negative stride")
    if batch == 0 or m == 0 or n == 0:
        return out
    if bf16:
        ready = tma_operand(x), tma_operand(a)
        copies = (ready[0] is not x) + (ready[1] is not a)
        if copies:
            key = "factor_matmul bf16"
            REPACKS[key] = REPACKS.get(key, 0) + copies
        x, a = ready
    # (batch, row, k) strides; the batch stride of one member is never used
    x_strides = (x.stride(0) if batch > 1 else 0, *x.stride()[-2:])
    a_strides = (a.stride(0) if batch > 1 and a.dim() == 3 else 0,
                 *a.stride()[-2:])
    y_strides = (out.stride(0) if batch > 1 else 0, *out.stride()[-2:])
    from lanczosplusplus_tpu_torch.ops.build import load_library
    form = f"bf16_{_SUFFIX[out.dtype]}" if bf16 else _SUFFIX[x.dtype]
    fn = getattr(load_library(), f"lpp_factor_matmul_{form}")
    if bf16:
        plan = factor_matmul_bf16_plan(x.data_ptr(), x_strides, a.data_ptr(),
                                       a_strides, m, n, k, batch).bits
    else:
        plan = factor_matmul_plan(
            x.data_ptr(), x_strides, a.data_ptr(), a_strides,
            out.data_ptr(), y_strides, m, n, _sm_count(x.device.index),
            batch, x.element_size()).bits
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *x_strides, a.data_ptr(), *a_strides,
                 out.data_ptr(), *y_strides, batch, m, n, k,
                 int(accumulate), plan, _stream(x))
    _launched("factor_matmul", form)
    if err != 0:
        raise RuntimeError(f"factor_matmul: kernel launch failed, "
                           f"cudaError {err}")
    return out


def _planes(t: torch.Tensor) -> torch.Tensor:
    """Contiguous (2, *t.shape) real tensor of a complex one: its real
    plane, then its imaginary plane."""
    return torch.view_as_real(t.resolve_conj()).movedim(-1, 0).contiguous()


def _factor_matmul_planes(x: torch.Tensor, a: torch.Tensor,
                          out: torch.Tensor, accumulate: bool) -> torch.Tensor:
    """``factor_matmul`` for a complex state on the card, through the real
    kernel on real and imaginary planes (see ``factor_matmul``)."""
    real = x.real.dtype
    if out.dtype != x.dtype or a.dtype not in (x.dtype, real):
        raise TypeError(f"factor_matmul: x {x.dtype}, a {a.dtype}, out "
                        f"{out.dtype}: a complex state takes a factor of "
                        f"its type or of {real}")
    *lead, m, k = x.shape
    n = a.shape[-2]
    half = lead[0] if lead else 1
    if half == 0 or m == 0 or n == 0:
        return out
    xp = _planes(x).view(2 * half, m, k)      # Re x[0..], then Im x[0..]
    yp = (_planes(out) if accumulate else
          torch.empty((2, *lead, m, n), dtype=real, device=x.device)
          ).view(2 * half, m, n)

    def both_planes(a_re):
        if a_re.dim() == 2:
            factor_matmul(xp, a_re, out=yp, accumulate=accumulate)
        else:   # a factor per member: each plane is a batch of its own
            for p in (slice(None, half), slice(half, None)):
                factor_matmul(xp[p], a_re, out=yp[p], accumulate=accumulate)
    if not a.is_complex():
        both_planes(a)
    else:
        a_re, a_im = _planes(a)
        both_planes(a_re)
        factor_matmul(xp[half:], -a_im, out=yp[:half], accumulate=True)
        factor_matmul(xp[:half], a_im, out=yp[half:], accumulate=True)
    yp = yp.view(2, *lead, m, n)
    out.copy_(torch.complex(yp[0], yp[1]))
    return out


def ell_spmv(diag: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, sliced: SlicedEll | None = None,
             src: torch.Tensor | None = None) -> torch.Tensor:
    """``y = diag * x + sum_k vals[:, k] * src[cols[:, k]]``, for one
    vector x: (dim,) or, in a single launch, for every row of a batch-major
    block x: (batch, dim); y has x's shape.  Without `src` the gathers read
    x itself.  A row shard of a distributed matrix (``parallel/``) gathers
    from a longer source: src of x's leading batch and at least dim
    entries a row, its rows at a pitch of their own (the all-gathered
    state, or the shard's rows followed by its halo).

    cols: (dim, K) int32 with every entry in [0, len(src)) (padding points
    at its own row with value 0), vals: (dim, K), diag: (dim,); cols,
    vals, diag and x contiguous, src contiguous along a row.  On the CPU
    the plain version computes it from (cols, vals).  The CUDA kernel
    reads `sliced`, the matrix's sliced form (``slice_ell(cols, vals)``,
    made once per matrix: the Hamiltonian keeps it, ``EllPart.sliced``),
    and raises without one; it takes float64, float32, complex128 or
    complex64 operands, all of the one dtype.
    """
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"ell_spmv: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (dim, K) shape")
    dim, k = cols.shape
    if diag.shape != (dim,) or x.dim() not in (1, 2) or x.shape[-1] != dim:
        raise ValueError(f"ell_spmv: diag {tuple(diag.shape)} must be "
                         f"({dim},) and x {tuple(x.shape)} ({dim},) or "
                         f"(batch, {dim})")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols must be int32, not {cols.dtype}")
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"ell_spmv: cols (strides {cols.stride()}) and "
                         f"vals (strides {vals.stride()}) must be "
                         f"contiguous (dim, K)")
    if not (diag.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv: diag and x must be contiguous")
    x = x.resolve_conj()
    if src is not None:
        if src.dim() != x.dim() or src.shape[:-1] != x.shape[:-1] or \
                src.shape[-1] < dim:
            raise ValueError(f"ell_spmv: src {tuple(src.shape)} must have "
                             f"x's leading batch {tuple(x.shape[:-1])} and "
                             f"at least {dim} entries a row")
        src = src.resolve_conj()
        if src.stride(-1) != 1 or (src.dim() == 2 and src.stride(0) <
                                   src.shape[-1]):
            raise ValueError(f"ell_spmv: src (strides {src.stride()}) must "
                             f"be contiguous along a row, rows apart")

    if x.device.type == "cpu":
        return ell_spmv_ref(diag, cols, vals, x, src)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")

    _check_cuda_operands("ell_spmv", diag, vals, x,
                         *(() if src is None else (src,)))
    if cols.device != x.device:
        raise ValueError(f"ell_spmv: cols on {cols.device}, x on {x.device}")
    if sliced is None:
        raise ValueError("ell_spmv: the CUDA kernel reads the matrix's "
                         "sliced form (slice_ell), and none was given")
    _check_cuda_operands("ell_spmv", x, sliced.vals)
    if any(t.device != x.device for t in sliced[:5]):
        raise ValueError(f"ell_spmv: a sliced form off {x.device}")
    if sliced.perm.shape != (dim,):
        raise ValueError(f"ell_spmv: a sliced form of {sliced.perm.numel()} "
                         f"rows for a matrix of {dim}")
    batch = x.shape[0] if x.dim() == 2 else 1
    slices = sliced.widths.numel()
    if max(dim, k, batch) > _INT_MAX:
        raise ValueError("ell_spmv: dim, K or batch out of int32 range")
    y = torch.empty_like(x)
    if dim == 0 or batch == 0:
        return y
    # the gathers' source and its batch pitch: x itself, or src
    if src is None:
        src_ptr, pitch = x.data_ptr(), dim
    else:
        src_ptr = src.data_ptr()
        pitch = src.stride(0) if src.dim() == 2 else src.shape[0]
    from lanczosplusplus_tpu_torch.ops.build import load_library
    form = _SUFFIX[x.dtype]
    fn = getattr(load_library(), f"lpp_ell_spmv_{form}")
    with torch.cuda.device(x.device):
        err = fn(diag.data_ptr(), sliced.perm.data_ptr(),
                 sliced.offsets.data_ptr(), sliced.widths.data_ptr(),
                 sliced.cols.data_ptr(), sliced.vals.data_ptr(),
                 x.data_ptr(), src_ptr, pitch, y.data_ptr(), dim, slices,
                 sliced.typical_width, batch, _stream(x))
    _launched("ell_spmv", form)
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed, cudaError {err}")
    return y


def _channels(rs, a, cs, beta) -> int:
    tables = [t for t in (rs, a, cs, beta) if t is not None]
    if not tables:
        raise ValueError("perm_gather: both sides are the identity")
    nb = tables[0].shape[0]
    if any(t.shape[0] != nb for t in tables):
        raise ValueError(f"perm_gather: tables of {[t.shape[0] for t in tables]}"
                         f" channels")
    return nb


def perm_gather_ref(x: torch.Tensor, out: torch.Tensor, rs=None, a=None,
                    cs=None, beta=None, groups=None,
                    col_groups=None) -> torch.Tensor:
    """Plain version of ``perm_gather``: ``out += sum_n a[n][:, None] *
    x[..., rs[n], :][..., cs[n]] * beta[n][None, :]``, the bond loop of the
    JAX package's ``_perm_cross_apply(_batched)`` (``core/blockkron.py``).
    Channels in one of `groups` share their row gather; channels in one
    of `col_groups` (same column map and amplitudes) sum their row sides
    before one column gather.  Each term is added into `out` in place.
    None for a table is the identity with amplitude 1.  A bfloat16 `x`
    (bf16cross) is widened to out's type first, exactly, and the sums run
    in that type (the JAX package's col-dedup path rounds each group's
    summed row side to bf16 again; this version does not)."""
    if x.dtype == torch.bfloat16:
        x = x.to(out.dtype)
    nb = _channels(rs, a, cs, beta)
    groups = groups or tuple((n,) for n in range(nb))
    rows_of = {}
    for group in groups:
        rows = x if rs is None else x[..., rs[group[0]], :]
        for n in group:
            rows_of[n] = rows

    def row_side(n):
        return rows_of[n] if a is None else a[n][:, None] * rows_of[n]

    def col_side(v, n):
        v = v if cs is None else v[..., cs[n]]
        return v if beta is None else v * beta[n][None, :]
    if col_groups is not None and any(len(g) > 1 for g in col_groups):
        for cgroup in col_groups:
            pre = None
            for n in cgroup:
                pre = row_side(n) if pre is None else pre + row_side(n)
            out += col_side(pre, cgroup[0])
    else:
        for group in groups:
            for n in group:
                out += col_side(row_side(n), n)
    return out


def perm_gather(x: torch.Tensor, out: torch.Tensor, rs=None, a=None,
                cs=None, beta=None, groups=None,
                col_groups=None) -> torch.Tensor:
    """``out[b, r, c] += sum_n a[n, r] * beta[n, c] * x[b, rs[n, r],
    cs[n, c]]``, in place on `out`, for one (rows_src, cols_src) block x
    and (rows, cols) out, or a batch of them, (batch, ., .), in a single
    launch.  x and out may be strided views, out must not overlap x.

    rs: (nb, rows) int32 indices into x's rows, a: (nb, rows) amplitudes;
    cs: (nb, cols) int32 indices into x's columns, beta: (nb, cols); all
    contiguous, amplitudes of out's dtype.  None for an index table is the
    identity, None for an amplitude table 1.  The channel groups only
    steer the plain version (``perm_gather_ref``), which a CPU tensor
    takes; the CUDA kernel needs none.  It takes float64, float32,
    complex128 or complex64 throughout, or a bfloat16 x (the bf16cross
    source block) with float32 or float64 amplitudes and out.
    """
    nb = _channels(rs, a, cs, beta)
    if x.dim() not in (2, 3) or out.dim() != x.dim() or \
            x.shape[:-2] != out.shape[:-2]:
        raise ValueError(f"perm_gather: x {tuple(x.shape)} and out "
                         f"{tuple(out.shape)} must be one or a batch of "
                         f"2-D blocks")
    *lead, rows, cols = out.shape
    for name, t, length in (("rs", rs, rows), ("a", a, rows),
                            ("cs", cs, cols), ("beta", beta, cols)):
        if t is None:
            continue
        if t.shape != (nb, length) or not t.is_contiguous():
            raise ValueError(f"perm_gather: {name} must be a contiguous "
                             f"({nb}, {length}), got {tuple(t.shape)}")
        if name in ("rs", "cs") and t.dtype != torch.int32:
            raise TypeError(f"perm_gather: {name} must be int32")
    if (rs is None and x.shape[-2] != rows) or \
            (cs is None and x.shape[-1] != cols):
        raise ValueError(f"perm_gather: an identity side needs x "
                         f"{tuple(x.shape)} and out {tuple(out.shape)} to "
                         f"agree on it")

    if x.device.type == "cpu":
        return perm_gather_ref(x, out, rs, a, cs, beta, groups, col_groups)
    if x.device.type != "cuda":
        raise ValueError(f"perm_gather: no kernel for device {x.device}")
    amps = [t for t in (a, beta) if t is not None]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _check_cuda_operands("perm_gather", out, *amps,
                             dtypes=(torch.float64, torch.float32))
        if x.device != out.device:
            raise ValueError(f"perm_gather: x on {x.device}, out on "
                             f"{out.device}")
    else:
        _check_cuda_operands("perm_gather", x, out, *amps,
                             dtypes=tuple(_SUFFIX))
    if any(t.device != x.device for t in (rs, cs) if t is not None):
        raise ValueError("perm_gather: index tables on another device")
    if _overlaps(out, x):
        raise ValueError("perm_gather: out overlaps x")
    batch = lead[0] if lead else 1
    if max(batch * rows, cols, nb) > _INT_MAX or min(x.stride()) < 0 \
            or min(out.stride()) < 0:
        raise ValueError("perm_gather: a size over int32 range or a "
                         "negative stride")
    if batch == 0 or rows == 0 or cols == 0:
        return out
    from lanczosplusplus_tpu_torch.ops.build import load_library
    form = ("bf16_" if bf16 else "") + _SUFFIX[out.dtype]
    fn = getattr(load_library(), f"lpp_perm_gather_{form}")

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.stride(0) if lead else 0,
                 *x.stride()[-2:], out.data_ptr(),
                 out.stride(0) if lead else 0, *out.stride()[-2:],
                 ptr(rs), ptr(a), ptr(cs), ptr(beta), nb, rows, cols, batch,
                 _stream(x))
    _launched("perm_gather", form)
    if err != 0:
        raise RuntimeError(f"perm_gather: kernel launch failed, "
                           f"cudaError {err}")
    return out


class HopTables(NamedTuple):
    """A one-spin hop map's nonzero entries (``compact_hops``): entry k of
    row i at [k, i] of `cols` and `vals` for k below ``counts[i]``, in the
    map's bond order; the other slots hold the row's own index and 0."""
    cols: torch.Tensor    # (K, size) int32, K the most entries of a row
    vals: torch.Tensor    # (K, size)
    counts: torch.Tensor  # (size,) int32

    @property
    def nnz(self) -> int:
        """The map's nonzero entries."""
        return int(self.counts.sum())


def compact_hops(cols: torch.Tensor, vals: torch.Tensor) -> HopTables:
    """The nonzero entries of a padded one-spin ELL map (cols, vals), each
    (size, K), in their k order (the ascending bond order of
    ``core/sparse.one_spin_ell``), on the map's device, as ``spin_hop``
    reads them (``HopTables``): every entry of value 0, the map's padding
    and the bonds a row does not hop along, is dropped."""
    size = cols.shape[0]
    nz = vals != 0
    counts = nz.sum(1)
    k = int(counts.max()) if size else 0
    out_cols = torch.arange(size, dtype=torch.int32,
                            device=cols.device).repeat(k, 1)
    out_vals = vals.new_zeros((k, size))
    r, j = nz.nonzero(as_tuple=True)        # row-major: j ascends in a row
    slot = nz.cumsum(1)[r, j] - 1
    out_cols[slot, r] = cols[r, j].to(torch.int32)
    out_vals[slot, r] = vals[r, j]
    return HopTables(out_cols, out_vals, counts.to(torch.int32))


class HopPlan(NamedTuple):
    """How the ``spin_hop`` kernel runs one apply."""
    group: int   # consecutive rows (b, d) a block owns
    stage: bool  # the rows go through shared memory


def spin_hop_plan(szu: int, elem_size: int, has_up: bool) -> HopPlan:
    """The kernel's path from the row length and type alone: the rows are
    staged where the up map gathers from them and one fits
    ``SPIN_HOP_STAGE_BYTES``, ``SPIN_HOP_MAX_GROUP`` of them a block where
    they fit it together (the 14-site chain's 3432-long rows, in float64
    and float32), else one; a row read in place, one a block."""
    row = max(szu, 1) * elem_size
    stage = has_up and row <= SPIN_HOP_STAGE_BYTES
    group = (SPIN_HOP_MAX_GROUP
             if stage and SPIN_HOP_MAX_GROUP * row <= SPIN_HOP_STAGE_BYTES
             else 1)
    return HopPlan(group, stage)


def spin_hop_ref(x: torch.Tensor, y: torch.Tensor,
                 diag: torch.Tensor | None = None, up: HopTables | None = None,
                 dn: HopTables | None = None) -> torch.Tensor:
    """Plain version of ``spin_hop``: y = diag * x where a diagonal is
    given, then ``perm_gather_ref``'s channel loop over the compacted up
    map (the columns gathered) and then the dn map (the rows gathered),
    each term added into y in place."""
    if diag is not None:
        torch.mul(diag.view(x.shape[-2:]), x, out=y)
    if up is not None:
        perm_gather_ref(x, y, cs=up.cols, beta=up.vals)
    if dn is not None:
        perm_gather_ref(x, y, rs=dn.cols, a=dn.vals)
    return y


def spin_hop(x: torch.Tensor, y: torch.Tensor,
             diag: torch.Tensor | None = None, up: HopTables | None = None,
             dn: HopTables | None = None) -> torch.Tensor:
    """``y[b, d, u] = diag[d szu + u] x[b, d, u] + sum_k up.vals[k, u]
    x[b, d, up.cols[k, u]] + sum_k dn.vals[k, d] x[b, dn.cols[k, d], u]``
    in place on y, for one state x viewed as (size_down, size_up) or a
    block of them (batch, size_down, size_up), in a single launch.  Without
    `diag` the sums are added into y as it is (the diagonal and an ELL part
    in it already).  `up` and `dn` are compacted hop maps
    (``compact_hops``) of size_up and size_down rows; either may be None.

    x and y contiguous, of one shape, not overlapping; the CUDA kernel
    takes float64 or float32 throughout.  A CPU tensor takes the plain
    version (``spin_hop_ref``), which the kernel equals bit for bit."""
    if x.dim() not in (2, 3) or tuple(y.shape) != tuple(x.shape):
        raise ValueError(f"spin_hop: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be one (size_down, "
                         f"size_up) shape or a batch of it")
    szd, szu = x.shape[-2:]
    if up is None and dn is None:
        raise ValueError("spin_hop: neither an up nor a dn map")
    for name, tabs, size in (("up", up, szu), ("dn", dn, szd)):
        if tabs is None:
            continue
        k = tabs.cols.shape[0]
        if tabs.cols.shape != (k, size) or tabs.vals.shape != (k, size) or \
                tabs.counts.shape != (size,):
            raise ValueError(f"spin_hop: the {name} map's tables "
                             f"{tuple(tabs.cols.shape)}, "
                             f"{tuple(tabs.vals.shape)}, "
                             f"{tuple(tabs.counts.shape)} are not (K, {size})"
                             f" and ({size},)")
        if tabs.cols.dtype != torch.int32 or tabs.counts.dtype != torch.int32:
            raise TypeError(f"spin_hop: the {name} map's indices and counts "
                            f"must be int32")
    if diag is not None and diag.shape != (szd * szu,):
        raise ValueError(f"spin_hop: diag {tuple(diag.shape)} for a "
                         f"({szd}, {szu}) state")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("spin_hop: x and y must be contiguous")

    if x.device.type == "cpu":
        return spin_hop_ref(x, y, diag, up, dn)
    if x.device.type != "cuda":
        raise ValueError(f"spin_hop: no kernel for device {x.device}")
    tables = [t for tabs in (up, dn) if tabs is not None for t in tabs]
    _check_cuda_operands("spin_hop", x, y,
                         *(() if diag is None else (diag,)),
                         *(t for t in tables if t.dtype != torch.int32),
                         dtypes=(torch.float64, torch.float32))
    if any(t.device != x.device for t in tables):
        raise ValueError("spin_hop: tables on another device")
    if _overlaps(y, x):
        raise ValueError("spin_hop: y overlaps x")
    batch = x.shape[0] if x.dim() == 3 else 1
    if batch * szd > _INT_MAX or any(t.numel() > _INT_MAX for t in tables):
        raise ValueError("spin_hop: rows or tables over int32 range")
    plan = spin_hop_plan(szu, x.element_size(), up is not None)
    from lanczosplusplus_tpu_torch.ops.build import load_library
    form = _SUFFIX[x.dtype]
    fn = getattr(load_library(), f"lpp_spin_hop_{form}")

    def ptrs(tabs):
        return (None, None, None) if tabs is None else \
            tuple(t.data_ptr() for t in tabs)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(),
                 None if diag is None else diag.data_ptr(), *ptrs(up),
                 *ptrs(dn), 0 if dn is None else dn.cols.shape[0], szd, szu,
                 batch, plan.group, int(plan.stage), _stream(x))
    _launched("spin_hop", form)
    if err != 0:
        raise RuntimeError(f"spin_hop: kernel launch failed, cudaError {err}")
    return y
