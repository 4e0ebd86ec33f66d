"""The hot-path kernels, their plain PyTorch versions and the dispatch.

Counterpart of ``lanczosplusplus_tpu/ops/pallas_kernels.py``.  Two
kernels, each written by hand in CUDA C++ for Hopper (``csrc/``):

- ``factor_matmul``: ``Y (+)= X . A^T`` on strided operands, the dense
  Kronecker hop factors of every Lanczos matvec, on the FP64 tensor cores
  in float64 (``csrc/factor_matmul.cu``);
- ``ell_spmv``: ``y = diag * x + sum_k vals[:, k] * x[cols[:, k]]`` over a
  padded ELL matrix, stored K-major for coalesced reads
  (``csrc/ell_spmv.cu``).

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain version (``*_ref``), a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.  Each wrapper adds
one to ``LAUNCHES[name]`` where it launches its kernel, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

LAUNCHES = {"factor_matmul": 0, "ell_spmv": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_INT_MAX = 2**31 - 1
H100_SMS = 132
BIG_TILE, SMALL_TILE = 128, 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def factor_matmul_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of ``factor_matmul``: ``x @ a.T``."""
    return x @ a.T


def ell_spmv_ref(diag: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ell_spmv``."""
    return diag * x + (vals * x[cols]).sum(-1)


def _check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operands of {t.dtype} and {dt}")
    if dt not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernel takes float64 or float32, "
                        f"not {dt}")


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
    """How the float64 ``factor_matmul`` kernel runs one product."""
    x_kmajor: bool  # X staged [row][k] (else [k][row])
    x_vec16: bool   # X copied 16 bytes at a time (else 8)
    a_kmajor: bool
    a_vec16: bool
    y_vec16: bool   # Y read and written 16 bytes at a time
    tile: int       # output tile edge of a block: 128 or 64

    @property
    def bits(self) -> int:
        """The bit set ``csrc/factor_matmul.cu`` reads (PLAN_*)."""
        return (self.x_kmajor | self.x_vec16 << 1 | self.a_kmajor << 2
                | self.a_vec16 << 3 | self.y_vec16 << 4
                | (self.tile == BIG_TILE) << 5)


def _staging(ptr: int, row_stride: int, k_stride: int) -> tuple[bool, bool]:
    """(k-major, 16-byte copies) for an (rows, k) float64 operand at byte
    address `ptr` with strides in elements.  The operand is staged along
    its contiguous axis; 16-byte copies need that axis at stride 1, an
    even pitch on the other and a 16-byte aligned base.  With no
    contiguous axis the nearer one is walked, 8 bytes at a time."""
    if k_stride == 1:
        return True, ptr % 16 == 0 and row_stride % 2 == 0
    if row_stride == 1:
        return False, ptr % 16 == 0 and k_stride % 2 == 0
    return k_stride <= row_stride, False


def factor_matmul_plan(x_ptr: int, x_strides: tuple[int, int],
                       a_ptr: int, a_strides: tuple[int, int],
                       y_ptr: int, y_strides: tuple[int, int],
                       m: int, n: int,
                       sm_count: int = H100_SMS) -> MatmulPlan:
    """The float64 kernel's path for one product, from pointers (byte
    addresses), strides (in elements) and shape alone.

    Tile rule: 128 x 128 output tiles when there is at least one for
    every SM of the card, else 64 x 64 (four times the blocks, two of
    which fit an SM): 3432^2 gives 729 large tiles and takes
    them, 924^2 gives 64 and takes 225 small ones."""
    x_kmajor, x_vec16 = _staging(x_ptr, *x_strides)
    a_kmajor, a_vec16 = _staging(a_ptr, *a_strides)
    y_vec16 = (y_strides[1] == 1 and y_strides[0] % 2 == 0
               and y_ptr % 16 == 0)
    big_tiles = -(-m // BIG_TILE) * -(-n // BIG_TILE)
    return MatmulPlan(x_kmajor, x_vec16, a_kmajor, a_vec16, y_vec16,
                      BIG_TILE if big_tiles >= sm_count else SMALL_TILE)


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


def factor_matmul(x: torch.Tensor, a: torch.Tensor,
                  out: torch.Tensor | None = None,
                  accumulate: bool = False) -> torch.Tensor:
    """``Y[m, n] = sum_k X[m, k] * A[n, k]``, or ``out += X . A^T`` with
    ``accumulate``.  Same semantics as the TPU ``factor_matmul``.

    x: (m, k), a: (n, k), out: (m, n); any of them may be a strided view
    (a transpose, for instance).  The kernel reads and writes through
    each operand's strides, so ``A_dn . X`` runs as
    ``factor_matmul(X.T, A_dn, out=Y.T, accumulate=True)`` with no copy.
    ``out`` must not overlap ``x`` or ``a``.  In float64 the kernel runs
    on the FP64 tensor cores along the path ``factor_matmul_plan`` picks.
    """
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"factor_matmul: 2-D operands expected, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    m, k = x.shape
    n = a.shape[0]
    if a.shape[1] != k:
        raise ValueError(f"factor_matmul: contraction mismatch "
                         f"{tuple(x.shape)} . {tuple(a.shape)}^T")
    if out is None:
        if accumulate:
            raise ValueError("factor_matmul: accumulate needs an out tensor")
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    elif tuple(out.shape) != (m, n):
        raise ValueError(f"factor_matmul: out has shape {tuple(out.shape)}, "
                         f"expected {(m, n)}")

    if x.device.type == "cpu":
        y = factor_matmul_ref(x, a)
        if accumulate:
            out += y
        else:
            out.copy_(y)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"factor_matmul: no kernel for device {x.device}")

    _check_cuda_operands("factor_matmul", x, a, out)
    if _overlaps(out, x) or _overlaps(out, a):
        raise ValueError("factor_matmul: out overlaps an input")
    strides = (*x.stride(), *a.stride(), *out.stride())
    if max(m, n, k) > _INT_MAX or min(strides) < 0:
        raise ValueError("factor_matmul: a size over int32 range or a "
                         "negative stride")
    if m == 0 or n == 0:
        return out
    from lanczosplusplus_tpu_torch.ops.build import load_library
    fn = getattr(load_library(), f"lpp_factor_matmul_{_SUFFIX[x.dtype]}")
    args = [x.data_ptr(), *x.stride(), a.data_ptr(), *a.stride(),
            out.data_ptr(), *out.stride(), m, n, k, int(accumulate)]
    if x.dtype == torch.float64:
        args.append(factor_matmul_plan(
            x.data_ptr(), x.stride(), a.data_ptr(), a.stride(),
            out.data_ptr(), out.stride(), m, n,
            _sm_count(x.device.index)).bits)
    with torch.cuda.device(x.device):
        err = fn(*args, _stream(x))
    LAUNCHES["factor_matmul"] += 1
    if err != 0:
        raise RuntimeError(f"factor_matmul: kernel launch failed, "
                           f"cudaError {err}")
    return out


def _ell_strides(t: torch.Tensor) -> tuple[int, int]:
    """(row stride, k stride) of a (dim, K) tensor in one of the two
    layouts ``ell_spmv`` takes.  Derived from the layout, not read from
    ``stride()``, which is arbitrary along an axis of size 1."""
    dim, k = t.shape
    return (k, 1) if t.is_contiguous() else (1, dim)


def ell_spmv(diag: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y = diag * x + sum_k vals[:, k] * x[cols[:, k]]``.

    cols: (dim, K) int32 with every entry in [0, dim) (padding points at
    its own row with value 0), vals: (dim, K), diag and x: (dim,).
    cols and vals share one layout: K-major, a transposed view of
    contiguous (K, dim) storage with strides (1, dim), which is what
    ``hamiltonian_from_numpy`` stores and what the kernel reads
    coalesced, or contiguous (dim, K).  The CUDA kernel takes float64 or
    float32 operands of one dtype; complex values raise there.
    """
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"ell_spmv: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (dim, K) shape")
    dim, k = cols.shape
    if diag.shape != (dim,) or x.shape != (dim,):
        raise ValueError(f"ell_spmv: diag {tuple(diag.shape)} and x "
                         f"{tuple(x.shape)} must be ({dim},)")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols must be int32, not {cols.dtype}")
    if cols.is_contiguous() != vals.is_contiguous() or \
            cols.T.is_contiguous() != vals.T.is_contiguous():
        raise ValueError(f"ell_spmv: cols (strides {cols.stride()}) and "
                         f"vals (strides {vals.stride()}) must share one "
                         f"layout, both K-major or both contiguous")
    if not (cols.is_contiguous() or cols.T.is_contiguous()):
        raise ValueError(f"ell_spmv: cols and vals must be K-major (a "
                         f"transposed contiguous (K, dim) tensor) or "
                         f"contiguous (dim, K), not strides {cols.stride()}")
    if not (diag.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv: diag and x must be contiguous")

    if x.device.type == "cpu":
        return ell_spmv_ref(diag, cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")

    _check_cuda_operands("ell_spmv", diag, vals, x)
    if cols.device != x.device:
        raise ValueError(f"ell_spmv: cols on {cols.device}, x on {x.device}")
    if dim > _INT_MAX or k > _INT_MAX:
        raise ValueError("ell_spmv: dim or K out of int32 range")
    y = torch.empty((dim,), dtype=x.dtype, device=x.device)
    if dim == 0:
        return y
    from lanczosplusplus_tpu_torch.ops.build import load_library
    fn = getattr(load_library(), f"lpp_ell_spmv_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(diag.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), dim, k, *_ell_strides(cols),
                 _stream(x))
    LAUNCHES["ell_spmv"] += 1
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed, cudaError {err}")
    return y
