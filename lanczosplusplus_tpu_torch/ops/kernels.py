"""The hot-path kernels, their plain PyTorch versions and the dispatch.

Counterpart of ``lanczosplusplus_tpu/ops/pallas_kernels.py``.  Two
kernels, each written by hand in CUDA C++ for Hopper (``csrc/``):

- ``factor_matmul``: ``Y (+)= X . A^T`` on strided operands, the dense
  Kronecker hop factors of every Lanczos matvec
  (``csrc/factor_matmul.cu``);
- ``ell_spmv``: ``y = diag * x + sum_k vals[:, k] * x[cols[:, k]]`` over a
  padded ELL matrix (``csrc/ell_spmv.cu``).

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain version (``*_ref``), a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.  Each wrapper adds
one to ``LAUNCHES[name]`` where it launches its kernel, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {"factor_matmul": 0, "ell_spmv": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_INT_MAX = 2**31 - 1


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


def factor_matmul(x: torch.Tensor, a: torch.Tensor,
                  out: torch.Tensor | None = None,
                  accumulate: bool = False) -> torch.Tensor:
    """``Y[m, n] = sum_k X[m, k] * A[n, k]``, or ``out += X . A^T`` with
    ``accumulate``.  Same semantics as the TPU ``factor_matmul``.

    x: (m, k), a: (n, k), out: (m, n); any of them may be a strided view
    (a transpose, for instance).  The kernel reads and writes through
    each operand's strides, so ``A_dn . X`` runs as
    ``factor_matmul(X.T, A_dn, out=Y.T, accumulate=True)`` with no copy.
    ``out`` must not overlap ``x`` or ``a``.
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
    if max(m, n, k, *strides) > _INT_MAX or min(strides) < 0:
        raise ValueError("factor_matmul: sizes or strides out of int32 range")
    if m == 0 or n == 0:
        return out
    from lanczosplusplus_tpu_torch.ops.build import load_library
    fn = getattr(load_library(), f"lpp_factor_matmul_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *x.stride(), a.data_ptr(), *a.stride(),
                 out.data_ptr(), *out.stride(), m, n, k, int(accumulate),
                 _stream(x))
    LAUNCHES["factor_matmul"] += 1
    if err != 0:
        raise RuntimeError(f"factor_matmul: kernel launch failed, "
                           f"cudaError {err}")
    return out


def ell_spmv(diag: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y = diag * x + sum_k vals[:, k] * x[cols[:, k]]``.

    cols: (dim, K) int32 with every entry in [0, dim) (padding points at
    its own row with value 0), vals: (dim, K), diag and x: (dim,).  The
    CUDA kernel takes contiguous float64 or float32 operands of one
    dtype; complex values raise there.
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

    if x.device.type == "cpu":
        return ell_spmv_ref(diag, cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")

    _check_cuda_operands("ell_spmv", diag, vals, x)
    if cols.device != x.device:
        raise ValueError(f"ell_spmv: cols on {cols.device}, x on {x.device}")
    for t in (diag, cols, vals, x):
        if not t.is_contiguous():
            raise ValueError("ell_spmv: operands must be contiguous")
    if dim > _INT_MAX or k > _INT_MAX:
        raise ValueError("ell_spmv: dim or K out of int32 range")
    y = torch.empty((dim,), dtype=x.dtype, device=x.device)
    if dim == 0:
        return y
    from lanczosplusplus_tpu_torch.ops.build import load_library
    fn = getattr(load_library(), f"lpp_ell_spmv_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(diag.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), dim, k, _stream(x))
    LAUNCHES["ell_spmv"] += 1
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed, cudaError {err}")
    return y
