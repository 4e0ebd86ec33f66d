"""Numeric configuration: dtypes, device and seed.

Counterpart of ``lanczosplusplus_tpu/config.py``.  The reference is double
precision throughout (reference: src/Engine/LanczosDriver.h:29-33), and
Hopper has native FP64, so the default is float64 on every device.
float32 (complex64 with useComplex) is the JAX package's precision on its
own chip, asked for here with ``real_dtype``: its energies are refined to
the float64 bar (``solver/lanczos._maybe_refine``).  The device is
explicit: asking for ``cuda`` where there is no card raises; it never runs
on the CPU instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_REAL_OF = {torch.float64: torch.float64, torch.float32: torch.float32,
            torch.complex128: torch.float64, torch.complex64: torch.float32}
_COMPLEX_OF = {torch.float64: torch.complex128, torch.float32: torch.complex64}
_NUMPY_OF = {torch.float64: np.float64, torch.float32: np.float32,
             torch.complex128: np.complex128, torch.complex64: np.complex64}


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """float64 for float64/complex128, float32 for float32/complex64."""
    return _REAL_OF[dtype]


def complex_dtype_for(real_dtype: torch.dtype) -> torch.dtype:
    """complex128 for float64, complex64 for float32."""
    return _COMPLEX_OF[real_dtype]


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype the host code uses for a torch scalar dtype."""
    return _NUMPY_OF[dtype]


def resolve_device(device) -> torch.device:
    """torch.device of `device`; raises when it names CUDA and there is
    no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")
    return device


@dataclasses.dataclass
class Config:
    """Solver configuration (reference: PsimagLite ParametersForSolver read
    from the input file, used at src/Engine/Engine.h:60-65)."""

    lanczos_steps: int = 200
    seed: int = 7239443
    use_complex: bool = False
    device: torch.device | str = "cuda"
    # float64, or float32 on request (the JAX package's default on its
    # chip, where x64 is off)
    real_dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.real_dtype not in _COMPLEX_OF:
            raise ValueError(f"real_dtype must be torch.float64 or "
                             f"torch.float32, not {self.real_dtype}")

    @classmethod
    def from_input(cls, inp, device="cuda",
                   real_dtype: torch.dtype = torch.float64) -> "Config":
        """The labels the reference reads into its solver parameters."""
        return cls(use_complex="useComplex" in inp.solver_options(),
                   lanczos_steps=inp.integer("LanczosSteps", default=200),
                   device=device, real_dtype=real_dtype)

    @property
    def scalar_dtype(self) -> torch.dtype:
        """real_dtype, or its complex type with useComplex."""
        if self.use_complex:
            return complex_dtype_for(self.real_dtype)
        return self.real_dtype
