"""The system under test as the harness sees it: a configuration's input
text (its sector is built by builds/<build>.py), and the delegate that
marks the sector's applies in a trace.
"""

from __future__ import annotations

import torch


def input_text(config: dict) -> str:
    return "\n".join(config["input"]) + "\n"


class SpannedHamiltonian:
    """The sector Hamiltonian seen through a delegate whose every apply
    opens a ``torch.profiler.record_function("apply")`` span and counts
    the rows it applies to.  The solver and the estimators find every
    attribute they read here (``dim``, ``dtype``, ``device``,
    ``quantized``, ``matvec``, ``matmat_t``), and nothing that would send
    them down another path (``inner``, ``perm``, ``mesh``)."""

    def __init__(self, ham):
        self._ham = ham
        self.rows = 0

    @property
    def dim(self) -> int:
        return self._ham.dim

    @property
    def dtype(self) -> torch.dtype:
        return self._ham.dtype

    @property
    def device(self) -> torch.device:
        return self._ham.device

    @property
    def quantized(self) -> bool:
        return self._ham.quantized

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function("apply"):
            self.rows += 1
            return self._ham.matvec(x)

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function("apply"):
            self.rows += xk.shape[0] if xk.dim() == 2 else 1
            return self._ham.matmat_t(xk)
