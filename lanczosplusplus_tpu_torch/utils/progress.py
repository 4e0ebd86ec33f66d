"""Wall-clock-stamped progress logging.

Counterpart of ``lanczosplusplus_tpu/utils/progress.py``, without its
profiler hook (tracing the port waits for a later slice).  Replaces
PsimagLite::ProgressIndicator ("Class [T]: message" lines, reference:
src/Engine/Engine.h:86, 677).
"""

from __future__ import annotations

import contextlib
import sys
import time

_T0 = time.time()


class ProgressIndicator:
    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream or sys.stderr

    def __call__(self, msg: str):
        t = time.time() - _T0
        self.stream.write(f"{self.name} [{t:.2f}]: {msg}\n")

    @contextlib.contextmanager
    def phase(self, label: str):
        self(f"{label} starting")
        t0 = time.perf_counter()
        yield
        self(f"{label} done in {time.perf_counter() - t0:.3f}s")
