"""Wall-clock-stamped progress logging, and the port's spans and counters.

Counterpart of ``lanczosplusplus_tpu/utils/progress.py``.
``ProgressIndicator`` replaces PsimagLite::ProgressIndicator ("Class [T]:
message" lines, reference: src/Engine/Engine.h:86, 677); each of its
phases is a span too.

Spans and counters mark the port's layer boundaries (the sector build,
the solver's steps, the estimators, the solver-to-apply boundary):

    span(name)      a context manager around one piece of work
    count(name, n)  adds n to ``COUNTS[name]``
    recording()     a context manager that turns spans on
    totals()        {name: {"count", "seconds", "self_s"}} of the spans
                    recorded
    reset()         clears the counters and the totals

Counters are always on: a count is one dict add.  A span records while
``recording()`` is on or a ``torch.profiler`` runs, and is a shared null
context otherwise (a flag test and the profiler's own flag).  A recorded
span adds its ``perf_counter_ns`` duration to its name's totals and its
self time, the duration less what its child spans cover; totals are kept
per name, so their size is bounded by the number of names, not of spans.
Under a profiler the span also opens a ``torch.profiler.record_function``
of its name, so it lands in the trace as a user annotation on the clock
the device's events are aligned to.  Spans nest on the thread that opens
them; the port opens them on its main thread only.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

_T0 = time.time()

COUNTS: dict[str, int] = {}
# name -> [spans, nanoseconds, self nanoseconds]
_TOTALS: dict[str, list[int]] = {}
# the open recorded spans, innermost last
_OPEN: list["_Span"] = []
_RECORDING = False
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "start", "children", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if _profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.children = 0
        _OPEN.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self.start
        _OPEN.pop()
        if _OPEN:
            _OPEN[-1].children += took
        total = _TOTALS.setdefault(self.name, [0, 0, 0])
        total[0] += 1
        total[1] += took
        total[2] += took - self.children
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A span of `name` while recording or profiling, else a null
    context.  Names are the port's own: never ``window``, ``unit`` or
    ``apply``."""
    if _RECORDING or _profiling():
        return _Span(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Spans record inside the block, profiler or not."""
    global _RECORDING
    was, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = was


def totals() -> dict[str, dict]:
    """Per span name: spans recorded, their seconds, and their self
    seconds (less what child spans cover)."""
    return {name: {"count": n, "seconds": ns / 1e9, "self_s": own / 1e9}
            for name, (n, ns, own) in _TOTALS.items()}


def reset() -> None:
    COUNTS.clear()
    _TOTALS.clear()


class ProgressIndicator:
    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream or sys.stderr

    def __call__(self, msg: str):
        t = time.time() - _T0
        self.stream.write(f"{self.name} [{t:.2f}]: {msg}\n")

    @contextlib.contextmanager
    def phase(self, label: str):
        """Logs the phase's start and its seconds, and is a span of
        `label`."""
        self(f"{label} starting")
        t0 = time.perf_counter()
        with span(label):
            yield
        self(f"{label} done in {time.perf_counter() - t0:.3f}s")
