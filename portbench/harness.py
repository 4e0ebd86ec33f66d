"""One run of one cell: set-up, the measured window, the check, the line.

Set-up builds the configuration's sector through the port (its
builds/<build>.py) and runs one warm-up unit of the cell's mix (its
units/<kind>.py).  The window is a
closed loop with one client: a unit starts when the one before it has
ended, units start while less than ``seconds`` have passed, and the window
closes at the end of the last unit that started inside it.  Device memory
is read at the close; then the program's state is freed and the plain
reference (``reference/``) is built on the card to hold the window's
answers against the cell's limits (limits/<workload>.json).  With
``trace`` the sector is seen through ``sector.SpannedHamiltonian``, the
units that start in the window's first ``tracing.TRACE_SECONDS`` run under
``torch.profiler``; the units after those run on the sector itself, as in
a run without a trace.  The cell's per-layer metrics are read from the
trace, from the untraced part of the window and from the whole window
(metrics/<metric>.py); without a trace the end-to-end metrics are
reported.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch

from portbench import device as card, sector, tracing, work
from portbench import reference as ref


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(name: str, on: bool):
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        started: float) -> dict:
    """The result line's object.  `started`: ``time.perf_counter()`` at
    the start of the process."""
    from lanczosplusplus_tpu_torch.ops import kernels

    on_card = dev.type == "cuda"
    marks = [time.perf_counter()]
    if on_card:
        torch.zeros(1, device=dev)
    marks.append(time.perf_counter())
    sample = card.smi() if on_card else {}
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    log(f"card {kind}, nvidia-smi before the window {sample}")

    ham, build_s = cell.build(dev)
    dtype = ham.dtype
    log(f"sector {cell.config['name']}: dim {ham.dim}, {dtype}, built "
        f"in {build_s:.3f} s")
    marks.append(time.perf_counter())
    job = cell.units(ham, seed)
    job.warm_up()
    _sync(dev)
    marks.append(time.perf_counter())
    log(f"set-up: imports {marks[0] - started:.3f} s, card start "
        f"{marks[1] - marks[0]:.3f} s, card sample and build "
        f"{marks[2] - marks[1]:.3f} s, warm-up {marks[3] - marks[2]:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    spanned = sector.SpannedHamiltonian(ham) if trace else None
    if trace:
        job.ham = spanned
    traced_for = min(seconds, tracing.TRACE_SECONDS) if trace else 0.0
    prof = tracing.profiler() if trace else None

    span = None
    traced_rows = 0
    # (clock, units, counts) once the profiler has stopped
    resumed = None
    if prof is not None:
        # the profiler takes seconds to start: before the window's clock
        prof.start()
        span = torch.profiler.record_function(tracing.WINDOW_SPAN)
        span.__enter__()
    unit_s = []
    unit_at = []
    start = time.perf_counter()
    setup_s = start - started
    while True:
        t = time.perf_counter()
        with _span(tracing.UNIT_SPAN, span is not None):
            job.run(len(unit_s))
        _sync(dev)
        now = time.perf_counter()
        unit_s.append(now - t)
        unit_at.append(t - start)
        if span is not None and now - start >= traced_for:
            span.__exit__(None, None, None)
            prof.stop()
            span = None
            traced_rows = spanned.rows
            job.ham = ham
            resumed = (time.perf_counter(), len(unit_s), job.counts())
        if now - start >= seconds:
            break
    window_s = now - start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = dict(kernels.FORM_LAUNCHES)
    traced = tracing.read(prof) if trace else None
    counts = job.counts()
    attempted = len(unit_s)
    spread = sorted(unit_s)
    slowest = sorted(range(attempted), key=unit_s.__getitem__)[-5:]
    log(f"window {window_s!r} s, {attempted} units: min "
        f"{spread[0]:.4f}, median {spread[attempted // 2]:.4f}, max "
        f"{spread[-1]:.4f} s; slowest (unit, start s, seconds) "
        f"{[(i, round(unit_at[i], 3), round(unit_s[i], 4)) for i in slowest]}"
        f"; {counts}; launches {launches}; peak {peak} bytes (set-up "
        f"{setup_peak})")
    after = card.smi() if on_card else {}
    log(f"nvidia-smi after the window {after}")

    job.release()
    del ham, spanned
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = ref.sector(cell.config["reference"],
                           sector.input_text(cell.config), dev)
    t = time.perf_counter()
    numbers, failed, lines = job.numbers(reference, cell.limits)
    for line in lines:
        log(line)
    log(f"reference check {time.perf_counter() - t:.3f} s")

    device = {"platform": "gpu" if on_card else "cpu", "kind": kind,
              "count": cell.workload["chips"],
              "memory_peak_bytes": max(peak, setup_peak),
              "power_limit_w": card.power_limit_w(sample)}
    breakdown = None
    if trace:
        least = work.least_s(traced_rows, work.per_row(
            reference.dim, reference.nonzeros(), dtype), kind, dtype)
        untraced = None
        if resumed is not None and attempted > resumed[1]:
            clock, units, before = resumed
            untraced = {"seconds": now - clock,
                        "units": attempted - units,
                        **{k: v - before[k] for k, v in counts.items()}}
        # what a reader (metrics/<metric>.py) may read
        context = {"metric": cell.traffic["metric"], "window_s": window_s,
                   "units": attempted, "build_s": build_s,
                   "trace": traced, "least_apply_s": least,
                   "untraced": untraced, "launches": launches, **counts}
        shown = {k: v for k, v in (traced or {}).items() if k != "breakdown"}
        log(f"trace {shown}; rows applied in it {traced_rows}, least time "
            f"of their applies {least}; untraced part {untraced}")
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"])(context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced:
            device.update(busy_s=traced["busy_s"],
                          window_s=traced["window_s"])
            breakdown = traced["breakdown"]
    else:
        values = {"setup_s": setup_s,
                  cell.traffic["metric"]: window_s / attempted}
        if on_card:
            values["peak_device_gb"] = peak / 1e9
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.metrics("end_to_end") if m["name"] in values}
    limits = cell.limits
    out = {"correct": bool(attempted > 0 and failed == 0 and all(
               numbers[k] <= limits[k] for k in limits)),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out
