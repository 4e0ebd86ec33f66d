"""What the device did in a traced window, from ``torch.profiler``.

The profiler's events are read in memory (``kineto_results.events()``),
so a traced run writes no trace file.  Device busy time is the length of
the union of the device events' intervals (kernels, copies, memsets) inside
the window, so overlapping events count once; the idle share is 1 - busy /
window (the union and the sums by name follow ``profile_step.py``'s
``busy_us`` and ``by_name_ms``).  A device event belongs to the
harness's ``apply`` span when the host call that launched it (a ``cu*`` call of
the CUDA runtime or of libcuda, with the same correlation id) started
inside one.  Each idle gap is named by what the host was doing: the
innermost host op around the gap's middle, or, where only the harness's
own spans cover it, the host op that ended last before the gap.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

WINDOW_SPAN = "window"
APPLY_SPAN = "apply"
UNIT_SPAN = "unit"
HARNESS_SPANS = (WINDOW_SPAN, UNIT_SPAN, APPLY_SPAN)
TOP = 10
# a traced run traces the units that start in its window's first seconds,
# which bounds the trace's events and the time to read them
TRACE_SECONDS = 10.0


def profiler():
    """A profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA" and not e.is_user_annotation()


def union_s(intervals) -> tuple[float, list]:
    """(length of the union of the (start, end) ns intervals in seconds,
    the union's gaps as (start, end))."""
    total, end, gaps = 0, None, []
    for start, stop in sorted(intervals):
        if end is None or start > end:
            if end is not None:
                gaps.append((end, start))
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e9, gaps


def _host_ops(events, main_thread) -> list:
    """(start, end, name) of the main thread's host events, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.device_type().name == "CPU"
                  and e.start_thread_id() == main_thread)


def _name_gaps(gaps, ops) -> Counter:
    """Seconds of idle device time by what the host was doing."""
    by_host: Counter = Counter()
    starts = [op[0] for op in ops]
    ends_sorted = sorted((op[1], op[2]) for op in ops
                         if op[2] not in HARNESS_SPANS)
    end_keys = [e[0] for e in ends_sorted]
    for start, stop in gaps:
        mid = (start + stop) // 2
        inner = None
        i = bisect.bisect_right(starts, mid)
        # the covering host events end after mid; nested ones start later,
        # so the first found walking back is the innermost
        for op in reversed(ops[max(0, i - 64):i]):
            if op[1] >= mid:
                inner = op[2]
                break
        if inner is None or inner in HARNESS_SPANS:
            j = bisect.bisect_right(end_keys, start)
            inner = ("python after " + ends_sorted[j - 1][1] if j
                     else "python")
        by_host[inner] += (stop - start) / 1e9
    return by_host


def read(prof) -> dict:
    """Busy seconds, the traced window's seconds, the device time of the
    kernels launched inside ``apply`` spans, and the breakdown."""
    events = prof.profiler.kineto_results.events()
    spans = defaultdict(list)
    launches = {}
    threads: Counter = Counter()
    for e in events:
        kind = e.device_type().name
        if kind == "CPU":
            threads[e.start_thread_id()] += 1
            if e.is_user_annotation() and e.name() in HARNESS_SPANS:
                spans[e.name()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.name().startswith("cu"):
                # a call into the CUDA runtime or libcuda; host ops
                # carry correlation ids of their own, which can collide
                launches[e.correlation_id()] = e.start_ns()
    (w_start, w_end), = spans[WINDOW_SPAN]
    device = [e for e in events if _is_device(e)
              and e.start_ns() < w_end
              and e.start_ns() + e.duration_ns() > w_start]
    if not device:
        return {}
    clipped = [(max(e.start_ns(), w_start),
                min(e.start_ns() + e.duration_ns(), w_end)) for e in device]
    busy_s, gaps = union_s(clipped)
    first = min(c[0] for c in clipped)
    last = max(c[1] for c in clipped)
    gaps = [(w_start, first)] + gaps + [(last, w_end)]
    applies = sorted(spans[APPLY_SPAN])
    apply_starts = [a[0] for a in applies]
    apply_ns, unlinked = 0, 0
    by_name: Counter = Counter()
    for e in device:
        by_name[e.name()] += e.duration_ns() / 1e9
        launched = launches.get(e.correlation_id())
        if launched is None:
            unlinked += 1
            continue
        i = bisect.bisect_right(apply_starts, launched)
        if i and launched <= applies[i - 1][1]:
            apply_ns += e.duration_ns()
    ops = _host_ops(events, threads.most_common(1)[0][0])
    idle = _name_gaps([g for g in gaps if g[1] > g[0]], ops)
    return {"busy_s": busy_s, "window_s": (w_end - w_start) / 1e9,
            "apply_device_s": apply_ns / 1e9, "applies": len(applies),
            "device_events": len(device), "unlinked_events": unlinked,
            "breakdown": {"device_ops": [[n, s] for n, s in
                                         by_name.most_common(TOP)],
                          "idle_gaps": [[n, s] for n, s in
                                        idle.most_common(TOP)]}}


def idle_percent(context: dict, moves: str):
    """100 x the share of the traced window with nothing on the device, in
    cells that report `moves`; None without a trace."""
    trace = context.get("trace")
    if context["metric"] != moves or not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
