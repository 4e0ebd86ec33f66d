"""The port's own spans and counters (its ``utils/progress``), as a
reader of a per-layer metric finds them once the run has ended.

Counters are always on, so ``COUNTS`` holds the whole run's: the warm-up
unit's and the window's (set-up applies nothing).  A span records while
a profiler runs, so the span totals of a ``--trace 1`` run are those of
its traced part.  A port without these gives None, and so does every
metric that reads them.
"""

from __future__ import annotations


def _progress():
    from lanczosplusplus_tpu_torch.utils import progress

    return progress


def counts() -> dict | None:
    """The port's counters, or None."""
    return getattr(_progress(), "COUNTS", None)


def totals() -> dict | None:
    """{span name: {"count", "seconds", "self_s"}} of the port, or None."""
    read = getattr(_progress(), "totals", None)
    return read() if read is not None else None


def per(context: dict, moves: str, counter: str, base: str):
    """``counter`` over ``base`` over the run, in cells that report
    `moves`; None without the counters or a base."""
    found = counts()
    if context["metric"] != moves or not found or not found.get(base):
        return None
    return found.get(counter, 0) / found[base]


def share_percent(context: dict, moves: str, part: str, whole: str):
    """100 x the seconds of the `part` spans over those of the `whole`
    spans, in cells that report `moves`; None where no `whole` span was
    recorded."""
    found = totals()
    if context["metric"] != moves or not found \
            or not found.get(whole, {}).get("seconds"):
        return None
    return (100.0 * found.get(part, {"seconds": 0.0})["seconds"]
            / found[whole]["seconds"])
