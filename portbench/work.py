"""The least time the card could take for the Hamiltonian applies of a
window, whatever implements them (dense GEMMs, gathers, an ELL, a
matrix-free form):

    bytes   the state read once and written once, for each row applied
    flops   2 per nonzero entry of H, for each row applied

and the least time is the larger of bytes over the card's bandwidth and
flops over its peak in the state's type (``peaks.json``, the published
rates).  The type and its size are the built Hamiltonian's; a card or a
type missing from the table gives no reading.  The nonzero entries are
counted by the plain reference on its own build of the sector
(``Sector.nonzeros``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def per_row(dim: int, nonzeros: int, dtype: torch.dtype) -> dict:
    """Bytes and flops of applying H, in `dtype`, to one row."""
    return {"bytes": 2 * dim * dtype.itemsize, "flops": 2 * nonzeros}


def least_s(rows: int, work: dict, card: str, dtype: torch.dtype):
    """(least seconds of `rows` applies, which bound sets it), or None for
    a card, or a type on it, missing from the table of peaks."""
    peaks = PEAKS.get(card)
    flops_per_s = peaks and peaks["flops_per_s"].get(
        str(dtype).removeprefix("torch."))
    if not flops_per_s:
        return None
    by_bytes = rows * work["bytes"] / peaks["bytes_per_s"]
    by_flops = rows * work["flops"] / flops_per_s
    return ((by_bytes, "bytes") if by_bytes >= by_flops
            else (by_flops, "flops"))


def roofline_percent(context: dict, moves: str):
    """100 x the least time of the window's applies over the device time
    of the kernels launched inside them, in cells that report `moves`;
    None where the trace or the table of peaks has nothing to read."""
    trace = context.get("trace")
    least = context.get("least_apply_s")
    if context["metric"] != moves or not trace or not least \
            or not trace["apply_device_s"]:
        return None
    return 100.0 * least[0] / trace["apply_device_s"]
