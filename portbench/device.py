"""The card a run is on: what ``torch.cuda`` and ``nvidia-smi`` say."""

from __future__ import annotations

import subprocess

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm",
              "temperature.gpu")


def smi() -> dict:
    """One ``nvidia-smi`` sample of the first card, {field: text}; {} where
    the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    values = [v.strip() for v in out.splitlines()[0].split(",")]
    return dict(zip(SMI_FIELDS, values))


def power_limit_w(sample: dict):
    """The power limit in watts, or None."""
    try:
        return float(sample["power.limit"].split()[0])
    except (KeyError, ValueError, IndexError):
        return None
