#!/usr/bin/env python3
"""Where a Lanczos step of the port's 14-site Hubbard sector spends its time
on one GPU.

Run from the repository root, with one CUDA card:

    python3 profile_step.py [--spectral] [--trace-dir DIR]

It builds the half-filled 14-site periodic HubbardOneBand chain at U=4
(dim 11 778 624, two dense 3432 x 3432 float64 one-spin factors) on the
card, then traces 40 selective-reorthogonalization Lanczos steps
(``solver.lanczos.tridiagonalize``) with ``torch.profiler``, once through
the hand-written kernels and once through their plain PyTorch versions
(``chip_smoke.PlainOperator``), in the turns plain, kernel, kernel, plain.
Each turn runs 5 untraced warm-up steps first.

With ``--spectral`` it traces the batched step of the spectral path
instead: the N_up = 8, N_down = 7 sector of the same chain (dim
10 306 296, factors 3003 x 3003 and 3432 x 3432), a block of 14 random unit
rows, 10 steps of ``solver.lanczos.tridiagonalize_plain_batched`` after 2
warm-up steps, in the same turns.

For each turn it prints the host wall time of the traced steps (ending
in ``torch.cuda.synchronize()``), the device busy time and the device time
of the top kernels.  Device busy time is the length of the union of the
intervals of the trace's device events (kernels, copies, memsets), read
from ``export_chrome_trace``, so overlapping events count once; the idle
share is 1 - busy / wall.  The last line is one JSON object with every
turn's numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STEPS = 40
WARMUP_STEPS = 5
SPECTRAL_STEPS = 10
SPECTRAL_WARMUP_STEPS = 2
SPECTRAL_ROWS = 14


def device_events(trace_path: str) -> list[dict]:
    """The device-side events (kernels, copies, memsets) of a chrome
    trace written by ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(events: list[dict]) -> float:
    """Length in microseconds of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def by_name_ms(events: list[dict], top: int) -> dict[str, float]:
    """Device milliseconds per event name, the `top` largest."""
    sums: dict[str, float] = {}
    for e in events:
        sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e3
    return dict(sorted(sums.items(), key=lambda kv: -kv[1])[:top])


def profile_turn(run, steps: int, warmup: int, trace_path: str) -> dict:
    """Trace ``run(steps)`` after an untraced ``run(warmup)``."""
    from torch.profiler import ProfilerActivity, profile

    run(warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    prof.export_chrome_trace(trace_path)
    events = device_events(trace_path)
    if not events:
        raise RuntimeError("the trace holds no device events")
    busy_ms = busy_us(events) / 1e3
    idle = 1.0 - busy_ms / wall_ms
    if not 0.0 <= idle <= 1.0:
        raise RuntimeError(f"idle share {idle} outside [0, 1]: busy "
                           f"{busy_ms} ms, wall {wall_ms} ms")
    return dict(steps=steps, wall_ms=wall_ms, ms_per_step=wall_ms / steps,
                device_busy_ms=busy_ms, idle_share=idle,
                device_events=len(events),
                top_device_ms=by_name_ms(events, 8))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spectral", action="store_true",
                        help="trace the batched step of the spectral path")
    parser.add_argument("--trace-dir", default=None,
                        help="keep the chrome traces here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from chip_smoke import SEED, PlainOperator, hubbard_chain_text
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t = time.perf_counter()
    inp = parse_input(hubbard_chain_text(14, 4))
    model = build_model(inp, Geometry(inp))
    parts = (8, 7) if args.spectral else model.default_parts(inp)
    ham = model.hamiltonian(model.create_basis(parts), dtype=torch.float64,
                            device=dev)
    ham = ham.densify_factors()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    print(f"Hamiltonian build and densify: {build_s:.3f} s, dim {ham.dim}",
          flush=True)
    ops = {"kernel": ham, "plain": PlainOperator(ham)}
    if args.spectral:
        v0 = torch.stack([
            lz.random_start_vector(ham.dim, SEED + r, torch.float64, dev)
            for r in range(SPECTRAL_ROWS)])
        steps, warmup = SPECTRAL_STEPS, SPECTRAL_WARMUP_STEPS
        recurrence = lz.tridiagonalize_plain_batched
    else:
        v0 = lz.random_start_vector(ham.dim, SEED, torch.float64, dev)
        steps, warmup = STEPS, WARMUP_STEPS
        recurrence = lz.tridiagonalize

    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for i, path in enumerate(("plain", "kernel", "kernel", "plain")):
            r = profile_turn(
                lambda n, op=ops[path]: recurrence(op, v0, n), steps, warmup,
                os.path.join(trace_dir, f"turn{i}_{path}.json"))
            r["path"] = path
            turns.append(r)
            print(f"{path}: {r['steps']} steps, wall {r['wall_ms']:.3f} ms, "
                  f"{r['ms_per_step']:.3f} ms/step, device busy "
                  f"{r['device_busy_ms']:.3f} ms, idle share "
                  f"{r['idle_share']:.4f}", flush=True)
            for name, ms in r["top_device_ms"].items():
                print(f"  {ms:10.3f} ms  {name[:100]}", flush=True)
    print(json.dumps({"card": smi, "spectral": args.spectral,
                      "build_s": build_s, "turns": turns}),
          flush=True)


if __name__ == "__main__":
    main()
