#!/usr/bin/env python3
"""Where a Lanczos step of the port's 14-site Hubbard sector, or of one of
its flat models, spends its time on one GPU.

Run from the repository root, with one CUDA card:

    python3 profile_step.py [--spectral | --flat MODEL] [--trace-dir DIR]

It builds the half-filled 14-site periodic HubbardOneBand chain at U=4
(dim 11 778 624, two dense 3432 x 3432 float64 one-spin factors) on the
card, then traces 40 selective-reorthogonalization Lanczos steps
(``solver.lanczos.tridiagonalize``) with ``torch.profiler``, once through
the hand-written kernels and once through their plain PyTorch versions
(``chip_smoke.PlainForm``), in the turns plain, kernel, kernel, plain.
Each turn runs 5 untraced warm-up steps first.

With ``--spectral`` it traces the batched step of the spectral path
instead: the N_up = 8, N_down = 7 sector of the same chain (dim
10 306 296, factors 3003 x 3003 and 3432 x 3432), a block of 14 random unit
rows, 10 steps of ``solver.lanczos.tridiagonalize_plain_batched`` after 2
warm-up steps, in the same turns.

With ``--flat MODEL`` it traces the ground-state step of a flat model at
full width instead, built as ``chip_smoke.py`` phase 9 builds it:
``heisenberg24`` (24-site ring, dim 2 704 156, ELL K = 48), ``tj18``
(18-site t-J ring, 8 up 8 down, dim 1 969 110, K = 54), ``rashba12`` and
``rashba13`` (Rashba rings at one electron a site in complex128, dim
2 704 156 with K = 96 and dim 10 400 600 with K = 104) and ``feas8`` (the
8-site two-orbital FeAs sector, dim 3 312 400, two 1820 x 1820 factors and
an ELL of K = 16).  The host's build of the arrays is timed apart.  Where
the plain version's gather intermediates (four times the ELL's values)
would not fit the card's free memory, only the kernel turns run.  The
names ending in ``f`` trace the factored form that SolverOptions=factored
solves instead (``chip_smoke.py`` phase 10), in its inner block order:
``tj18f`` and ``rashba13f`` (half-cut block-Kronecker forms: within-block
and tier products through ``factor_matmul``, the cut-crossing terms one
``perm_gather`` each), ``heis24f`` (half-cut Sz blocks) and ``kitaev24f``
(the 24-site Kitaev ring of bench.py, dim 16 777 216, two 4096-wide
halves); their plain turns run the same form through the kernels' plain
versions, and the launches of one matvec are printed.

With ``--gather`` it times the ``perm_gather`` cases of ``chip_smoke.py``
phase 10 and nothing else, through ``chip_smoke.perm_gather_case`` (each
case bit-equal to the plain version, then kernel, cuSPARSE ``csr @ x``,
plain version and bound): the 14-site one-spin up and dn forms at R = 1
and R = 14, and the largest PermCrossTerm of the 18-site t-J, 13-site
Rashba, 8-site FeAs and 7-site FeAs spin-orbit factored forms.  It takes about a minute of command time.

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
# --flat MODEL -> (function of chip_smoke.py that writes its input, arguments)
FLAT_MODELS = {"heisenberg24": ("heisenberg_ring_text", (24,)),
               "tj18": ("tj_ring_text", (18, 8, 8)),
               "rashba12": ("rashba_ring_text", (12, 12)),
               "rashba13": ("rashba_ring_text", (13, 13)),
               "feas8": ("feas_ring_text", (8, 4, 4)),
               # factored forms (SolverOptions=factored)
               "tj18f": ("tj_ring_text", (18, 8, 8)),
               "heis24f": ("heisenberg_ring_text", (24,)),
               "rashba13f": ("rashba_ring_text", (13, 13, "0.5", "none")),
               "kitaev24f": ("kitaev_ring_text", (24,))}
# --gather: the factored forms whose largest PermCrossTerm is timed, as
# chip_smoke.py phase 10 names them (label, function writing the input,
# its arguments)
GATHER_FORMS = (("18-site t-J", "tj_ring_text", (18, 8, 8)),
                ("13-site Rashba half-cut", "rashba_ring_text",
                 (13, 13, "0.5", "none")),
                ("8-site FeAs interaction", "feas_ring_text", (8, 4, 4)),
                ("7-site FeAs spin-orbit", "feas_spinorbit_chain_text",
                 (7, 4, 3)))
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


def gather_cases(dev) -> list:
    """(case label, x, y0, tables) of every ``perm_gather`` case of
    ``--gather``, on random blocks from the script's seed."""
    import chip_smoke
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    inp = parse_input(chip_smoke.hubbard_chain_text(14, 4))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            dtype=torch.float64, device=dev)
    cases = list(chip_smoke.one_spin_gather_cases(
        gen, ham.densify_factors(max_bytes=0), "14-site"))
    for name, writer, numbers in GATHER_FORMS:
        t = time.perf_counter()
        form = factored_form(getattr(chip_smoke, writer)(*numbers), dev)
        case, src, dst, tables = chip_smoke.largest_cross_term(form, name)
        print(f"{name}: factored build {time.perf_counter() - t:.3f} s",
              flush=True)
        cases.append((case, torch.randn(src, generator=gen, device=dev,
                                        dtype=form.dtype),
                      torch.randn(dst, generator=gen, device=dev,
                                  dtype=form.dtype), tables))
        del form
    return cases


def gather_main(smi: str) -> None:
    """--gather: time perm_gather on phase 10's cases; the last line is
    one JSON object."""
    import chip_smoke

    dev = torch.device("cuda:0")
    results = {"perm_gather": []}
    for case, x, y0, tables in gather_cases(dev):
        amps = [t for t in (tables.get("a"), tables.get("beta"))
                if t is not None]
        live = [float((t != 0).double().mean()) for t in amps]
        print(f"{case}: share of nonzero amplitudes in the row and column "
              f"tables {live}", flush=True)
        chip_smoke.perm_gather_case(results, case, x, y0, tables)
    print(json.dumps({"card": smi, "gather": results["perm_gather"]}),
          flush=True)


def factored_form(text: str, dev):
    """The factored form SolverOptions=factored solves for an input, in
    its inner block order, built on `dev` as the Engine builds it."""
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.factored import (
        factored_hamiltonian_or_none)
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    ham = factored_hamiltonian_or_none(
        model, model.create_basis(parts), parts,
        Config.from_input(inp, device=dev).scalar_dtype, device=dev)
    return getattr(ham, "inner", ham)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--spectral", action="store_true",
                       help="trace the batched step of the spectral path")
    which.add_argument("--flat", choices=sorted(FLAT_MODELS), default=None,
                       help="trace the ground-state step of this flat model")
    which.add_argument("--gather", action="store_true",
                       help="time perm_gather on chip_smoke.py phase 10's "
                            "cases")
    parser.add_argument("--trace-dir", default=None,
                        help="keep the chrome traces here")
    return parser.parse_args(argv)


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    import chip_smoke
    from chip_smoke import SEED, PlainForm, hubbard_chain_text
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.ops import kernels
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.gather:
        gather_main(smi)
        return

    t = time.perf_counter()
    text = hubbard_chain_text(14, 4)
    if args.flat:
        writer, numbers = FLAT_MODELS[args.flat]
        text = getattr(chip_smoke, writer)(*numbers)
    factored = bool(args.flat) and args.flat.endswith("f")
    if factored:
        ham = factored_form(text, dev)   # solved in its block order
    else:
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        parts = (8, 7) if args.spectral else model.default_parts(inp)
        ham = model.hamiltonian(
            model.create_basis(parts), device=dev,
            dtype=Config.from_input(inp, device=dev).scalar_dtype)
        ham = ham.densify_factors()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    ell = getattr(ham, "ell", None)
    width = ell.cols.shape[1] if ell is not None else 0
    print(f"Hamiltonian build{'' if factored else ' and densify'}: "
          f"{build_s:.3f} s, dim {ham.dim}, {ham.dtype}, "
          + (type(ham).__name__ if factored else f"ELL K {width}"),
          flush=True)
    kernels.reset_launches()
    ham.matvec(torch.zeros(ham.dim, dtype=ham.dtype, device=dev))
    launches = dict(kernels.LAUNCHES)
    print(f"launches of one matvec: {launches}", flush=True)
    ops = {"kernel": ham, "plain": PlainForm(ham)}
    paths = ("plain", "kernel", "kernel", "plain")
    if ell is not None and 4 * ell.vals.numel() \
            * ell.vals.element_size() > torch.cuda.mem_get_info(dev)[0]:
        paths = ("kernel", "kernel")
        print("the plain version's intermediates do not fit: kernel turns "
              "only", flush=True)
    if args.spectral:
        v0 = torch.stack([
            lz.random_start_vector(ham.dim, SEED + r, torch.float64, dev)
            for r in range(SPECTRAL_ROWS)])
        steps, warmup = SPECTRAL_STEPS, SPECTRAL_WARMUP_STEPS
        recurrence = lz.tridiagonalize_plain_batched
    else:
        v0 = lz.random_start_vector(ham.dim, SEED, ham.dtype, dev)
        steps, warmup = STEPS, WARMUP_STEPS
        recurrence = lz.tridiagonalize

    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for i, path in enumerate(paths):
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
                      "flat": args.flat, "dim": ham.dim, "build_s": build_s,
                      "launches_per_matvec": launches,
                      "peak_device_gb":
                          torch.cuda.max_memory_allocated(dev) / 1e9,
                      "turns": turns}),
          flush=True)


if __name__ == "__main__":
    main()
