"""Readings that set a cell's correctness limits, on the card at the cell's
own size, in one process:

    python3 portbench/control.py --workload W --first-seed S [--seeds 12]
                                 [--units 2] [--control-seeds 3]

It builds the cell's sector once and the plain reference beside it.  For
each of `seeds` seeds it runs `units` units of the cell's mix as a run
does (the same inputs from the seed, the same kept answers) and holds them
against the reference: the program's readings, whose largest is a limit's
lower reading.  Then the control, for `control-seeds` more seeds: the
port's own float32 path in the program's place (the float64 sector's
``ops/refine.narrowed`` copy, as ``--dtype float32`` solves it, the ground
state's energy refined against the float64 form), whose smallest reading
is a limit's upper one.  The benchmark's runs never run this.  The last
line is one JSON object with every reading.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, ham, reference, seeds, units_per_seed: int,
             refine=True, log=print) -> dict:
    """{number: [reading of each seed]} of `units_per_seed` units a seed
    on `ham`."""
    out: dict[str, list] = {}
    for n, seed in enumerate(seeds):
        job = cell.units(ham, seed, refine)
        if n == 0:
            job.warm_up()
        t = time.perf_counter()
        for i in range(units_per_seed):
            job.run(i)
        unit_s = (time.perf_counter() - t) / units_per_seed
        numbers, failed, lines = job.numbers(reference, cell.limits)
        for k, v in numbers.items():
            out.setdefault(k, []).append(v)
        log(f"seed {seed}: {numbers}, units failed {failed}, "
            f"{unit_s:.4f} s a unit; {lines[0][:300]}")
        del job
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--units", type=int, default=2)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from lanczosplusplus_tpu_torch.ops import refine as R
    from portbench import reference as ref, sector
    from portbench.layout import Cell

    def log(line):
        print(line, flush=True)

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = Cell(args.workload)
    ham, build_s = cell.build(dev)
    reference = ref.sector(cell.config["reference"],
                           sector.input_text(cell.config), dev)
    log(f"{cell.name}: {torch.cuda.get_device_name(dev)}; built in "
        f"{build_s:.3f} s; limits {cell.limits}")
    seeds = [args.first_seed + i for i in range(args.seeds)]
    program = readings(cell, ham, reference, seeds, args.units, log=log)
    log("control: the float32 path")
    control_seeds = [args.first_seed + args.seeds + i
                     for i in range(args.control_seeds)]
    control = readings(cell, R.narrowed(ham), reference, control_seeds,
                       args.units, refine=ham, log=log)
    summary = {"workload": cell.name, "seeds": seeds,
               "control_seeds": control_seeds, "program": program,
               "control": control,
               "lower": {k: max(v) for k, v in program.items()},
               "upper": {k: min(v) for k, v in control.items()},
               "seconds": time.perf_counter() - STARTED}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
