"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload W --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks
for.  Without them it exits 2 and prints no result; it never falls back to
the CPU.  The last line of standard output is the result object
(``harness.run``); the numbers the check compared, each beside its limit,
are the last lines of standard error.  A run whose process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package once the window has closed exits 3
and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the numeric libraries, set before any of them loads:
# a one-card machine shares its cores, and idle pools spinning beside the
# solver's host loop make its steps jitter
for _name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, "1")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the top-level modules a run may not hold, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "lanczosplusplus_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.layout import Cell

    cell = Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {count}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"), STARTED)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
