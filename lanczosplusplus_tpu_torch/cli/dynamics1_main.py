"""The `dynamics1` command line (reference: src/dynamics1.cpp): the
continued fraction of |phi> = sum_site e^{ik site}
(c^dag_{a,up} c_{b,up})_site |gs>, written with the SPECTRAL tag.

Counterpart of ``lanczosplusplus_tpu/cli/dynamics1_main.py``:

  python -m lanczosplusplus_tpu_torch.cli.dynamics1_main -f input.inp
         [-r m] [--orbs a,b] [--device cuda|cpu]

It prints ``Energy=`` and the fraction in the .comb layout.
"""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.dynamics import dynamics1_spectral
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFractionCollection)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model


def run(argv=None):
    p = argparse.ArgumentParser(prog="dynamics1++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-r", dest="m_for_k", type=int, default=0,
                   help="momentum index (reference reuses -r)")
    p.add_argument("--orbs", default="0,1")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    args = p.parse_args(argv)
    inp = read_input(args.input)
    validate_input(inp)
    model = build_model(inp, Geometry(inp))
    engine = Engine(model, inp,
                    config=Config.from_input(inp, device=args.device))
    print(f"Energy={engine.ground_energy:.8g}")
    orbs = tuple(int(x) for x in args.orbs.split(","))
    cf = dynamics1_spectral(engine, args.m_for_k, orbs=orbs)
    coll = ContinuedFractionCollection([cf])
    coll.write(sys.stdout, index_to_cf=["SPECTRAL"])
    return cf


def main():
    run()


if __name__ == "__main__":
    main()
