"""The `quasiparticleWeightZ` command line (reference:
src/quasiparticleWeightZ.cpp): Z(k) = |<gs_{N-1}| c_k |gs_N>|^2 for all
momenta.

Counterpart of ``lanczosplusplus_tpu/cli/qpz_main.py``:

  python -m lanczosplusplus_tpu_torch.cli.qpz_main -f input.inp
         [--spin s] [--ratio] [--device cuda|cpu]
         [--dtype float64|float32]

It prints one line ``k Z(k)`` a momentum.
"""

from __future__ import annotations

import argparse

from lanczosplusplus_tpu_torch.cli import add_dtype_option, real_dtype
from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.dynamics import quasiparticle_weight_z
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model


def run(argv=None):
    p = argparse.ArgumentParser(prog="quasiparticleWeightZ++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--ratio", action="store_true",
                   help="normalize by <phi_k|phi_k>")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    add_dtype_option(p)
    args = p.parse_args(argv)
    inp = read_input(args.input)
    validate_input(inp)
    model = build_model(inp, Geometry(inp))
    engine = Engine(model, inp,
                    config=Config.from_input(inp, device=args.device,
                                            real_dtype=real_dtype(args)))
    out = quasiparticle_weight_z(engine, spin=args.spin, ratio=args.ratio)
    for k, z in out:
        print(f"{k} {z}")
    return out


def main():
    run()


if __name__ == "__main__":
    main()
