"""The `thermal` command line: grand-canonical averages and correlator
poles.

Counterpart of ``lanczosplusplus_tpu/cli/thermal_main.py``.  It replaces
the reference's dumpmatrix -> grandCanonical.pl -> thermal pipeline
(reference: src/thermal.cpp:232-314 CLI: -f file -c operator -b beta
-s site1[,site2] [-m mu] [-C constant]) with an in-process sector sweep:
the input file defines the model, and every (nup, ndown) sector is
diagonalized on the card (``--device cpu`` for the CPU):

  python -m lanczosplusplus_tpu_torch.cli.thermal_main -f input.inp -b BETA
         [-c op -s i[,j] --spin s] [-m mu] [-C constant] [--ftlm]

It prints density, energy and the partition function to stderr, and with
``-c`` the correlator's poles (omega weight) to stdout.  ``--ftlm``
estimates each large sector by FTLM (FTLMVectors, default 16; FTLMSteps,
60; SolverOptions=factored for a model's factored form) and prints
density, energy and specific heat with ln Z.
"""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu_torch.engine.thermal import GrandCanonical
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model


def run(argv=None):
    p = argparse.ArgumentParser(prog="thermal++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-c", dest="operator", default="i",
                   help="operator name or 'i' for Z/density/energy only")
    p.add_argument("-b", dest="beta", type=float, required=True)
    p.add_argument("-s", dest="sites", default="0",
                   help="site1[,site2]")
    p.add_argument("-m", dest="mu", type=float, default=0.0)
    p.add_argument("-C", dest="constant", type=float, default=0.0)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    p.add_argument("--ftlm", action="store_true",
                   help="estimate the sector sweep by FTLM (per-sector "
                        "stochastic ln Z and <E>) instead of full "
                        "spectra; Z/density/energy only (correlator "
                        "poles need the full spectra)")
    args = p.parse_args(argv)

    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    name = inp.string("Model")
    kind = {"TjMultiOrb": "tj", "Heisenberg": "heisenberg"}.get(
        name, "hubbard")
    if args.ftlm:
        if args.operator != "i":
            p.error("--ftlm supports Z/density/energy only "
                    "(correlator poles need the full spectra)")
        from lanczosplusplus_tpu_torch.engine.thermal import (
            GrandCanonicalFTLM)
        gf = GrandCanonicalFTLM(
            model, geometry.number_of_sites(), [args.beta], kind=kind,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=60),
            factored="factored" in inp.solver_options(),
            device=args.device)
        lnz = gf.log_partition(args.beta, args.mu, args.constant)
        print(f"density={gf.density(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        print(f"energy={gf.energy(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        print(f"cv={gf.specific_heat(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        return gf
    gc = GrandCanonical(model, geometry.number_of_sites(), kind=kind,
                        device=args.device)
    z = gc.partition(args.beta, args.mu, args.constant)
    print(f"density={gc.density(args.beta, args.mu, args.constant)} "
          f"zPartition={z}", file=sys.stderr)
    print(f"energy={gc.energy(args.beta, args.mu, args.constant)} "
          f"zPartition={z}", file=sys.stderr)
    if args.operator != "i":
        sites = [int(x) for x in args.sites.split(",")]
        if len(sites) == 1:
            sites = [sites[0], sites[0]]
        poles, total = gc.correlation_poles(
            args.operator, tuple(sites), args.spin, args.beta, args.mu,
            args.constant)
        for om, w in poles:
            print(f"{om} {w}")
        print(f"operator={args.operator} beta={args.beta} mu={args.mu} "
              f"partition={z} sum={total}", file=sys.stderr)
    return gc


def main():
    run()


if __name__ == "__main__":
    main()
