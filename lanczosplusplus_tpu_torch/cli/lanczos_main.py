"""The `lanczos` command line, ground-state part.

Counterpart of ``lanczosplusplus_tpu/cli/lanczos_main.py`` (reference:
src/lanczos.cpp:111-174 getopt loop; src/Engine/LanczosDriver1.h:47-214):

  python -m lanczosplusplus_tpu_torch.cli.lanczos_main -f input.inp
         [-p precision] [--device cuda|cpu]

It prints ``Energy=`` and one ``E[i]=`` line per computed state, and
runs the printmatrix/dumpmatrix oracle.  The measurement flags of the
JAX CLI are accepted and raise ``NotImplementedError`` naming the ROADMAP
item that ports them, before any work is done.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from lanczosplusplus_tpu_torch import __version__
from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model

# flag dest -> (flag, ROADMAP Queue 1 item that ports it)
_NOT_PORTED = {
    "gf": ("-g", "item 7 (spectral slice)"),
    "cicj": ("-c", "item 8 (static observables)"),
    "measure": ("-m", "item 8 (static observables)"),
    "extended_static": ("-M", "item 8 (static observables)"),
    "split": ("-r", "item 8 (static observables: RDM)"),
    "kpm": ("--kpm", "item 13 (estimators)"),
    "ftlm_beta": ("--ftlm-dos", "item 13 (estimators)"),
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lanczos++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-p", dest="precision", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda; no card "
                        "is an error, not a CPU run)")
    p.add_argument("-g", dest="gf", action="append")
    p.add_argument("-c", dest="cicj", action="append")
    p.add_argument("-m", dest="measure", action="append")
    p.add_argument("-M", dest="extended_static")
    p.add_argument("-r", dest="split", type=int)
    p.add_argument("--kpm", action="store_true", default=None)
    p.add_argument("--ftlm-dos", dest="ftlm_beta", type=float)
    p.add_argument("-V", "--version", action="version", version=__version__)
    return p


def run(argv=None):
    """Parse, validate, diagonalize and print; returns the Engine."""
    args = _parser().parse_args(argv)
    for dest, (flag, item) in _NOT_PORTED.items():
        if getattr(args, dest) is not None:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1 {item})")

    np.set_printoptions(precision=args.precision)
    inp = read_input(args.input)
    validate_input(inp)
    if inp.integer("ComputeDensityOfStates", default=0) > 0:
        raise NotImplementedError(
            "ComputeDensityOfStates is not ported yet (ROADMAP Queue 1 "
            "item 7, spectral slice)")
    config = Config.from_input(inp, device=args.device)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    engine = Engine(model, inp, config=config)

    solver_opts = inp.solver_options()
    if {"printmatrix", "dumpmatrix"} & solver_opts:
        # debug oracle path (reference: DefaultSymmetry.h:61-94): print
        # the dense Hamiltonian, assert hermiticity, full-diagonalize
        ham = engine.hamiltonian
        if ham.dim <= 4900:
            dense = ham.to_dense()
            herm = np.abs(dense - dense.T.conj()).max()
            if herm > 1e-9:
                raise SystemExit(f"matrix is not hermitian: {herm}")
            if "printmatrix" in solver_opts and ham.dim <= 40:
                print(dense)
            evals = np.linalg.eigvalsh(dense)
            print("#FullSpectrum")
            for e in evals:
                print(e)
        else:
            print("printmatrix too big", file=sys.stderr)

    prec = args.precision
    print(f"Energy={engine.ground_energy:.{prec}g}")
    for i in range(len(engine._energies)):
        v = engine.eigenvector(i)
        norm = torch.vdot(v, v).real.item()
        print(f"E[{i}]={engine.energies(i):.{prec}g} norm={norm:.{prec}g}")
    return engine


def main():
    run()


if __name__ == "__main__":
    main()
