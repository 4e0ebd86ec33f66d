"""The `sqomega` command line: S(q, omega) and N(i, omega).

Counterpart of ``lanczosplusplus_tpu/cli/sqomega_main.py`` (it replaces
scripts/sqomega.pl and scripts/niomega.pl and runs the whole pipeline
in-process, on the card unless ``--device cpu`` is given):

  python -m lanczosplusplus_tpu_torch.cli.sqomega_main -f input.inp
         -b OMEGA0 -e OMEGA1 -s STEP -d DELTA [-g op] [--spin s]
         [--dos | --beta BETA] [--dtype float64|float32]

It prints one line an omega: the intensity -Im S(q, omega)/pi of every
momentum (T = 0, from the ground state's continued fractions), N(i,
omega) of every site with ``--dos``, or the finite-temperature S(q,
omega) of a sector-preserving operator by the FTLM double-Krylov
estimator with ``--beta`` (FTLMVectors, default 16; FTLMSteps, 100).
"""

from __future__ import annotations

import argparse

import numpy as np

from lanczosplusplus_tpu_torch import postproc
from lanczosplusplus_tpu_torch.cli import add_dtype_option, real_dtype
from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model


def run(argv=None):
    p = argparse.ArgumentParser(prog="sqomega++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-g", dest="observable", default="sz")
    p.add_argument("-b", dest="wbegin", type=float, required=True)
    p.add_argument("-e", dest="wend", type=float, required=True)
    p.add_argument("-s", dest="wstep", type=float, required=True)
    p.add_argument("-d", dest="wdelta", type=float, required=True)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    add_dtype_option(p)
    p.add_argument("--dos", action="store_true",
                   help="N(i, omega) per site instead of S(q, omega)")
    p.add_argument("--beta", type=float, default=None,
                   help="finite-temperature S(q, omega) at this inverse "
                        "temperature via the FTLM double-Krylov "
                        "estimator (sector-preserving observables; "
                        "labels FTLMVectors/FTLMSteps)")
    args = p.parse_args(argv)

    inp = read_input(args.input)
    validate_input(inp)
    model = build_model(inp, Geometry(inp))
    engine = Engine(model, inp,
                    config=Config.from_input(inp, device=args.device,
                                            real_dtype=real_dtype(args)))
    omegas = np.arange(args.wbegin, args.wend + 1e-12, args.wstep)
    if args.beta is not None:
        qs, sqw = engine.ftlm_sq_omega(
            args.observable, args.beta, omegas, delta=args.wdelta,
            spin=args.spin,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=100))
        print(f"#beta={args.beta} method=FTLM")
        for wi, w in enumerate(omegas):
            print(w, " ".join(f"{sqw[m, wi]:.8g}"
                              for m in range(len(qs))))
        return qs, sqw
    if args.dos:
        dos = postproc.ni_omega(engine, omegas, args.wdelta,
                                spin=args.spin)
        for wi, w in enumerate(omegas):
            print(w, " ".join(f"{dos[i, wi]:.8g}"
                              for i in range(dos.shape[0])))
        return dos
    qs, sqw = postproc.sq_omega(engine, args.observable, omegas,
                                args.wdelta, spin=args.spin)
    intensity = -sqw.imag / np.pi
    for wi, w in enumerate(omegas):
        print(w, " ".join(f"{intensity[m, wi]:.8g}"
                          for m in range(len(qs))))
    return qs, sqw


def main():
    run()


if __name__ == "__main__":
    main()
