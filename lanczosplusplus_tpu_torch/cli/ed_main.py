"""The `ed` command line: full diagonalization and the <E>(T or beta)
schedule (reference: src/ed.cpp), or its FTLM and LTLM estimates.

Counterpart of ``lanczosplusplus_tpu/cli/ed_main.py``:

  python -m lanczosplusplus_tpu_torch.cli.ed_main -f input.inp
         [--ftlm | --ltlm] [--device cuda|cpu]

The schedule comes from the TemperatureOrBeta* labels; ``--ftlm`` (or
SolverOptions=ftlm) takes FTLMVectors (default 32) and FTLMSteps (80),
``--ltlm`` (or SolverOptions=ltlm) FTLMVectors (16) and FTLMSteps (80);
SolverOptions=factored runs a model's factored form.  Everything runs on
the card unless ``--device cpu`` is given.  ``run()`` returns the
``ExactDiag``, the ``FTLMResult`` or the LTLM dict.
"""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu_torch.engine.thermal import ExactDiag
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model


def run(argv=None):
    p = argparse.ArgumentParser(prog="ed++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    est = p.add_mutually_exclusive_group()
    est.add_argument("--ftlm", action="store_true",
                     help="estimate <E>(T) by the finite-temperature "
                          "Lanczos method instead of the full spectrum "
                          "(scales to sectors dense eigh cannot touch)")
    est.add_argument("--ltlm", action="store_true",
                     help="estimate <E>(T) by the low-temperature "
                          "Lanczos method (symmetric estimator: the "
                          "beta -> inf tail is exact, where plain FTLM "
                          "is noisy)")
    args = p.parse_args(argv)
    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    tb = inp.string("TemperatureOrBeta", default="temperature")
    if args.ltlm or "ltlm" in inp.solver_options():
        from lanczosplusplus_tpu_torch.engine.ftlm import ltlm_schedule
        schedule, res = ltlm_schedule(
            model, inp,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=80), device=args.device)
        sys.stdout.write(f"#tb={tb} method=LTLM\n#Parameter Energy\n")
    elif args.ftlm or "ftlm" in inp.solver_options():
        from lanczosplusplus_tpu_torch.engine.ftlm import ftlm_schedule
        schedule, res = ftlm_schedule(
            model, inp,
            num_vectors=inp.integer("FTLMVectors", default=32),
            steps=inp.integer("FTLMSteps", default=80), device=args.device)
        sys.stdout.write(f"#tb={tb} method=FTLM R={res.num_vectors} "
                         f"M={res.steps}\n#Parameter Energy\n")
    else:
        ed = ExactDiag(model, inp, device=args.device)
        ed.print_energies(sys.stdout)
        return ed
    for tb_value, e in schedule:
        sys.stdout.write(f"{tb_value} {e}\n")
    return res


def main():
    run()


if __name__ == "__main__":
    main()
