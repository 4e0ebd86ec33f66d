"""The `lorentzian` command line: a pole list broadened onto real or
Matsubara grids (reference: src/lorentzian.cpp:126-212 CLI).

Counterpart of ``lanczosplusplus_tpu/cli/lorentzian_main.py``, host numpy
only (``engine/broadening.py``):

  python -m lanczosplusplus_tpu_torch.cli.lorentzian_main -f poles.txt
         -t TOTAL -m real|matsubara [-e eps] [-b beta] [-s step] [-S start]

It prints ``omega Re G Im G`` a grid point.
"""

from __future__ import annotations

import argparse

import numpy as np

from lanczosplusplus_tpu_torch.engine.broadening import lorentzian_grid


def run(argv=None):
    p = argparse.ArgumentParser(prog="lorentzian++")
    p.add_argument("-f", dest="file", required=True,
                   help="two-column (energy weight) file")
    p.add_argument("-t", dest="total", type=int, required=True)
    p.add_argument("-m", dest="mode", required=True,
                   choices=["real", "matsubara"])
    p.add_argument("-e", dest="eps", type=float, default=0.1)
    p.add_argument("-b", dest="beta", type=float, default=0.0)
    p.add_argument("-s", dest="step", type=float, default=None)
    p.add_argument("-S", dest="start", type=float, default=None)
    args = p.parse_args(argv)
    data = np.loadtxt(args.file)
    e, w = data[:, 0], data[:, 1]
    omegas, g = lorentzian_grid(e, w, args.total, mode=args.mode,
                                eps=args.eps, beta=args.beta,
                                start=args.start, step=args.step)
    for om, val in zip(omegas, g):
        print(f"{om} {val.real} {val.imag}")
    return omegas, g


def main():
    run()


if __name__ == "__main__":
    main()
