"""Built-in consistency oracles.

Counterpart of ``lanczosplusplus_tpu/cli/consistency_main.py``:

1. dual-algorithm check: solve the target sector with Lanczos AND dense
   diagonalization and print both energies (reference:
   src/SpinOrbital.cpp:198-254, which does the same for its spin-orbital
   chain; here it works for any Model= input).
2. Heisenberg infinite-temperature energy: brute-force <E> at T=inf in
   an Sz sector (reference:
   src/HeisenbergInfiniteTemperatureEnergy.cpp:58-76), computed from the
   full spectrum trace.

Usage: python -m lanczosplusplus_tpu_torch.cli.consistency_main
       -f input.inp [--tinf] [--device cuda|cpu]

Everything runs on the card unless ``--device cpu`` is given: the Lanczos
solve (``solver/lanczos.lowest_states``), the dense eigenvalues up to
dimension ``DENSE_MAX_DIM`` (``torch.linalg.eigvalsh`` of the host-built
dense matrix, as ``engine/thermal.full_spectrum`` does) and, above it,
the T=inf energy as the mean of the diagonal (the trace over the
dimension).
"""

from __future__ import annotations

import argparse

import torch

from lanczosplusplus_tpu_torch.config import resolve_device
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz

DENSE_MAX_DIM = 20000


def run(argv=None):
    p = argparse.ArgumentParser(prog="consistency++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("--tinf", action="store_true",
                   help="also print the T=infinity mean energy")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    inp = read_input(args.input)
    validate_input(inp)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    dtype = torch.complex128 if "useComplex" in inp.solver_options() \
        else torch.float64
    ham = model.hamiltonian(basis, dtype=dtype, device=device)
    if device.type == "cuda":
        ham = ham.densify_factors()
    evals, _ = lz.lowest_states(ham, num_states=1)
    print(f"Lanczos: lowest eigenvalue= {evals[0]}")
    if ham.dim <= DENSE_MAX_DIM:
        dense = torch.linalg.eigvalsh(
            torch.as_tensor(ham.to_dense(), device=device))
        print(f"Lapack: lowest eigenvalue= {float(dense[0])}")
        print(f"|difference|= {abs(float(dense[0]) - evals[0])}")
        if args.tinf:
            print(f"T=infinity energy= {float(dense.mean())}")
    elif args.tinf:
        # trace/dim without full diagonalization
        print(f"T=infinity energy= {float(ham.diag.mean())}")
    return evals[0]


def main():
    run()


if __name__ == "__main__":
    main()
