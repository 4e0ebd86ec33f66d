"""SpinOrbital driver (reference: src/SpinOrbital.cpp:231-256):
builds the spin-orbital chain and prints the lowest energy from BOTH
Lanczos and dense diagonalization — an internal consistency check.

Counterpart of ``lanczosplusplus_tpu/cli/spin_orbital_main.py``:

  python -m lanczosplusplus_tpu_torch.cli.spin_orbital_main nsites [twiceJ]
         [--device cuda|cpu]

The Hamiltonian (``models/spin_orbital.build_spin_orbital``), its
Hermiticity check, the Lanczos solve and the dense eigenvalues
(``torch.linalg.eigvalsh``) run on the card unless ``--device cpu`` is
given.  A Hamiltonian that is not Hermitian (twiceJ = 3: the reference's
amplitude recipe holds only for J <= 1) exits, as the reference's
isHermitian() check does.
"""

from __future__ import annotations

import argparse

import torch

from lanczosplusplus_tpu_torch.config import resolve_device
from lanczosplusplus_tpu_torch.models.spin_orbital import build_spin_orbital
from lanczosplusplus_tpu_torch.solver import lanczos as lz


def run(argv=None):
    p = argparse.ArgumentParser(prog="spinorbital++")
    p.add_argument("nsites", type=int)
    p.add_argument("twice_j", type=int, nargs="?", default=2,
                   metavar="twiceJ")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "is an error, not a CPU run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ham = build_spin_orbital(args.nsites, args.twice_j, device=device)
    dense = torch.as_tensor(ham.to_dense(), device=device)
    herm = float((dense - dense.mH).abs().max())
    if herm > 1e-9:
        raise SystemExit(f"H is not Hermitian: {herm}")
    evals, _ = lz.lowest_states(ham, num_states=1, max_steps=300)
    print(f"Lanczos energy={float(evals[0]):.10g}")
    e = torch.linalg.eigvalsh(dense)
    print(f"LAPACK energy={float(e[0]):.10g}")
    return float(evals[0]), float(e[0])


def main():
    run()


if __name__ == "__main__":
    main()
