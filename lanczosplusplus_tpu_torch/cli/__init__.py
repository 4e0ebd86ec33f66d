"""The port's command lines, and the ``--dtype`` option they share."""

import torch


def add_dtype_option(parser) -> None:
    """``--dtype {float64,float32}``: the run's real type (default
    float64).  float32 (complex64 with useComplex or in a momentum sector)
    is the JAX CLIs' precision on their chip, where x64 is off; every
    energy they refine comes out refined to the float64 bar."""
    parser.add_argument("--dtype", choices=("float64", "float32"),
                        default="float64",
                        help="the run's real type (default float64); "
                             "float32 energies are refined to the float64 "
                             "bar")


def real_dtype(args) -> torch.dtype:
    return getattr(torch, args.dtype)
