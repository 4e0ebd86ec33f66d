"""lanczosplusplus_tpu_torch: exact diagonalization on PyTorch and CUDA.

The port of ``lanczosplusplus_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100: the ground state of every model (``lanczos -f input.inp``, with
the factored forms and the symmetry sectors), continued-fraction spectral
functions (``-g``), the static observables (``-c``, ``-m``, ``-M``,
``-r``), and the estimators with their command lines: KPM and FTLM
densities (``--kpm``, ``--ftlm-dos``), ``ed`` (full spectrum, FTLM,
LTLM), ``thermal``, ``sqomega``, ``dynamics1``, ``qpz`` and
``lorentzian``.
Host code (bases, inputs, geometry, model term lists) is numpy; sector
Hamiltonians and the Lanczos recurrence are tensors on an explicit
``torch.device``; the two hot-path kernels, the dense-factor GEMM and the
ELL SpMV, are hand-written CUDA C++ for Hopper (``csrc/``).  The JAX
package is the reference the port is tested against; this package never
imports jax.
"""

__version__ = "0.1.0"

from lanczosplusplus_tpu_torch.config import Config  # noqa: F401


def load(path_or_text: str, config: Config | None = None):
    """Convenience one-liner: input file or text -> diagonalized Engine
    (on ``cuda`` unless `config` says otherwise)."""
    import os

    from lanczosplusplus_tpu_torch.engine import Engine
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import (parse_input,
                                                            read_input)
    from lanczosplusplus_tpu_torch.models import build_model

    inp = read_input(path_or_text) if os.path.exists(path_or_text) \
        else parse_input(path_or_text)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    return Engine(model, inp, config=config)
