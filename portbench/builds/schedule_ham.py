"""The port's path for a sector: the parsed input, its geometry and model,
then ``engine/ftlm._schedule_ham`` (basis, host tables, their transfer,
and, in the flat form, the one-spin factors densified on the card), which
is what ``ed --ftlm`` builds and what the Engine builds for ``lanczos -f``
on such an input.  The form and the type are the input's: flat, or
factored under ``SolverOptions=factored``; float64, or complex128 under
``useComplex``."""

from __future__ import annotations

import time

import torch

from portbench.sector import input_text


def build(config: dict, device: torch.device):
    """(the sector Hamiltonian on `device`, host seconds from the parsed
    input to the Hamiltonian on the card, synchronised)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import _schedule_ham
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    inp = parse_input(input_text(config))
    start = time.perf_counter()
    model = build_model(inp, Geometry(inp))
    ham = _schedule_ham(model, inp, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ham, time.perf_counter() - start
