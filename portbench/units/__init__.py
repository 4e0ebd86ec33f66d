"""The general generator: a traffic mix's units of work, run on the port.

A mix (traffic/<mix>.json) names its kind of unit, and units/<kind>.py
defines that kind as a class ``Unit(params, ham, seed, refine)`` with:

    ham                 the sector Hamiltonian it runs on (the harness
                        swaps in a delegate for a trace)
    warm_up()           one unit of the cell's own shapes, in set-up
    run(index)          unit `index` of the window, its inputs drawn from
                        (seed, index); it keeps what the unit answered
    counts()            {name: count} of the work done, for the readers
    release()           drops the Hamiltonian before the reference is built
    numbers(reference, limits)
                        ({number: worst reading}, units failed, log lines):
                        the kept answers held against the plain reference

Unit i's input is drawn from (seed, i) by a ``torch.Generator`` on the
card, the warm-up's from (seed, -1): the same seed gives the same inputs,
and every seed the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

# a seed is any whole number; it is folded into 64 bits
SEED_BITS = 1 << 64


def unit_seed(seed: int, index: int) -> int:
    """The generator seed of unit `index` (-1: the warm-up) of a run."""
    return int(np.random.SeedSequence([seed % SEED_BITS, index + 1])
               .generate_state(1, np.uint64)[0])


def sample_rng(seed: int) -> np.random.Generator:
    """The run's generator for choosing which answers to check."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % SEED_BITS, SEED_BITS - 1]))


def draw_block(seed: int, index: int, rows: int, dim: int,
               device) -> torch.Tensor:
    """(rows, dim) float64 unit rows, normal before normalisation."""
    gen = torch.Generator(device=device).manual_seed(unit_seed(seed, index))
    x = torch.randn((rows, dim), generator=gen, dtype=torch.float64,
                    device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
