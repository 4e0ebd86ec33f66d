"""Occupation words as int64 tensors: bit i set means site i occupied (or
spin up at site i)."""

from __future__ import annotations

import torch


def popcount(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Set bits of each word below bit `nbits`."""
    count = torch.zeros_like(words)
    for b in range(nbits):
        count += (words >> b) & 1
    return count


def combinations(nsite: int, k: int, device) -> torch.Tensor:
    """Every word of `nsite` bits with `k` of them set, ascending."""
    if nsite > 30:
        raise ValueError(f"{nsite} sites: the reference scans all 2^nsite "
                         "words")
    words = torch.arange(1 << nsite, dtype=torch.int64, device=device)
    return words[popcount(words, nsite) == k]


def bit(words: torch.Tensor, site: int) -> torch.Tensor:
    return (words >> site) & 1


def sign_below(words: torch.Tensor, site: int) -> torch.Tensor:
    """(-1)^(set bits strictly below `site`), as float64."""
    below = popcount(words & ((1 << site) - 1), site)
    return 1.0 - 2.0 * (below & 1).to(torch.float64)
