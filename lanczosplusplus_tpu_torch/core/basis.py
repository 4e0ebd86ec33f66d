"""Symmetry-sector bases as host numpy word arrays with vectorized ranking.

Counterpart of ``lanczosplusplus_tpu/core/basis.py`` (``OneSpinBasis``
and ``HubbardBasis``).  Replaces the reference's BasisBase hierarchy
(reference: src/Engine/BasisBase.h:43-114): a basis is a plain array of
bit words per spin species with a perfect-index function; operator
actions become whole-array index maps built here on the host.
"""

from __future__ import annotations

import numpy as np

from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.combinatorics import (
    binomial_table, enumerate_combinations, rank_combinations)

SPIN_UP = 0
SPIN_DOWN = 1


class OneSpinBasis:
    """All C(nsite, npart) occupation words in colex order (reference:
    src/Models/HubbardOneOrbital/BasisOneSpin.h)."""

    def __init__(self, nsite: int, npart: int):
        self.nsite = nsite
        self.npart = npart
        self.words = enumerate_combinations(nsite, npart)
        self._table = binomial_table(nsite + 1)

    @property
    def size(self) -> int:
        return self.words.shape[0]

    def rank(self, words: np.ndarray) -> np.ndarray:
        """Vectorized perfectIndex (BasisOneSpin.h:73-81)."""
        return rank_combinations(words, self.nsite, self._table)

    def occupation_table(self) -> np.ndarray:
        """(size, nsite) int8."""
        return bits.bits_to_table(self.words, self.nsite)


class HubbardBasis:
    """Fixed-(nup, ndown) product basis; pair index = iu + id * size_up
    (reference: src/Models/HubbardOneOrbital/BasisHubbardLanczos.h:59-63)."""

    def __init__(self, nsite: int, nup: int, ndown: int):
        self.nsite = nsite
        self.nup = nup
        self.ndown = ndown
        self.up = OneSpinBasis(nsite, nup)
        self.down = OneSpinBasis(nsite, ndown)

    @property
    def parts(self):
        return (self.nup, self.ndown)

    @property
    def size(self) -> int:
        return self.up.size * self.down.size

    @property
    def spin_shape(self):
        """(size_down, size_up): state vectors reshape to this."""
        return (self.down.size, self.up.size)

    def index_of(self, iu: np.ndarray, idn: np.ndarray) -> np.ndarray:
        return np.asarray(iu) + np.asarray(idn) * self.up.size

    def split_index(self, i: np.ndarray):
        """full index -> (iu, idn)."""
        i = np.asarray(i)
        return i % self.up.size, i // self.up.size

    def words_up(self, i: np.ndarray) -> np.ndarray:
        return self.up.words[np.asarray(i) % self.up.size]

    def words_down(self, i: np.ndarray) -> np.ndarray:
        return self.down.words[np.asarray(i) // self.up.size]
