"""Spin-1/2 Heisenberg model on a chain, fixed S^z, written plainly.

    H = sum_{i<j} Jzz_ij S^z_i S^z_j + 1/2 sum_{i != j} Jpm_ij S^+_i S^-_j

Term 0 of the input holds Jpm and term 1 Jzz.  A state is a word whose
bit i is set where site i points up; the sector holds the words with
``TargetSzPlusConst`` bits set, in ascending order, and entry k of a vector
belongs to word k.  For each bond {i, j} whose spins differ, the exchange
flips both with amplitude Jpm_ij / 2; the flipped word's entry is found by
``torch.searchsorted``.  Only Model=Heisenberg with HeisenbergTwiceS=1 is
read.
"""

from __future__ import annotations

import torch

from portbench.reference import inputs, words as W


class Sector:
    """The sector of the input `text` on `device`: ``dim``, ``apply`` and
    ``nonzeros``."""

    def __init__(self, text: str, device):
        labels = inputs.parse(text)
        if inputs.one(labels, "Model") != "Heisenberg" \
                or inputs.one(labels, "HeisenbergTwiceS", "1") != "1":
            raise ValueError("this reference reads Model=Heisenberg with "
                             "HeisenbergTwiceS=1")
        n = int(inputs.one(labels, "TotalNumberOfSites"))
        jpm, jzz = inputs.chain_terms(labels, n)
        up = int(inputs.one(labels, "TargetSzPlusConst"))
        words = W.combinations(n, up, device)
        self.words = words
        diag = torch.zeros(words.shape[0], dtype=torch.float64,
                           device=device)
        targets, amplitudes = [], []
        for i in range(n):
            for j in range(i + 1, n):
                si = W.bit(words, i).double() - 0.5
                sj = W.bit(words, j).double() - 0.5
                if jzz[i, j] != 0:
                    diag += jzz[i, j] * si * sj
                if jpm[i, j] == 0:
                    continue
                differ = si != sj
                flipped = torch.searchsorted(words,
                                             words ^ ((1 << i) | (1 << j)))
                targets.append(torch.where(
                    differ, flipped, torch.arange(words.shape[0],
                                                  device=device)))
                amplitudes.append(0.5 * jpm[i, j] * differ.double())
        self.diag = diag
        self.targets = targets
        self.amplitudes = amplitudes

    @property
    def dim(self) -> int:
        return self.words.shape[0]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """H applied to each row of the block x (R, dim), in x's type."""
        y = self.diag.to(x.dtype) * x
        for target, amp in zip(self.targets, self.amplitudes):
            y += amp.to(x.dtype) * x[:, target]
        return y

    def nonzeros(self) -> int:
        """The diagonal and every exchange entry of H."""
        return self.dim + sum(int(torch.count_nonzero(a))
                              for a in self.amplitudes)
