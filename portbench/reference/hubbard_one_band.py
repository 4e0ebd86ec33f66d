"""One-band Hubbard model on a chain, fixed (N_up, N_down), written plainly.

    H = sum_{i != j, s} t_ij c^dag_{j s} c_{i s}
      + sum_i U_i n_{i up} n_{i dn} + sum_i V_i (n_{i up} + n_{i dn})

A state is |up word> (x) |down word>, each word's occupations in site
order with the fermion sign of an operator taken over the occupied sites
below it (Jordan-Wigner in site order; the up operators stand left of the
down ones, so a hop of one spin sees no sign from the other).  The words
of one spin are ascending integers, and the state of up word iu and down
word id is entry iu + id * size_up: a vector seen as X[id, iu].  Then

    H x = D o X + X A_up^T + A_dn X

with A_s the one-spin hop matrix and D the diagonal, both made here from
the input labels.  Only Model=HubbardOneBand, one term of constant chain
couplings, is read.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import inputs, words as W


def hop_matrix(words: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """A[a, b] = <a| sum_{i != j} t_ij c^dag_j c_i |b> over the ascending
    words of one spin (dense, float64, on the words' device)."""
    size = words.shape[0]
    a = torch.zeros((size, size), dtype=torch.float64, device=words.device)
    cols = torch.arange(size, device=words.device)
    n = t.shape[0]
    for i in range(n):
        for j in range(n):
            if i == j or t[i, j] == 0:
                continue
            ok = (W.bit(words, i) == 1) & (W.bit(words, j) == 0)
            mid = words ^ (1 << i)
            new = mid | (1 << j)
            sign = W.sign_below(words, i) * W.sign_below(mid, j)
            rows = torch.searchsorted(words, new[ok])
            a.index_put_((rows, cols[ok]), t[i, j] * sign[ok],
                         accumulate=True)
    return a


class Sector:
    """The sector of the input `text` on `device`: ``dim``, ``apply`` and
    ``nonzeros``."""

    def __init__(self, text: str, device):
        labels = inputs.parse(text)
        if inputs.one(labels, "Model") != "HubbardOneBand":
            raise ValueError("this reference reads Model=HubbardOneBand")
        n = int(inputs.one(labels, "TotalNumberOfSites"))
        (t,) = inputs.chain_terms(labels, n)
        u = np.array(inputs.one(labels, "hubbardU"), dtype=np.float64)
        v = np.array(inputs.one(labels, "potentialV", ["0"] * (2 * n)),
                     dtype=np.float64)[:n]
        nup = int(inputs.one(labels, "TargetElectronsUp"))
        ndn = int(inputs.one(labels, "TargetElectronsDown"))
        up = W.combinations(n, nup, device)
        dn = W.combinations(n, ndn, device)
        self.shape = (dn.shape[0], up.shape[0])
        self.a_up = hop_matrix(up, t)
        self.a_dn = hop_matrix(dn, t)
        occ_up = torch.stack([W.bit(up, i) for i in range(n)], 1).double()
        occ_dn = torch.stack([W.bit(dn, i) for i in range(n)], 1).double()
        u_t = torch.as_tensor(u, device=device)
        v_t = torch.as_tensor(v, device=device)
        self.diag = ((occ_dn * u_t) @ occ_up.T + (occ_up @ v_t)[None, :]
                     + (occ_dn @ v_t)[:, None])

    @property
    def dim(self) -> int:
        return self.shape[0] * self.shape[1]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """H applied to each row of the block x (R, dim), in x's type."""
        a_up, a_dn, diag = (m.to(x.dtype) for m in
                            (self.a_up, self.a_dn, self.diag))
        xs = x.reshape(x.shape[0], *self.shape)
        y = diag * xs + xs @ a_up.T + a_dn @ xs
        return y.reshape(x.shape)

    def nonzeros(self) -> int:
        """Entries of H that are not zero by construction: the whole
        diagonal, and each hop factor's entries times the other spin's
        words."""
        szd, szu = self.shape
        return (self.dim + int(torch.count_nonzero(self.a_up)) * szd
                + int(torch.count_nonzero(self.a_dn)) * szu)
