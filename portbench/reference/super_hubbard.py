"""The t-U-J ring (Model=SuperHubbardExtended) on a chain, fixed (N_up,
N_down), written plainly.

    H = sum_{i != j, s} t_ij c^dag_{j s} c_{i s}
      + sum_i U_i n_{i up} n_{i dn} + sum_i V_i n_i
      + sum_{i<j} W_ij n_i n_j
      + sum_{i<j} J_ij [Sz_i Sz_j + 1/2 (S+_i S-_j + S-_i S+_j)]

with n_i = n_{i up} + n_{i dn}, Sz_i = (n_{i up} - n_{i dn}) / 2,
S+_i = c^dag_{i up} c_{i dn} and S-_i = c^dag_{i dn} c_{i up} (S. Daul,
D. J. Scalapino and S. R. White, PRL 84, 4188 (2000); W = -J/4 makes the
exchange J (S_i.S_j - n_i n_j / 4)).  Term 0 of the input holds t, term 1
W and term 2 J, each a chain of constant couplings.

States.  As in ``hubbard_one_band``: the up word and the down word are
ascending integers, bit i set where site i is occupied, and the state of up
word iu and down word id is entry iu + id * size_up, a vector seen as
X[id, iu].  The state is the product of creators

    |u, d> = prod_{i in u} c^dag_{i up} prod_{i in d} c^dag_{i dn} |0>,

each product in ascending site order, the up creators left of the down
ones (Jordan-Wigner in site order, up before down).

Signs.  An operator c_{i s} or c^dag_{i s} acting on |u, d> passes the
creators standing left of site i's own: for s = up the up creators of the
sites below i, a sign (-1)^(bits of u below i); for s = dn all N_up up
creators and the down creators of the sites below i, (-1)^(N_up + bits of d
below i), N_up counted in the word it acts on.  ``_act`` applies one
operator so; the exchange applies the four operators of

    S+_a S-_b = c^dag_{a up} c_{a dn} c^dag_{b dn} c_{b up}

right to left, and the diagonal and the hops need no more.  Worked out by
hand for a < b, the product takes the up word's fermion from b to a and the
down word's from a to b with the amplitude

    -(-1)^(bits of u strictly between a and b + bits of d between them):

moving c_{b up} left past c^dag_{b dn} and c_{a dn} gives +1, swapping
c_{a dn} c^dag_{b dn} gives -1, and each one-spin hop gives its word's
(-1)^(bits between); the two down operators' N_up signs cancel.  The code
applies the operators and does not use this closed form.  On a bond with no
site between, the exchange entry is -J/2, not +J/2: the sign of the
up-before-down order, which a site-interleaved order would not have.

H x = D o X + X A_up^T + A_dn X + E x: D the diagonal, A_s the one-spin hop
matrix (``hubbard_one_band.hop_matrix``), E the exchange, kept as one
(targets, sources, amplitudes) list of entries a bond and direction.

Departures from LanczosPlusPlus (HubbardHelper.h:138-189, 282-343): only
chains of constant couplings are read, and the time-dependent potential
(``PotentialT``, ``timeFactor``) is not.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import inputs, words as W
from portbench.reference.hubbard_one_band import hop_matrix

UP, DN = 0, 1


def _act(up, dn, site: int, spin: int, create: bool, nsite: int):
    """(up, dn, amplitude) after c^dag_{site spin} (`create`) or
    c_{site spin} acts on the states (up, dn) of `nsite` sites: amplitude 0
    where the operator gives zero, else its sign as float64."""
    word = up if spin == UP else dn
    occupied = W.bit(word, site) == 1
    allowed = ~occupied if create else occupied
    sign = W.sign_below(word, site)
    if spin == DN:
        sign = sign * (1.0 - 2.0 * (W.popcount(up, nsite) & 1).double())
    word = word ^ (1 << site)
    amplitude = torch.where(allowed, sign, 0.0)
    return ((word, dn, amplitude) if spin == UP else (up, word, amplitude))


class Sector:
    """The sector of the input `text` on `device`: ``dim``, ``apply``,
    ``nonzeros`` and ``exchange_entries``."""

    def __init__(self, text: str, device):
        labels = inputs.parse(text)
        if inputs.one(labels, "Model") != "SuperHubbardExtended":
            raise ValueError("this reference reads "
                             "Model=SuperHubbardExtended")
        n = int(inputs.one(labels, "TotalNumberOfSites"))
        t, w, j = inputs.chain_terms(labels, n)
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
        diag = ((occ_dn * u_t) @ occ_up.T + (occ_up @ v_t)[None, :]
                + (occ_dn @ v_t)[:, None])
        # the (size_down, size_up) grid of each site's n and Sz
        occ = [occ_up[None, :, i] + occ_dn[:, i, None] for i in range(n)]
        sz = [(occ_up[None, :, i] - occ_dn[:, i, None]) / 2
              for i in range(n)]
        for a in range(n):
            for b in range(a + 1, n):
                if w[a, b] != 0:
                    diag = diag + w[a, b] * occ[a] * occ[b]
                if j[a, b] != 0:
                    diag = diag + j[a, b] * sz[a] * sz[b]
        self.diag = diag

        # every (up, dn) state as two (size_down, size_up) grids of words
        up_w = up[None, :].expand(self.shape)
        dn_w = dn[:, None].expand(self.shape)
        index = torch.arange(self.dim, device=device).reshape(self.shape)
        self.exchange = []
        for a in range(n):
            for b in range(a + 1, n):
                if j[a, b] == 0:
                    continue
                # S+_a S-_b, then S-_a S+_b = S+_b S-_a
                for p, q in ((a, b), (b, a)):
                    new_up, new_dn, amp = up_w, dn_w, torch.ones(
                        self.shape, dtype=torch.float64, device=device)
                    for site, spin, create in ((q, UP, False),
                                               (q, DN, True),
                                               (p, DN, False),
                                               (p, UP, True)):
                        new_up, new_dn, step = _act(new_up, new_dn, site,
                                                    spin, create, n)
                        amp = amp * step
                    keep = amp != 0
                    target = (torch.searchsorted(dn, new_dn[keep])
                              * self.shape[1]
                              + torch.searchsorted(up, new_up[keep]))
                    self.exchange.append((target, index[keep],
                                          0.5 * j[a, b] * amp[keep]))

    @property
    def dim(self) -> int:
        return self.shape[0] * self.shape[1]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """H applied to each row of the block x (R, dim), in x's type."""
        a_up, a_dn, diag = (m.to(x.dtype) for m in
                            (self.a_up, self.a_dn, self.diag))
        xs = x.reshape(x.shape[0], *self.shape)
        y = (diag * xs + xs @ a_up.T + a_dn @ xs).reshape(x.shape)
        for target, source, amp in self.exchange:
            y.index_add_(1, target, amp.to(x.dtype) * x[:, source])
        return y

    def exchange_entries(self) -> int:
        """Entries of the exchange (S+S- terms) that are not zero."""
        return sum(int(torch.count_nonzero(amp))
                   for _, _, amp in self.exchange)

    def nonzeros(self) -> int:
        """Entries of H that are not zero: the diagonal's, each hop
        factor's times the other spin's words, and the exchange's."""
        szd, szu = self.shape
        return (int(torch.count_nonzero(self.diag))
                + int(torch.count_nonzero(self.a_up)) * szd
                + int(torch.count_nonzero(self.a_dn)) * szu
                + self.exchange_entries())
