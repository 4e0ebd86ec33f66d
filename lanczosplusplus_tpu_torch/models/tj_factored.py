"""Half-cut block-factorized t-J solver (any orbitals; the
JHundInfinity rotation stays on the flat path).

Counterpart of ``lanczosplusplus_tpu/models/tj_factored.py``:
``build_factored_tj`` and ``build_factored_tj_blocks``.  The half bases,
dense half operators and channel tables are built on the host in numpy;
the form lives on the device it is built for, where the within-half
products go through ``factor_matmul`` (tiered) and the cut-crossing
channels through ``perm_gather``.

The t-J basis is not a spin product (the no-double-occupancy
constraint couples the spin words; reference:
src/Models/TjMultiOrb/BasisTjMultiOrbLanczos.h:354-370), so the
Kronecker spin factorization of the Hubbard models does not apply and
the flat path runs the generic gather-ELL.  But the constraint IS
local, so the space factorizes over a spatial cut: splitting the chain
into halves L = [0, n/2) and R = [n/2, n),

    sector(nup, ndn) = (+)_{au, ad}  L(au, ad)  (x)  R(nup-au, ndn-ad)

with L, R themselves (tiny) constrained t-J bases.  Within-half terms
become dense half-Hamiltonians applied as GEMMs on the
(dimL, dimR) block matrices; the cut-crossing bonds are partial
permutations on each factor (PermCrossTerm: one row gather + one
column gather per bond); the diagonal — including the cross Jzz / W
pieces — is the per-block dense table.  This is the spatial analogue
of models/heisenberg_factored.py and the answer to TjMultiOrb's
matrix-free row loop (reference: TjMultiOrb.h:649-695).

Element rules (guards, extra signs, parity strings) mirror
models/tj.py exactly and are validated by to_dense equality against
the flat path in tests/test_tj_factored.py.

Sign bookkeeping across the cut (Jordan-Wigner ordering = all up
modes, then all dn modes, site-major as in tj.py):
- hops carry the pair parity of the SAME spin word strictly between
  the bond sites, which splits into a left piece (bits above a) and a
  right piece (bits below b);
- S+S- carries parity_below at both sites for both spin words on the
  bra (TjMultiOrb.h:772-786); parity_below at a right site includes
  the parity of the whole left word — a per-block scalar
  (-1)^(au' + ad') folded into the amplitudes.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import (
    BlockKronHamiltonian, make_perm_cross, permuted, tierize, to_device)
from lanczosplusplus_tpu_torch.models.tj import TjBasis


def _parity_above(words, site):
    """(-1)^(number of set bits strictly above `site`)."""
    shifted = words >> WORD(site + 1)
    return np.where(bits.popcount(shifted) & 1, -1.0, 1.0)


def _half_projectors(tjb: TjBasis):
    """Per-state per-SITE t-J projector pro_i = |n_i - 1| if n_i > 0
    else 0 (models/tj.py _projectors), for one half."""
    o = tjb.orbitals
    nsite = tjb.nbits // o
    nu = bits.bits_to_table(tjb.up_words, tjb.nbits).astype(np.float64)
    nd = bits.bits_to_table(tjb.dn_words, tjb.nbits).astype(np.float64)
    ntot = (nu + nd).reshape(-1, nsite, o).sum(axis=2)
    return np.where(ntot > 0, np.abs(ntot - 1), 0.0)


def _offdiag_dense(tjb: TjBasis, hop, jpm):
    """Within-half off-diagonal part (hops + S+S-), same element rules
    as TjMultiOrbModel.hamiltonian (models/tj.py), scattered dense.
    Multi-orbital: the S+S- term carries the site-level projector pair
    pro_i * pro_j of the row state (models/tj.py:290-295)."""
    dim = tjb.size
    upw, dnw = tjb.up_words, tjb.dn_words
    nb = tjb.nbits
    o = tjb.orbitals
    pro = _half_projectors(tjb) if o > 1 else None
    h = np.zeros((dim, dim))
    rows = np.arange(dim)
    occ_u = {a: bits.get_bit(upw, a) for a in range(nb)}
    occ_d = {a: bits.get_bit(dnw, a) for a in range(nb)}
    for a in range(nb):
        for b in range(a + 1, nb):
            t = hop[a, b]
            if t != 0:
                flip = WORD((1 << a) | (1 << b))
                pair_u = bits.pair_hop_sign(upw, a, b)
                pair_d = bits.pair_hop_sign(dnw, a, b)
                one_up = (occ_u[a] + occ_u[b]) == 1
                guard = ~(((occ_u[b] == 0) & (occ_d[b] == 1)) |
                          ((occ_u[b] == 1) & (occ_d[a] == 1)))
                ok = one_up & guard
                extra = np.where(occ_u[a] == 1, -1.0, 1.0)
                tgt = tjb.rank(upw ^ flip, dnw)
                np.add.at(h, (rows[ok], tgt[ok]),
                          (t * extra * pair_u)[ok])
                one_dn = (occ_d[a] + occ_d[b]) == 1
                guard = ~(((occ_d[b] == 0) & (occ_u[b] == 1)) |
                          ((occ_d[b] == 1) & (occ_u[a] == 1)))
                ok = one_dn & guard
                extra = np.where(occ_d[a] == 1, -1.0, 1.0)
                tgt = tjb.rank(upw, dnw ^ flip)
                np.add.at(h, (rows[ok], tgt[ok]),
                          (t * extra * pair_d)[ok])
            jv = jpm[a, b]
            if jv != 0:
                hh = 0.5 * jv
                flip = WORD((1 << a) | (1 << b))
                c1 = (occ_u[a] == 1) & (occ_u[b] == 0) & \
                     (occ_d[a] == 0) & (occ_d[b] == 1)
                c2 = (occ_u[a] == 0) & (occ_u[b] == 1) & \
                     (occ_d[a] == 1) & (occ_d[b] == 0)
                ok = c1 | c2
                bra_u = upw ^ flip
                bra_d = dnw ^ flip
                s = bits.parity_sign_below(bra_d, b) * \
                    bits.parity_sign_below(bra_d, a) * \
                    bits.parity_sign_below(bra_u, a) * \
                    bits.parity_sign_below(bra_u, b)
                if pro is not None:
                    s = s * pro[:, a // o] * pro[:, b // o]
                tgt = tjb.rank(bra_u, bra_d)
                np.add.at(h, (rows[ok], tgt[ok]), (hh * s)[ok])
    return h


def _diag_within(tjb: TjBasis, jzz, w, vu, vd):
    """Within-half diagonal (potentials + Jzz/4 SzSz + W ninj), the
    formulas of TjMultiOrbModel.diagonal; multi-orbital dresses the
    per-bit Sz/ntot tables with the site projectors and masks same-site
    bit couplings (models/tj.py:215-228).  Returns (diag, a_zz, a_w)
    where a_zz/a_w are the (dressed) per-bit tables the caller uses
    for the cut-crossing diagonal bilinears — crossing pairs are never
    same-site, so the raw couplings apply there."""
    o = tjb.orbitals
    nu = bits.bits_to_table(tjb.up_words, tjb.nbits).astype(np.float64)
    nd = bits.bits_to_table(tjb.dn_words, tjb.nbits).astype(np.float64)
    diag = nu @ vu + nd @ vd
    sz2 = nu - nd
    ntot = nu + nd
    if o == 1:
        a_zz, a_w = sz2, ntot
        jzz_eff, w_eff = jzz, w
        quad_zz = np.einsum("sa,ab,sb->s", a_zz, jzz_eff, a_zz)
        self_zz = np.einsum("sa,aa,sa->s", a_zz,
                            np.diag(np.diag(jzz_eff)), a_zz)
        diag += 0.25 * 0.5 * (quad_zz - self_zz)
        quad_w = np.einsum("sa,ab,sb->s", a_w, w_eff, a_w)
        self_w = np.einsum("sa,aa,sa->s", a_w,
                           np.diag(np.diag(w_eff)), a_w)
        diag += 0.5 * (quad_w - self_w)
    else:
        pro = _half_projectors(tjb)
        prob = np.repeat(pro, o, axis=1)
        a_zz = prob * sz2
        a_w = prob * ntot
        nsite = tjb.nbits // o
        site_of = np.repeat(np.arange(nsite), o)
        same_site = site_of[:, None] == site_of[None, :]
        jzz_eff = np.where(same_site, 0.0, jzz)
        w_eff = np.where(same_site, 0.0, w)
        diag += 0.25 * 0.5 * np.einsum("sa,ab,sb->s", a_zz, jzz_eff,
                                       a_zz)
        diag += 0.5 * np.einsum("sa,ab,sb->s", a_w, w_eff, a_w)
    return diag, a_zz, a_w


def build_factored_tj(model, basis: TjBasis,
                      dtype: torch.dtype = torch.float64, device="cpu",
                      cut: int | None = None, cross_dtype=None):
    """Block-factorized Hamiltonian for a t-J sector, wrapped to the
    flat (sorted-word) TjBasis order.  Returns None when the model is
    outside the factored path's scope (orbitals > 1 or the
    JHundInfinity rotation)."""
    out = build_factored_tj_blocks(model, basis.nup, basis.ndown,
                                   dtype=dtype, device=device, cut=cut,
                                   cross_dtype=cross_dtype)
    if out is None:
        return None
    bk, blocks, lb, rb, nl = out
    nlb = nl * basis.orbitals          # cut position in BITS

    # flat (sorted combined word) order of the full-sector TjBasis
    perm = np.empty(bk.dim, dtype=np.int64)
    off = 0
    for (au, ad), (dl_, dr_) in zip(blocks, bk.shapes):
        left, right = lb[(au, ad)], rb[(au, ad)]
        up = (right.up_words.astype(np.uint64)[None, :] << WORD(nlb)) \
            | left.up_words.astype(np.uint64)[:, None]
        dn = (right.dn_words.astype(np.uint64)[None, :] << WORD(nlb)) \
            | left.dn_words.astype(np.uint64)[:, None]
        perm[off:off + dl_ * dr_] = basis.rank(up.reshape(-1),
                                               dn.reshape(-1))
        off += dl_ * dr_
    return permuted(bk, perm)


def build_factored_tj_blocks(model, nup: int, ndn: int,
                             dtype: torch.dtype = torch.float64,
                             device="cpu", cut: int | None = None,
                             cross_dtype=None):
    """Block-ordered form WITHOUT the flat-order wrap: usable for
    sectors where the full TjBasis cannot even be enumerated (its
    construction holds an O(C(n,nup) * C(n,ndn)) mask; 20 sites
    half-ish filling would need tens of GB).  Returns
    (BlockKronHamiltonian, blocks, left_bases, right_bases, cut)."""
    if model.reinterpret:
        return None
    n = model.geometry.number_of_sites()
    o = model.norb
    nl = cut if cut is not None else n // 2
    nr = n - nl
    nlb, nrb = nl * o, nr * o          # bits per half (cut at a site)
    hop, jpm, jzz, w = model.hop, model.jpm, model.jzz, model.w
    pv = model.potential_v
    # potentialV bit layout: site + orb*nsite (+ orbitals*nsite for
    # down) -> per-bit vectors (models/tj.py:189-202)
    vu = np.zeros(n * o)
    vd = np.zeros(n * o)
    for site in range(n):
        for orb in range(o):
            k = site + orb * n
            if k < pv.size:
                vu[site * o + orb] = pv[k]
            k2 = site + orb * n + o * n
            if k2 < pv.size:
                vd[site * o + orb] = pv[k2]

    hop_cross = [(a, b) for a in range(nlb) for b in range(nlb, n * o)
                 if hop[a, b] != 0]
    jpm_cross = [(a, b) for a in range(nlb) for b in range(nlb, n * o)
                 if jpm[a, b] != 0]

    # blocks: left quantum numbers (au, ad) — counts of left BITS
    blocks = []
    lb, rb = {}, {}
    for au in range(0, min(nlb, nup) + 1):
        for ad in range(0, min(nlb, ndn) + 1):
            if au + ad > nlb:
                continue
            bu, bd = nup - au, ndn - ad
            if bu < 0 or bd < 0 or bu + bd > nrb or bu > nrb \
                    or bd > nrb:
                continue
            left = TjBasis(nl, au, ad, orbitals=o)
            right = TjBasis(nr, bu, bd, orbitals=o)
            if left.size == 0 or right.size == 0:
                continue
            blocks.append((au, ad))
            lb[(au, ad)] = left
            rb[(au, ad)] = right
    pos = {b: i for i, b in enumerate(blocks)}

    shapes, diags, row_ops, col_ops = [], [], [], []
    left_tabs = {}
    for (au, ad) in blocks:
        left, right = lb[(au, ad)], rb[(au, ad)]
        shapes.append((left.size, right.size))
        dl, szl, ntl = _diag_within(left, jzz[:nlb, :nlb],
                                    w[:nlb, :nlb], vu[:nlb], vd[:nlb])
        dr, szr, ntr = _diag_within(right, jzz[nlb:, nlb:],
                                    w[nlb:, nlb:], vu[nlb:], vd[nlb:])
        d2 = dl[:, None] + dr[None, :]
        # cross-cut diagonal couplings: quad terms count (L,R) and
        # (R,L) once each -> factor 2 against the 1/2 in the quad form;
        # crossing bit pairs are never same-site, so the raw coupling
        # blocks apply even at orbitals > 1 (the dressed szl/ntl tables
        # already carry the projectors)
        d2 = d2 + 0.25 * (szl @ jzz[:nlb, nlb:] @ szr.T)
        d2 = d2 + (ntl @ w[:nlb, nlb:] @ ntr.T)
        diags.append(to_device(d2, dtype, device))
        row_ops.append(to_device(_offdiag_dense(
            left, hop[:nlb, :nlb], jpm[:nlb, :nlb]), dtype, device))
        col_ops.append(to_device(_offdiag_dense(
            right, hop[nlb:, nlb:], jpm[nlb:, nlb:]), dtype, device))

    # -- cut-crossing terms as batched partial permutations -----------
    # (built from the DESTINATION side: PermCrossTerm gathers from src)
    perm_cross = []

    def perm_term(src_b, dst_b, bondlist, left_fn, right_fn):
        """left_fn/right_fn: (dst_half_basis, src_half_basis, site) ->
        (src_index, amp) per destination state (amp 0 where invalid)."""
        if src_b not in pos or dst_b not in pos or not bondlist:
            return
        nbonds = len(bondlist)
        ldst, lsrc = lb[dst_b], lb[src_b]
        rdst, rsrc = rb[dst_b], rb[src_b]
        row_src = np.zeros((nbonds, ldst.size), np.int32)
        row_amp = np.zeros((nbonds, ldst.size))
        col_src = np.zeros((nbonds, rdst.size), np.int32)
        col_amp = np.zeros((nbonds, rdst.size))
        for k, (a, b, coupling) in enumerate(bondlist):
            rs, ra = left_fn(ldst, lsrc, a, coupling)
            cs, ca = right_fn(rdst, rsrc, b - nlb)
            row_src[k], row_amp[k] = rs, ra
            col_src[k], col_amp[k] = cs, ca
        perm_cross.append(make_perm_cross(
            row_src, row_amp, col_src, col_amp, pos[src_b], pos[dst_b],
            dtype, device, cross_dtype))

    # hop across the cut, up spin, direction L -> R (electron leaves a)
    def up_lose_left(ldst, lsrc, a, t):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = (bits.get_bit(upw, a) == 0) & (bits.get_bit(dnw, a) == 0)
        src_up = bits.flip_bit(upw, a)
        idx = np.where(ok, lsrc.rank(src_up, dnw), 0)
        # combined hop sign: the reference's extraSign times the
        # occupation-at-lo piece of pair_hop_sign is identically +1
        # (BasisOneSpin.h:104-121 + TjMultiOrb.h:676), leaving only the
        # strictly-between parity; left piece = up bits above a
        amp = t * _parity_above(upw, a)
        return idx, np.where(ok, amp, 0.0)

    def up_gain_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = bits.get_bit(upw, b) == 1
        src_up = bits.flip_bit(upw, b)
        idx = np.where(ok, rsrc.rank(src_up, dnw), 0)
        amp = bits.parity_sign_below(upw, b)  # bits below b unchanged
        return idx, np.where(ok, amp, 0.0)

    # direction R -> L (electron arrives at a)
    def up_gain_left(ldst, lsrc, a, t):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = bits.get_bit(upw, a) == 1
        src_up = bits.flip_bit(upw, a)
        idx = np.where(ok, lsrc.rank(src_up, dnw), 0)
        amp = t * _parity_above(upw, a)
        return idx, np.where(ok, amp, 0.0)

    def up_lose_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = (bits.get_bit(upw, b) == 0) & (bits.get_bit(dnw, b) == 0)
        src_up = bits.flip_bit(upw, b)
        idx = np.where(ok, rsrc.rank(src_up, dnw), 0)
        amp = bits.parity_sign_below(upw, b)
        return idx, np.where(ok, amp, 0.0)

    def dn_lose_left(ldst, lsrc, a, t):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = (bits.get_bit(dnw, a) == 0) & (bits.get_bit(upw, a) == 0)
        src_dn = bits.flip_bit(dnw, a)
        idx = np.where(ok, lsrc.rank(upw, src_dn), 0)
        amp = t * _parity_above(dnw, a)
        return idx, np.where(ok, amp, 0.0)

    def dn_gain_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = bits.get_bit(dnw, b) == 1
        src_dn = bits.flip_bit(dnw, b)
        idx = np.where(ok, rsrc.rank(upw, src_dn), 0)
        amp = bits.parity_sign_below(dnw, b)
        return idx, np.where(ok, amp, 0.0)

    def dn_gain_left(ldst, lsrc, a, t):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = bits.get_bit(dnw, a) == 1
        src_dn = bits.flip_bit(dnw, a)
        idx = np.where(ok, lsrc.rank(upw, src_dn), 0)
        amp = t * _parity_above(dnw, a)
        return idx, np.where(ok, amp, 0.0)

    def dn_lose_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = (bits.get_bit(dnw, b) == 0) & (bits.get_bit(upw, b) == 0)
        src_dn = bits.flip_bit(dnw, b)
        idx = np.where(ok, rsrc.rank(upw, src_dn), 0)
        amp = bits.parity_sign_below(dnw, b)
        return idx, np.where(ok, amp, 0.0)

    # S+S- across the cut, branch c1 (up leaves a, dn arrives at a):
    # dst left has dn at a instead of up; amplitudes on the bra (= dst)
    # words (TjMultiOrb.h:772-786), with the left-word parity of the
    # parity_below at the right site folded in as the block scalar
    def _pro_at(half, bit):
        """Site projector of the dst half at `bit`'s site (1.0 at
        orbitals == 1; models/tj.py:290-295)."""
        if half.orbitals == 1:
            return 1.0
        return _half_projectors(half)[:, bit // half.orbitals]

    def j_c1_left(ldst, lsrc, a, hh_and_scalar):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = (bits.get_bit(upw, a) == 0) & (bits.get_bit(dnw, a) == 1)
        src_up = bits.flip_bit(upw, a)
        src_dn = bits.flip_bit(dnw, a)
        idx = np.where(ok, lsrc.rank(src_up, src_dn), 0)
        amp = hh_and_scalar * bits.parity_sign_below(upw, a) * \
            bits.parity_sign_below(dnw, a) * _pro_at(ldst, a)
        return idx, np.where(ok, amp, 0.0)

    def j_c1_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = (bits.get_bit(upw, b) == 1) & (bits.get_bit(dnw, b) == 0)
        src_up = bits.flip_bit(upw, b)
        src_dn = bits.flip_bit(dnw, b)
        idx = np.where(ok, rsrc.rank(src_up, src_dn), 0)
        amp = bits.parity_sign_below(upw, b) * \
            bits.parity_sign_below(dnw, b) * _pro_at(rdst, b)
        return idx, np.where(ok, amp, 0.0)

    def j_c2_left(ldst, lsrc, a, hh_and_scalar):
        upw, dnw = ldst.up_words, ldst.dn_words
        ok = (bits.get_bit(upw, a) == 1) & (bits.get_bit(dnw, a) == 0)
        src_up = bits.flip_bit(upw, a)
        src_dn = bits.flip_bit(dnw, a)
        idx = np.where(ok, lsrc.rank(src_up, src_dn), 0)
        amp = hh_and_scalar * bits.parity_sign_below(upw, a) * \
            bits.parity_sign_below(dnw, a) * _pro_at(ldst, a)
        return idx, np.where(ok, amp, 0.0)

    def j_c2_right(rdst, rsrc, b):
        upw, dnw = rdst.up_words, rdst.dn_words
        ok = (bits.get_bit(upw, b) == 0) & (bits.get_bit(dnw, b) == 1)
        src_up = bits.flip_bit(upw, b)
        src_dn = bits.flip_bit(dnw, b)
        idx = np.where(ok, rsrc.rank(src_up, src_dn), 0)
        amp = bits.parity_sign_below(upw, b) * \
            bits.parity_sign_below(dnw, b) * _pro_at(rdst, b)
        return idx, np.where(ok, amp, 0.0)

    for (au, ad) in blocks:
        hb = [(a, b, hop[a, b]) for (a, b) in hop_cross]
        perm_term((au, ad), (au - 1, ad), hb, up_lose_left,
                  up_gain_right)
        perm_term((au, ad), (au + 1, ad), hb, up_gain_left,
                  up_lose_right)
        perm_term((au, ad), (au, ad - 1), hb, dn_lose_left,
                  dn_gain_right)
        perm_term((au, ad), (au, ad + 1), hb, dn_gain_left,
                  dn_lose_right)
        # bra-left parities at the right site: (-1)^(au' + ad') of the
        # DESTINATION left block
        jb1 = [(a, b, 0.5 * jpm[a, b]
                * (1 if ((au - 1) + (ad + 1)) % 2 == 0 else -1))
               for (a, b) in jpm_cross]
        perm_term((au, ad), (au - 1, ad + 1), jb1, j_c1_left,
                  j_c1_right)
        jb2 = [(a, b, 0.5 * jpm[a, b]
                * (1 if ((au + 1) + (ad - 1)) % 2 == 0 else -1))
               for (a, b) in jpm_cross]
        perm_term((au, ad), (au + 1, ad - 1), jb2, j_c2_left,
                  j_c2_right)

    bk = BlockKronHamiltonian(
        diag=tuple(diags), row_ops=tuple(row_ops),
        col_ops=tuple(col_ops), cross=(),
        shapes=tuple(shapes), perm_cross=tuple(perm_cross))
    # the half-cut produces ~n^2/4 SMALL blocks: same-padded-shape
    # groups run as one launch per product (per block, every product of
    # every block would be a launch of its own)
    bk = tierize(bk)
    return bk, blocks, lb, rb, nl
