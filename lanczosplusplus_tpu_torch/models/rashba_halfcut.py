"""Spatial half-cut block factorization for the Rashba SOC model.

Counterpart of ``lanczosplusplus_tpu/models/rashba_halfcut.py``:
``build_halfcut_rashba``, with the Jordan-Wigner twist sign and complex
couplings.  The tables are built on the host in numpy; the form lives on
the device it is built for, where the within-half products go through
``factor_matmul`` and the cut-crossing channels through ``perm_gather``.

Reference capability: src/Models/HubbardOneOrbitalRashbaSOC/
{HubbardOneOrbitalRashbaSOC.h,BasisRashbaSOC.h} (total-N union basis);
hot loop to beat: the same model's flat gather ELL and the
(nup, ndown) block-Kronecker form of models/rashba.py, whose
PermCrossTerm spin-flip gathers couple every (nup, ndown) block pair
through every one of the ~26 Rashba bonds at 13 sites.

The answer (same move as models/tj_factored.py): cut the lattice
spatially into L = [0, nl) and R = [nl, n).  Only total N is conserved,
so

    sector(N) = (+)_{aL}  L(aL)  (x)  R(N - aL)

with L(aL)/R(aR) the total-charge union bases (RashbaBasis) of each
half — C(2*nl, aL) states.  EVERYTHING within a half (hopping, Rashba
spin flips, U, V) folds into ONE dense half operator applied as a
per-block GEMM; only the geometry bonds that physically cross the
cut (2 for a periodic chain) remain gather-typed PermCrossTerms.  The
spin-flip gathers — 24/26 of the Rashba bonds on the 13-site chain —
disappear into the GEMMs.

Jordan-Wigner bookkeeping.  The flat basis orders modes (all up sites,
then all dn sites); the half-cut wants (Lup, Ldn, Rup, Rdn) so every
within-half string stays within one factor.  The two orderings differ
per state by (-1)^{au*bu} (moving the bu occupied Rup modes past the
ad... precisely: past the ad occupied Ldn modes gives (-1)^{ad*bu};
we instead keep the FLAT ordering for the matrix elements and apply
the algebraic twist phi = (-1)^{au*bu} that makes every within-half
Rashba string separable — see the channel table in _cross_channels).
The residual per-state phase is carried by PermutedHamiltonian.sign;
within-right Rashba terms keep a (-1)^{aL} block scalar.  All channel
amplitudes below are the flat model's rules (including its two
documented sign fixes, models/rashba.py:191-213) times the twist,
decomposed into (left-state factor) x (right-state factor); validated
elementwise against the flat Hamiltonian in
tests/test_rashba_halfcut.py.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import (
    BlockKronHamiltonian, make_perm_cross, permuted, to_device)
from lanczosplusplus_tpu_torch.models.hubbard import directed_bonds
from lanczosplusplus_tpu_torch.models.rashba import RashbaBasis


def _union_tables(basis: RashbaBasis):
    """Per-state (up_word, dn_word) over a RashbaBasis union."""
    sz = basis.size
    upw = np.zeros(sz, np.uint64)
    dnw = np.zeros(sz, np.uint64)
    for ndown in range(basis.ne + 1):
        blk = basis.block(ndown)
        if blk is None:
            continue
        up, dn, off = blk
        bdim = up.size * dn.size
        upw[off:off + bdim] = np.repeat(up.words, dn.size)
        dnw[off:off + bdim] = np.tile(dn.words, up.size)
    return upw, dnw


def _union_rank(basis: RashbaBasis, upw, dnw, ok):
    """Index of (upw, dnw) in the union basis where `ok`, else 0."""
    idx = np.zeros(upw.shape[0], np.int64)
    nd_of = bits.popcount(dnw)
    for ndown in range(basis.ne + 1):
        blk = basis.block(ndown)
        if blk is None:
            continue
        up, dn, off = blk
        m = ok & (nd_of == ndown)
        if not m.any():
            continue
        idx[m] = off + dn.rank(dnw[m]) + up.rank(upw[m]) * dn.size
    return idx


def _union_offdiag_dense(basis: RashbaBasis, hop, rash, cplx):
    """(hop_part, rash_part) dense off-diagonal operators of the flat
    RashbaSOCModel element rules (models/rashba.py:131-218) on a
    sub-lattice union basis, in the all-up-then-dn mode ordering of
    that sub-lattice.  Kept split so the caller can scale the Rashba
    part by the (-1)^{aL} block scalar of the right half."""
    sz = basis.size
    fdt = np.complex128 if cplx else np.float64
    h_hop = np.zeros((sz, sz), fdt)
    h_rash = np.zeros((sz, sz), fdt)
    upw, dnw = _union_tables(basis)
    rows = np.arange(sz)
    bonds = directed_bonds(hop)
    rbonds = directed_bonds(rash)
    for (i, j, t) in bonds:
        # up hop
        ok = (bits.get_bit(upw, i) == 1) & (bits.get_bit(upw, j) == 0)
        mid = bits.flip_bit(upw, i)
        sgn = bits.parity_sign_below(upw, i) * \
            bits.parity_sign_below(mid, j)
        tgt = _union_rank(basis, bits.flip_bit(mid, j), dnw, ok)
        np.add.at(h_hop, (rows[ok], tgt[ok]), (t * sgn)[ok])
        # dn hop
        ok = (bits.get_bit(dnw, i) == 1) & (bits.get_bit(dnw, j) == 0)
        mid = bits.flip_bit(dnw, i)
        sgn = bits.parity_sign_below(dnw, i) * \
            bits.parity_sign_below(mid, j)
        tgt = _union_rank(basis, upw, bits.flip_bit(mid, j), ok)
        np.add.at(h_hop, (rows[ok], tgt[ok]), (t * sgn)[ok])
    au_par = np.where(bits.popcount(upw) & 1, -1.0, 1.0)
    for (i, j, r) in rbonds:
        # branch A: c^dag_j_up c_i_down (rashba.py:160-181)
        ok = (bits.get_bit(upw, j) == 0) & (bits.get_bit(dnw, i) == 1)
        amp = r * bits.parity_sign_below(upw, j) * au_par * \
            bits.parity_sign_below(dnw, i)
        tgt = _union_rank(basis, bits.flip_bit(upw, j),
                          bits.flip_bit(dnw, i), ok)
        np.add.at(h_rash, (rows[ok], tgt[ok]), amp[ok])
        # branch B: c^dag_j_down c_i_up with the (-1)^(n_up - 1)
        # crossing sign and un-conjugated coupling (the two documented
        # reference-bug fixes, rashba.py:191-213)
        ok = (bits.get_bit(upw, i) == 1) & (bits.get_bit(dnw, j) == 0)
        amp = -r * bits.parity_sign_below(upw, i) * au_par * \
            bits.parity_sign_below(dnw, j)
        tgt = _union_rank(basis, bits.flip_bit(upw, i),
                          bits.flip_bit(dnw, j), ok)
        np.add.at(h_rash, (rows[ok], tgt[ok]), amp[ok])
    return h_hop, h_rash


def _union_diag(basis: RashbaBasis, u, v):
    upw, dnw = _union_tables(basis)
    m = basis.nsite
    nu = bits.bits_to_table(upw, m).astype(np.float64)
    nd = bits.bits_to_table(dnw, m).astype(np.float64)
    return (nu * nd) @ u + (nu + nd) @ v


def build_halfcut_rashba(model, basis, dtype: torch.dtype = torch.float64,
                         device="cpu", cut: int | None = None,
                         cross_dtype=None):
    """Half-cut factorized Hamiltonian for a total-N Rashba sector,
    wrapped (with the JW twist sign) to the flat RashbaBasis order.
    `basis` is the full-lattice RashbaBasis.  `cross_dtype`
    torch.bfloat16 (real inputs only) gathers the cut-crossing terms from
    the state rounded to bf16 (``make_perm_cross``)."""
    torch_dtype, dtype = dtype, numpy_dtype(dtype)
    n = model.geometry.number_of_sites()
    ne = basis.ne
    nl = cut if cut is not None else n // 2
    nr = n - nl
    cplx = np.iscomplexobj(np.zeros(0, dtype))
    hops = model.hoppings
    rash = model.rashba
    u = model.params.hubbard_u
    v = model.params.potential_v[:n]

    # crossing directed bonds, split by which half holds i
    hop_lr = [(i, j, t) for (i, j, t) in directed_bonds(hops)
              if i < nl <= j]
    hop_rl = [(i, j, t) for (i, j, t) in directed_bonds(hops)
              if j < nl <= i]
    ra_lr = [(i, j, r) for (i, j, r) in directed_bonds(rash)
             if i < nl <= j]
    ra_rl = [(i, j, r) for (i, j, r) in directed_bonds(rash)
             if j < nl <= i]

    blocks = []
    lb, rb = {}, {}
    for aL in range(max(0, ne - 2 * nr), min(2 * nl, ne) + 1):
        left = RashbaBasis(nl, aL)
        right = RashbaBasis(nr, ne - aL)
        if left.size == 0 or right.size == 0:
            continue
        blocks.append(aL)
        lb[aL], rb[aL] = left, right
    pos = {b: i for i, b in enumerate(blocks)}

    shapes, diags, row_ops, col_ops = [], [], [], []
    ltab, rtab = {}, {}
    for aL in blocks:
        left, right = lb[aL], rb[aL]
        shapes.append((left.size, right.size))
        dl = _union_diag(left, u[:nl], v[:nl])
        dr = _union_diag(right, u[nl:], v[nl:])
        diags.append(to_device(dl[:, None] + dr[None, :], torch_dtype,
                               device))
        lhop, lrash = _union_offdiag_dense(
            left, hops[:nl, :nl], rash[:nl, :nl], cplx)
        # within-right Rashba keeps the (-1)^{aL} block scalar left
        # over from the twist (module docstring)
        rhop, rrash = _union_offdiag_dense(
            right, hops[nl:, nl:], rash[nl:, nl:], cplx)
        row_ops.append(to_device(lhop + lrash, torch_dtype, device))
        scal = 1.0 if aL % 2 == 0 else -1.0
        col_ops.append(to_device(rhop + scal * rrash, torch_dtype, device))
        ltab[aL] = _union_tables(left)
        rtab[aL] = _union_tables(right)

    # ---- cut-crossing channels -------------------------------------
    # Each channel: per-destination-state (source index, amplitude) on
    # each factor, flat rules x twist, decomposed (module docstring).
    fdt = np.complex128 if cplx else np.float64

    def left_parities(aL):
        upw, dnw = ltab[aL]
        return upw, dnw, bits.popcount(upw), bits.popcount(dnw)

    def right_parities(aL):
        upw, dnw = rtab[aL]
        return upw, dnw, bits.popcount(upw), bits.popcount(dnw)

    def sgn(x):
        return np.where(x & 1, -1.0, 1.0)

    perm_cross = []

    def add_term(dst_aL, src_aL, chans):
        """chans: list of (left_fn, right_fn); each fn(dst_aL, src_aL)
        -> (src_idx, amp) arrays over that factor's dst states."""
        if src_aL not in pos or not chans:
            return
        nb = len(chans)
        szl, szr = lb[dst_aL].size, rb[dst_aL].size
        row_src = np.zeros((nb, szl), np.int32)
        row_amp = np.zeros((nb, szl), fdt)
        col_src = np.zeros((nb, szr), np.int32)
        col_amp = np.zeros((nb, szr), fdt)
        for k, (lf, rf) in enumerate(chans):
            li, la = lf(dst_aL, src_aL)
            ri, ra = rf(dst_aL, src_aL)
            row_src[k], row_amp[k] = li, la
            col_src[k], col_amp[k] = ri, ra
        # shared-row-map channel groups (e.g. the up-hop and Rashba-
        # branch-B channels of the same crossing bond reuse one row
        # gather) + the optional bf16 source block: make_perm_cross
        perm_cross.append(make_perm_cross(
            row_src, row_amp, col_src, col_amp,
            pos[src_aL], pos[dst_aL], torch_dtype, device, cross_dtype))

    # left/right factor maps; i is a full-lattice site, j' = j - nl
    def l_up_lose(i, t_or_one):
        def fn(dst, src):
            upw, dnw, au, ad = left_parities(dst)
            ok = bits.get_bit(upw, i) == 1
            idx = _union_rank(lb[src], bits.flip_bit(upw, i), dnw, ok)
            amp = t_or_one * bits.parity_sign_below(upw, i)
            return idx, np.where(ok, amp, 0)
        return fn

    def l_up_gain(j, t_or_one, aL_scal=False):
        def fn(dst, src):
            upw, dnw, au, ad = left_parities(dst)
            ok = bits.get_bit(upw, j) == 0
            idx = _union_rank(lb[src], bits.flip_bit(upw, j), dnw, ok)
            amp = t_or_one * bits.parity_sign_below(upw, j)
            if aL_scal:
                amp = amp * (1.0 if dst % 2 == 0 else -1.0)
            return idx, np.where(ok, amp, 0)
        return fn

    def l_dn_lose(i, t, extra):
        """extra in {'ad-1', 'au'} — the left-side twist/parity factor."""
        def fn(dst, src):
            upw, dnw, au, ad = left_parities(dst)
            ok = bits.get_bit(dnw, i) == 1
            idx = _union_rank(lb[src], upw, bits.flip_bit(dnw, i), ok)
            amp = t * bits.parity_sign_below(dnw, i)
            amp = amp * (sgn(ad - 1) if extra == "ad-1" else sgn(au))
            return idx, np.where(ok, amp, 0)
        return fn

    def l_dn_gain(j, t, extra):
        def fn(dst, src):
            upw, dnw, au, ad = left_parities(dst)
            ok = bits.get_bit(dnw, j) == 0
            idx = _union_rank(lb[src], upw, bits.flip_bit(dnw, j), ok)
            amp = t * bits.parity_sign_below(dnw, j)
            amp = amp * (sgn(ad) if extra == "ad" else sgn(au))
            return idx, np.where(ok, amp, 0)
        return fn

    def r_up_gain(jp, extra):
        """extra in {'bu', None}."""
        def fn(dst, src):
            upw, dnw, bu, bd = right_parities(dst)
            ok = bits.get_bit(upw, jp) == 0
            idx = _union_rank(rb[src], bits.flip_bit(upw, jp), dnw, ok)
            amp = bits.parity_sign_below(upw, jp)
            if extra == "bu":
                amp = amp * sgn(bu)
            return idx, np.where(ok, amp, 0)
        return fn

    def r_up_lose(ip, extra):
        """extra in {'bu+1', 'bu-1'}."""
        def fn(dst, src):
            upw, dnw, bu, bd = right_parities(dst)
            ok = bits.get_bit(upw, ip) == 1
            idx = _union_rank(rb[src], bits.flip_bit(upw, ip), dnw, ok)
            amp = bits.parity_sign_below(upw, ip) * sgn(bu + 1)
            return idx, np.where(ok, amp, 0)
        return fn

    def r_dn_gain(jp):
        def fn(dst, src):
            upw, dnw, bu, bd = right_parities(dst)
            ok = bits.get_bit(dnw, jp) == 0
            idx = _union_rank(rb[src], upw, bits.flip_bit(dnw, jp), ok)
            amp = bits.parity_sign_below(dnw, jp)
            return idx, np.where(ok, amp, 0)
        return fn

    def r_dn_lose(ip):
        def fn(dst, src):
            upw, dnw, bu, bd = right_parities(dst)
            ok = bits.get_bit(dnw, ip) == 1
            idx = _union_rank(rb[src], upw, bits.flip_bit(dnw, ip), ok)
            amp = bits.parity_sign_below(dnw, ip)
            return idx, np.where(ok, amp, 0)
        return fn

    for aL in blocks:
        down, up_ = [], []   # channels into src = aL-1 / aL+1
        for (i, j, t) in hop_lr:     # up-hop, electron leaves left i
            down.append((l_up_lose(i, t), r_up_gain(j - nl, "bu")))
        for (i, j, t) in hop_rl:     # up-hop, electron arrives left j
            up_.append((l_up_gain(j, t), r_up_lose(i - nl, "bu+1")))
        for (i, j, t) in hop_lr:     # dn-hop, leaves left i
            down.append((l_dn_lose(i, t, "ad-1"), r_dn_gain(j - nl)))
        for (i, j, t) in hop_rl:     # dn-hop, arrives left j
            up_.append((l_dn_gain(j, t, "ad"), r_dn_lose(i - nl)))
        for (i, j, r) in ra_lr:      # branch A, j in R: dn leaves L
            down.append((l_dn_lose(i, r, "au"), r_up_gain(j - nl, "bu")))
        for (i, j, r) in ra_rl:      # branch A, j in L: up gained in L
            up_.append((l_up_gain(j, r, aL_scal=True),
                        r_dn_lose(i - nl)))
        for (i, j, r) in ra_lr:      # branch B, j in R: up leaves L
            # (-1)^{aL-1} block scalar folded here
            s = r * (1.0 if (aL - 1) % 2 == 0 else -1.0)
            down.append((l_up_lose(i, s), r_dn_gain(j - nl)))
        for (i, j, r) in ra_rl:      # branch B, j in L: dn gained in L
            up_.append((l_dn_gain(j, r, "au"),
                        r_up_lose(i - nl, "bu-1")))
        add_term(aL, aL - 1, down)
        add_term(aL, aL + 1, up_)

    bk = BlockKronHamiltonian(
        diag=tuple(diags), row_ops=tuple(row_ops),
        col_ops=tuple(col_ops), cross=(),
        shapes=tuple(shapes), perm_cross=tuple(perm_cross))

    # ---- flat-order wrap with the twist sign -----------------------
    perm = np.empty(bk.dim, dtype=np.int64)
    sign = np.empty(bk.dim, dtype=np.float64)
    off = 0
    for aL, (szl, szr) in zip(blocks, bk.shapes):
        lupw, ldnw = ltab[aL]
        rupw, rdnw = rtab[aL]
        gup = lupw[:, None] | (rupw[None, :] << WORD(nl))
        gdn = ldnw[:, None] | (rdnw[None, :] << WORD(nl))
        ok = np.ones(szl * szr, bool)
        perm[off:off + szl * szr] = _union_rank(
            basis, gup.reshape(-1), gdn.reshape(-1), ok)
        au = bits.popcount(lupw).astype(np.int64)
        bu = bits.popcount(rupw).astype(np.int64)
        sign[off:off + szl * szr] = np.where(
            (au[:, None] * bu[None, :]) % 2, -1.0, 1.0).reshape(-1)
        off += szl * szr
    return permuted(bk, perm, sign)
