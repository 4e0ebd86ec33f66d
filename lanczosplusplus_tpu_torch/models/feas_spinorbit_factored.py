"""FeAs + onsite SpinOrbit in block-Kronecker form.

Counterpart of ``lanczosplusplus_tpu/models/feas_spinorbit_factored.py``:
``build_factored_feas_spinorbit`` (complex128).  The tables are built on
the host in numpy; the form lives on the device it is built for, where
the hop products go through ``factor_matmul`` and every channel through
``perm_gather``.

The spin-mixing union basis (reference:
src/Models/FeBasedSc/BasisFeAsSpinOrbit.h:48-71) is a direct sum of
(nu, nd) product blocks, so every term of the flat gather-ELL
Hamiltonian (models/feas_spinorbit.py) factorizes:

- same-spin hoppings: dense per-block one-spin operators -> GEMMs;
- the Kanamori diagonal (U0/U1/U4/U5 + potentials + SO diagonal +
  AnisotropyD): per-block dense tables from quadratic forms of the
  occupation tables;
- U2 (transverse S_a.S_b) and U3 (pair hopping), onsite: both words
  flip two orbitals -> block-preserving PermCrossTerms (row gather (x)
  column gather);
- same-spin SpinOrbit moves: one-word partial permutations (identity
  on the other factor);
- cross-spin SpinOrbit moves: (nu, nd) -> (nu -+ 1, nd +- 1)
  PermCrossTerms with the (-1)^{n_up} crossing parity folded in as a
  per-block constant.

Element rules mirror the flat path exactly (same masks/signs,
evaluated on the ket = destination row, matching the ELL row
convention) and are validated by to_dense equality in
tests/test_feas_spinorbit.py.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import (
    BlockKronHamiltonian, make_perm_cross, permuted, to_device)
from lanczosplusplus_tpu_torch.models.feas import (FeAsOneSpin,
                                                   _one_spin_dosign,
                                                   _dosign_gf)


def build_factored_feas_spinorbit(model, basis,
                                  dtype: torch.dtype = torch.complex128,
                                  device="cpu"):
    """Block-Kronecker Hamiltonian wrapped to the flat (sorted-key)
    FeAsSpinOrbitBasis order; a real `dtype` is taken to its complex
    counterpart, as the flat model does."""
    if not dtype.is_complex:
        dtype = (torch.complex128 if dtype == torch.float64
                 else torch.complex64)
    n = model.geometry.number_of_sites()
    o = model.norb
    nbits = n * o
    ne = basis.ne
    u = model.u
    so = model.spin_orbit

    # -- diagonal quadratic-form weights (ket occupancies) -------------
    w_uu = np.zeros((nbits, nbits))
    w_dd = np.zeros((nbits, nbits))
    w_ud = np.zeros((nbits, nbits))
    lin_u = np.zeros(nbits)
    lin_d = np.zeros(nbits)
    for i in range(n):
        for orb in range(o):
            a = i * o + orb
            w_ud[a, a] += u[0]
            lin_u[a] += model.potential_v[i + orb * n]
            lin_d[a] += model.potential_v[i + (orb + o) * n]
            lin_u[a] += np.real(so[0, orb + orb * o])
            lin_d[a] += np.real(so[3, orb + orb * o])
            for orb2 in range(orb + 1, o):
                b = i * o + orb2
                w_uu[a, b] += u[1] + 0.25 * u[4] + u[5]
                w_dd[a, b] += u[1] + 0.25 * u[4] + u[5]
                w_ud[a, b] += u[1] - 0.25 * u[4]
                w_ud[b, a] += u[1] - 0.25 * u[4]
    if model.anisotropy_d:
        d4 = 0.25 * model.anisotropy_d
        for i in range(n):
            for o1 in range(o):
                for o2 in range(o):
                    a, b = i * o + o1, i * o + o2
                    w_uu[a, b] += d4
                    w_dd[a, b] += d4
                    w_ud[a, b] -= 2 * d4 if a == b else 0
                    if a != b:
                        w_ud[a, b] -= d4
                        w_ud[b, a] -= d4

    hop_pairs = [(a, b) for a in range(nbits)
                 for b in range(a + 1, nbits) if model.hop[a, b] != 0]
    u2_pairs = [(i * o + o1, i * o + o2) for i in range(n)
                for o1 in range(o) for o2 in range(o1 + 1, o)
                if u[2] != 0 or u[3] != 0]
    so_moves = []
    for i in range(n):
        for o1 in range(o):
            for o2 in range(o):
                for s1 in range(2):
                    for s2 in range(2):
                        val = so[s1 + 2 * s2, o1 + o * o2]
                        if val == 0 or (s1 == s2 and o1 == o2):
                            continue
                        so_moves.append((i, o1, s1, o2, s2, val))

    def hop_dense(one: FeAsOneSpin):
        a_m = np.zeros((one.size, one.size))
        rows = np.arange(one.size)
        for (a, b) in hop_pairs:
            i, orb = a // o, a % o
            j, orb2 = b // o, b % o
            h = model.hop[a, b]
            occ_a = bits.get_bit(one.words, a)
            occ_b = bits.get_bit(one.words, b)
            one_e = (occ_a + occ_b) == 1
            extra = np.where(occ_a == 1, -1, 1)
            sgn = _one_spin_dosign(one.words, i, orb, j, orb2, o)
            flip = WORD((1 << a) | (1 << b))
            tgt = one.rank(one.words ^ flip)
            np.add.at(a_m, (rows[one_e], tgt[one_e]),
                      (h * extra * sgn)[one_e])
        return a_m

    # -- blocks ---------------------------------------------------------
    blocks = []
    ub, db = {}, {}
    for nu in range(ne + 1):
        nd = ne - nu
        if nu > nbits or nd > nbits:
            continue
        up = FeAsOneSpin(n, nu, o)
        dn = FeAsOneSpin(n, nd, o)
        if up.size == 0 or dn.size == 0:
            continue
        blocks.append(nu)
        ub[nu], db[nu] = up, dn
    pos = {nu: i for i, nu in enumerate(blocks)}

    shapes, diags, row_ops, col_ops = [], [], [], []
    hop_cache = {}
    for nu in blocks:
        up, dn = ub[nu], db[nu]
        shapes.append((up.size, dn.size))
        nu_t = up.occupation_table().astype(np.float64)
        nd_t = dn.occupation_table().astype(np.float64)
        quad_u = np.einsum("sa,ab,sb->s", nu_t, w_uu, nu_t)
        quad_d = np.einsum("sa,ab,sb->s", nd_t, w_dd, nd_t)
        d2 = quad_u[:, None] + quad_d[None, :] + nu_t @ w_ud @ nd_t.T
        d2 = d2 + (nu_t @ lin_u)[:, None] + (nd_t @ lin_d)[None, :]
        diags.append(to_device(d2, dtype, device))
        for side, one in (("u", up), ("d", dn)):
            key = one.npart
            if key not in hop_cache:
                hop_cache[key] = hop_dense(one)
        row_ops.append(to_device(hop_cache[up.npart], dtype, device))
        col_ops.append(to_device(hop_cache[dn.npart], dtype, device))

    perm_cross = []

    def add_perm(src_nu, dst_nu, row_src, row_amp, col_src, col_amp):
        # shared-row-map channels reuse one row gather (make_perm_cross
        # computes the groups; complex scalars keep full precision)
        perm_cross.append(make_perm_cross(
            np.asarray(row_src, np.int32), row_amp,
            np.asarray(col_src, np.int32), col_amp,
            pos[src_nu], pos[dst_nu], dtype, device))

    for nu in blocks:
        up, dn = ub[nu], db[nu]
        upw, dnw = up.words, dn.words
        szu, szd = up.size, dn.size

        # U2 / U3: both words flip the same onsite orbital pair
        if u2_pairs:
            nb2 = len(u2_pairs)
            for (cond_u, cond_d, amp_fn) in (
                # u2 c1: up b->a, dn a->b
                (lambda oa, ob: (ob == 1) & (oa == 0),
                 lambda oa, ob: (oa == 1) & (ob == 0),
                 lambda sgn: 0.5 * u[2] * sgn),
                # u2 c2: up a->b, dn b->a
                (lambda oa, ob: (oa == 1) & (ob == 0),
                 lambda oa, ob: (ob == 1) & (oa == 0),
                 lambda sgn: 0.5 * u[2] * sgn),
                # u3 p1: both b->a
                (lambda oa, ob: (ob == 1) & (oa == 0),
                 lambda oa, ob: (ob == 1) & (oa == 0),
                 lambda sgn: -u[3] * sgn),
                # u3 p2: both a->b
                (lambda oa, ob: (oa == 1) & (ob == 0),
                 lambda oa, ob: (oa == 1) & (ob == 0),
                 lambda sgn: -u[3] * sgn),
            ):
                rs = np.zeros((nb2, szu), np.int64)
                ra = np.zeros((nb2, szu))
                cs = np.zeros((nb2, szd), np.int64)
                ca = np.zeros((nb2, szd))
                for k, (a, b) in enumerate(u2_pairs):
                    i, o1 = a // o, a % o
                    o2 = b % o
                    flip = WORD((1 << a) | (1 << b))
                    oua = bits.get_bit(upw, a)
                    oub = bits.get_bit(upw, b)
                    oda = bits.get_bit(dnw, a)
                    odb = bits.get_bit(dnw, b)
                    mu = cond_u(oua, oub)
                    md = cond_d(oda, odb)
                    sgn_u = _one_spin_dosign(upw, i, o1, i, o2, o)
                    sgn_d = _one_spin_dosign(dnw, i, o1, i, o2, o)
                    rs[k] = np.where(mu, up.rank(upw ^ flip), 0)
                    ra[k] = np.where(mu, amp_fn(sgn_u), 0)
                    cs[k] = np.where(md, dn.rank(dnw ^ flip), 0)
                    ca[k] = np.where(md, sgn_d, 0)
                add_perm(nu, nu, rs, ra, cs, ca)

        # same-spin SpinOrbit moves (one-word partial permutations)
        for word_s in (0, 1):
            moves = [m for m in so_moves if m[2] == m[4] == word_s]
            if not moves:
                continue
            one = up if word_s == 0 else dn
            other_sz = szd if word_s == 0 else szu
            w = one.words
            nbm = len(moves)
            ms = np.zeros((nbm, one.size), np.int64)
            ma = np.zeros((nbm, one.size), dtype=np.complex128)
            for k, (i, o1, s1, o2, s2, val) in enumerate(moves):
                i1, i2 = i * o + o1, i * o + o2
                ok = (bits.get_bit(w, i1) == 1) & \
                     (bits.get_bit(w, i2) == 0)
                flip = WORD((1 << i1) | (1 << i2))
                sgn = _one_spin_dosign(w, i, min(o1, o2), i,
                                       max(o1, o2), o)
                if o1 > o2:
                    sgn = -sgn
                ms[k] = np.where(ok, one.rank(w ^ flip), 0)
                ma[k] = np.where(ok, val * sgn, 0)
            ident = np.broadcast_to(np.arange(other_sz), (nbm, other_sz))
            ones = np.ones((nbm, other_sz))
            if word_s == 0:
                add_perm(nu, nu, ms, ma, ident, ones)
            else:
                add_perm(nu, nu, ident, ones, ms, ma)

        # cross-spin SpinOrbit moves: block nu <-> nu -+ 1.  The flat
        # path's ket-row convention makes this block the DESTINATION;
        # the source block holds the flipped words.
        for (s1, s2) in ((0, 1), (1, 0)):
            moves = [m for m in so_moves if m[2] == s1 and m[4] == s2]
            if not moves:
                continue
            src_nu = nu - 1 if s1 == 0 else nu + 1
            if src_nu not in pos:
                continue
            up2, dn2 = ub[src_nu], db[src_nu]
            nbm = len(moves)
            rs = np.zeros((nbm, szu), np.int64)
            ra = np.zeros((nbm, szu), dtype=np.complex128)
            cs = np.zeros((nbm, szd), np.int64)
            ca = np.zeros((nbm, szd), dtype=np.complex128)
            s_par = 1.0 if nu % 2 == 0 else -1.0   # (-1)^{n_up_tot}
            for k, (i, o1, _, o2, _, val) in enumerate(moves):
                iu_site = i * o + (o1 if s1 == 0 else o2)
                id_site = i * o + (o1 if s1 == 1 else o2)
                oku = bits.get_bit(upw, iu_site) == (1 if s1 == 0 else 0)
                okd = bits.get_bit(dnw, id_site) == (1 if s1 == 1 else 0)
                x = -1.0 if s1 == 1 else 1.0
                if s1 == 1:
                    g_u = _dosign_gf(upw, i, o2, o)
                    g_d = _dosign_gf(dnw, i, o1, o)
                else:
                    g_u = _dosign_gf(upw, i, o1, o)
                    g_d = _dosign_gf(dnw, i, o2, o)
                rs[k] = np.where(oku, up2.rank(
                    bits.flip_bit(upw, iu_site)), 0)
                ra[k] = np.where(oku, val * x * s_par * g_u, 0)
                cs[k] = np.where(okd, dn2.rank(
                    bits.flip_bit(dnw, id_site)), 0)
                ca[k] = np.where(okd, g_d, 0)
            add_perm(src_nu, nu, rs, ra, cs, ca)

    bk = BlockKronHamiltonian(
        diag=tuple(diags), row_ops=tuple(row_ops),
        col_ops=tuple(col_ops), cross=(),
        shapes=tuple(shapes), perm_cross=tuple(perm_cross))

    # wrap to the flat (sorted combined key) basis order
    perm = np.empty(bk.dim, dtype=np.int64)
    off = 0
    for nu, (su, sd) in zip(blocks, bk.shapes):
        up, dn = ub[nu], db[nu]
        uw = np.repeat(up.words, sd)
        dw = np.tile(dn.words, su)
        perm[off:off + su * sd] = basis.rank(uw, dw)
        off += su * sd
    return permuted(bk, perm)
