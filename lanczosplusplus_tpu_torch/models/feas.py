"""Multi-orbital Hubbard model for Fe-based superconductors.

Counterpart of ``lanczosplusplus_tpu/models/feas.py``: the flat form
(``hamiltonian``) and the single-block block-Kronecker form
(``block_kron_hamiltonian``).  The basis and the arrays are built on the
host in numpy and moved to the device once.

reference: src/Models/FeBasedSc/{FeBasedSc.h,BasisFeAsBasedSc.h,
BasisOneSpinFeAs.h,ParametersModelFeAs.h}; Hamiltonian documented in
doc/FeBasedSc.tex:69-80.  Model= strings FeAsBasedSc, FeAsBasedScExtended.

Basis: one-spin words with bit layout site*orbitals + orb, enumerated by
orbital-occupation partitions collated over per-orbital combination
bases (BasisOneSpinFeAs.h:44-83, Partitions.h odometer order); pair
index = iu + idown * size_up.

INT_PAPER33 interactions (ParametersModelFeAs.h:157-164):
  U[0] intra-orbital U n_up n_down
  U[1] inter-orbital n_a n_b (= U' - J/2)
  U[2] 0.5 (S+_a S-_b + S-_a S+_b) onsite transverse exchange
  U[3] pair hopping (-J): moves an up+down pair between orbitals
  U[4] Sz_a Sz_b onsite term (defaults to U[2] when 4-5 values given)
  U[5] same-spin inter-orbital n n
plus spin-resolved potentialV[i + (orb + O*spin)*nsite], cross-site
J_PM/J_ZZ couplings from geometry terms 1/2 when present
(FeBasedSc.h:484-520, 594-604), AnisotropyD * (sum_orb Sz_i_orb)^2, and
hopping with h = -geometry(i,orb,j,orb2,0) (FeBasedSc.h:321-324).

All FeAsMode values (INT_PAPER33, INT_V, INT_CODE2, INT_IMPURITY,
INT_KSPACE) are implemented here.  The onsite SpinOrbit 4x4 matrix
needs the spin-mixing union basis and lives in
`models/feas_spinorbit.py` (the registry dispatches there when a
SpinOrbit label is present); constructing this class directly with
SpinOrbit input raises.
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.combinatorics import enumerate_combinations
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy)


def _partitions_reference_order(total: int, parts: int):
    """Compositions of `total` into `parts`, in the reference's odometer
    order (Partitions.h:32-77: digit 0 fastest)."""
    values = [0] * parts
    out = []
    while True:
        if sum(values) == total:
            out.append(tuple(values))
        values[0] += 1
        if sum(values) > total:
            # increaseNextIndices
            if parts == 1:
                break
            values[0] = 0
            i = 1
            bailed = False
            while True:
                values[i] += 1
                if sum(values) <= total:
                    break
                if i == parts - 1:
                    bailed = True
                    break
                values[i] = 0
                i += 1
            if bailed:
                break
    return out


def _spread(words: np.ndarray, nsite: int, orbitals: int,
            orb: int) -> np.ndarray:
    """Map a per-site word into collated layout bit site*orbitals+orb."""
    out = np.zeros_like(words, dtype=WORD)
    for site in range(nsite):
        bit = (words >> WORD(site)) & WORD(1)
        out |= bit << WORD(site * orbitals + orb)
    return out


class FeAsOneSpin:
    """reference: BasisOneSpinFeAs."""

    def __init__(self, nsite: int, npart: int, orbitals: int):
        self.nsite = nsite
        self.npart = npart
        self.orbitals = orbitals
        words = []
        for na in _partitions_reference_order(npart, orbitals):
            per_orb = [
                _spread(enumerate_combinations(nsite, na[o]), nsite,
                        orbitals, o)
                for o in range(orbitals)]
            # orbital 0 index varies fastest (getKets,
            # BasisOneSpinFeAs.h:313-331)
            block = per_orb[0]
            for o in range(1, orbitals):
                block = (per_orb[o][:, None] | block[None, :]).reshape(-1)
            words.append(block)
        self.words = np.concatenate(words) if words else \
            np.zeros(1, dtype=WORD)
        order = np.argsort(self.words, kind="stable")
        self._sorted = self.words[order]
        self._order = order

    @property
    def size(self) -> int:
        return self.words.shape[0]

    def rank(self, words: np.ndarray) -> np.ndarray:
        # rank is evaluated on whole arrays including rows the caller
        # masks out (whose flipped words may be invalid): clip and let
        # the caller's mask discard them
        pos = np.searchsorted(self._sorted, words.astype(WORD))
        pos = np.minimum(pos, self._sorted.shape[0] - 1)
        return self._order[pos]

    def occupation_table(self) -> np.ndarray:
        return bits.bits_to_table(self.words, self.nsite * self.orbitals)


class FeAsBasis:
    """Two-spin product basis, pair index iu + idown*size_up
    (BasisFeAsBasedSc.h:97-99)."""

    def __init__(self, nsite: int, nup: int, ndown: int, orbitals: int):
        self.nsite = nsite
        self.nup = nup
        self.ndown = ndown
        self.orbitals = orbitals
        self.up = FeAsOneSpin(nsite, nup, orbitals)
        self.down = FeAsOneSpin(nsite, ndown, orbitals)

    @property
    def parts(self):
        return (self.nup, self.ndown)

    @property
    def size(self) -> int:
        return self.up.size * self.down.size

    @property
    def spin_shape(self):
        return (self.down.size, self.up.size)

    def words_up(self, i):
        return self.up.words[np.asarray(i) % self.up.size]

    def words_down(self, i):
        return self.down.words[np.asarray(i) // self.up.size]


def _count_range(words, lo, hi):
    """#occupied bits in [lo, hi) per word."""
    if hi <= lo:
        return np.zeros(words.shape, dtype=np.int64)
    return bits.count_range(words, lo, hi)


def _one_spin_dosign(words, i, orb1, j, orb2, orbitals):
    """reference BasisOneSpinFeAs doSign (both same-site and cross-site
    variants, BasisOneSpinFeAs.h:150-181, 252-263); requires i <= j; the
    same-site orb1 > orb2 case negates."""
    if i == j:
        if orb1 > orb2:
            return -_one_spin_dosign(words, i, orb2, j, orb1, orbitals)
        cnt = _count_range(words, i * orbitals + orb1, i * orbitals + orb2)
        return np.where(cnt & 1, -1, 1)
    assert i < j
    cnt = _count_range(words, (i + 1) * orbitals, j * orbitals)
    cnt = cnt + _count_range(words, i * orbitals + orb1,
                             (i + 1) * orbitals)
    cnt = cnt + _count_range(words, j * orbitals, j * orbitals + orb2)
    return np.where(cnt & 1, -1, 1)


def _dosign_gf(words, ind, orb, orbitals):
    """reference BasisOneSpinFeAs.h:225-236 doSignGf."""
    cnt = _count_range(words, 0, ind * orbitals)
    cnt = cnt + _count_range(words, ind * orbitals, ind * orbitals + orb)
    return np.where(cnt & 1, -1, 1)


class FeBasedScModel:
    TERM_HOPPING, TERM_J_PM, TERM_J_ZZ = 0, 1, 2

    is_fermionic = True

    def __init__(self, inp, geometry):
        self.geometry = geometry
        self.norb = inp.integer("Orbitals")
        mode = inp.string("FeAsMode", default="INT_PAPER33")
        if mode not in ("INT_PAPER33", "INT_V", "INT_CODE2",
                        "INT_IMPURITY", "INT_KSPACE"):
            raise ValueError(f"unknown FeAsMode={mode}")
        self.mode = mode
        if inp.has("SpinOrbit"):
            raise NotImplementedError(
                "onsite SpinOrbit matrix needs the spin-mixing basis: "
                "use models.build_model, which dispatches to "
                "FeAsSpinOrbitModel")
        u = list(inp.vector("hubbardU"))
        o_ = inp.integer("Orbitals")
        if mode in ("INT_PAPER33", "INT_IMPURITY"):
            if len(u) < 4 or len(u) > 6:
                raise ValueError(f"{mode} expects 4..6 U values")
            if len(u) < 6:
                u = u + [0.0] * (6 - len(u))
                u[4] = u[2]
                u[5] = 0.0
        elif mode in ("INT_V", "INT_CODE2"):
            want = o_ * o_ * (2 if mode == "INT_CODE2" else 1)
            if len(u) != want:
                raise ValueError(f"{mode}: expecting {want} U values")
        elif mode == "INT_KSPACE":
            if len(u) != 1:
                raise ValueError("INT_KSPACE: expecting 1 U value")
        self.coulomb_v = inp.real("CoulombV", default=0.0)
        self.u = np.array(u, dtype=np.float64)
        self.potential_v = np.array(inp.vector("potentialV"),
                                    dtype=np.float64)
        self.anisotropy_d = inp.real("AnisotropyD", default=0.0)
        n = geometry.number_of_sites()
        o = self.norb
        # hoppings carry an explicit minus sign (FeBasedSc.h:321-324)
        c = geometry.coupling_tensor(0)
        dof = c.shape[2]
        self.hop = np.zeros((n * o, n * o))
        for i in range(n):
            for j in range(n):
                for o1 in range(min(dof, o)):
                    for o2 in range(min(dof, o)):
                        self.hop[i * o + o1, j * o + o2] = -c[i, j, o1, o2]
        self.jpm_site = geometry.coupling_matrix(self.TERM_J_PM) \
            if geometry.terms() > self.TERM_J_PM else np.zeros((n, n))
        self.jzz_site = geometry.coupling_matrix(self.TERM_J_ZZ) \
            if geometry.terms() > self.TERM_J_ZZ else np.zeros((n, n))

    def symmetry_form(self, basis: FeAsBasis,
                      dtype: torch.dtype = torch.float64, device="cpu"):
        """The form symmetry sectors read their rows from: the single-block
        BlockKron form, or None (the flat form) past the size cap of its
        dense one-spin factors."""
        szu, szd = basis.up.size, basis.down.size
        if szu * szu + szd * szd > (1 << 26):
            return None
        return self.block_kron_hamiltonian(basis, dtype=dtype, device=device)

    def create_basis(self, parts) -> FeAsBasis:
        return FeAsBasis(self.geometry.number_of_sites(), parts[0],
                         parts[1], self.norb)

    def default_parts(self, inp):
        return (inp.integer("TargetElectronsUp"),
                inp.integer("TargetElectronsDown"))

    def orbitals(self, site) -> int:
        return self.norb

    def has_new_parts(self, parts, op, spin, orb):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        nup, ndown = parts
        nmax = self.norb * self.geometry.number_of_sites()
        if op.name in (ops.C, ops.CDAGGER):
            c = -1 if op.name == ops.C else 1
            new = (nup + c, ndown) if spin == 0 else (nup, ndown + c)
        elif op.name in (ops.SPLUS, ops.SMINUS):
            c = 1 if op.name == ops.SPLUS else -1
            new = (nup + c, ndown - c)
        elif op.name in (ops.SZ, ops.N, ops.NIL):
            return parts
        else:
            raise ValueError(f"feas hasNewParts: unsupported {op.name}")
        if min(new) < 0 or max(new) > nmax:
            return None
        return new

    # -- Hamiltonian ------------------------------------------------------

    def diagonal(self, basis: FeAsBasis) -> np.ndarray:
        n = self.geometry.number_of_sites()
        o = self.norb
        nu = basis.up.occupation_table().astype(np.float64)   # (szu, n*o)
        nd = basis.down.occupation_table().astype(np.float64)
        u = self.u
        szu, szd = basis.up.size, basis.down.size

        # 2d accumulators over (szd, szu)
        diag2d = np.zeros((szd, szu))

        # potentialV: v[i + (orb + O*spin)*nsite] — all modes
        vu = np.zeros(n * o)
        vd = np.zeros(n * o)
        for i in range(n):
            for orb in range(o):
                vu[i * o + orb] = self.potential_v[i + orb * n]
                vd[i * o + orb] = self.potential_v[i + (orb + o) * n]
        diag2d += (nu @ vu)[None, :] + (nd @ vd)[:, None]

        if self.mode in ("INT_V", "INT_CODE2"):
            # findSdecay (FeBasedSc.h:300-318): U[orb+orb*O] n_up n_dn
            # per orbital + U[orb+orb2*O] n_tot n_tot for orb2 > orb
            for i in range(n):
                for orb in range(o):
                    a = i * o + orb
                    diag2d += u[orb + orb * o] * \
                        nd[:, a][:, None] * nu[:, a][None, :]
                    for orb2 in range(orb + 1, o):
                        b = i * o + orb2
                        na = nu[:, a][None, :] + nd[:, a][:, None]
                        nb2 = nu[:, b][None, :] + nd[:, b][:, None]
                        diag2d += u[orb + orb2 * o] * na * nb2
            return self._diag_tail(diag2d, basis, nu, nd)

        if self.mode == "INT_IMPURITY":
            # findSImpurity (FeBasedSc.h:625-655): site 0 only
            for orb in range(o):
                a = orb
                diag2d += u[0] * nd[:, a][:, None] * nu[:, a][None, :]
                for orb2 in range(o):
                    if orb == orb2:
                        continue
                    b = orb2
                    diag2d += 0.5 * u[1] * \
                        (nu[:, a] * nu[:, b])[None, :]
                    diag2d += 0.5 * u[1] * \
                        (nd[:, a] * nd[:, b])[:, None]
                    diag2d += u[4] * nu[:, a][None, :] * nd[:, b][:, None]
            return self._diag_tail(diag2d, basis, nu, nd)

        if self.mode == "INT_KSPACE":
            # findSkspace (FeBasedSc.h:657-676): site 0;
            # U0 * n_up(orb) * sum_orb2 n_dn(orb2)
            ndtot = nd[:, :o].sum(axis=1)
            nutot = nu[:, :o].sum(axis=1)
            diag2d += u[0] * ndtot[:, None] * nutot[None, :]
            return self._diag_tail(diag2d, basis, nu, nd)

        # INT_PAPER33
        # U0: intra-orbital double occupancy
        diag2d += nd @ (u[0] * nu.T)

        # onsite inter-orbital pairs orb < orb2
        for i in range(n):
            for orb in range(o):
                a = i * o + orb
                for orb2 in range(orb + 1, o):
                    b = i * o + orb2
                    na = nu[:, a][None, :] + nd[:, a][:, None]
                    nb = nu[:, b][None, :] + nd[:, b][:, None]
                    diag2d += u[1] * na * nb
                    sza = 0.5 * (nu[:, a][None, :] - nd[:, a][:, None])
                    szb = 0.5 * (nu[:, b][None, :] - nd[:, b][:, None])
                    diag2d += u[4] * sza * szb
                    diag2d += u[5] * (nu[:, a] * nu[:, b])[None, :]
                    diag2d += u[5] * (nd[:, a] * nd[:, b])[:, None]

        # cross-site J_ZZ: 0.5 sum_{i,j,orb,orb2} Jzz(i,j) sz sz
        if np.any(self.jzz_site):
            # total sz per site: sz_i = 0.5 * sum_orb (nu - nd)
            site_nu = nu.reshape(szu, n, o).sum(axis=2)
            site_nd = nd.reshape(szd, n, o).sum(axis=2)
            quad_u = np.einsum("si,ij,sj->s", site_nu, self.jzz_site,
                               site_nu)
            quad_d = np.einsum("si,ij,sj->s", site_nd, self.jzz_site,
                               site_nd)
            cross = site_nd @ self.jzz_site @ site_nu.T
            diag2d += 0.125 * (quad_u[None, :] + quad_d[:, None]) \
                - 0.25 * cross

        return self._diag_tail(diag2d, basis, nu, nd)

    def _diag_tail(self, diag2d, basis, nu, nd):
        """Anisotropy term shared by all modes (FeBasedSc.h:548-550)."""
        n = self.geometry.number_of_sites()
        o = self.norb
        szu, szd = basis.up.size, basis.down.size
        if self.anisotropy_d:
            site_nu = nu.reshape(szu, n, o).sum(axis=2)
            site_nd = nd.reshape(szd, n, o).sum(axis=2)
            for i in range(n):
                sz_i = 0.5 * (site_nu[:, i][None, :] -
                              site_nd[:, i][:, None])
                diag2d += self.anisotropy_d * sz_i * sz_i
        return diag2d.reshape(-1)

    def hamiltonian(self, basis: FeAsBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        n = self.geometry.number_of_sites()
        o = self.norb
        nb = n * o
        dim = basis.size
        szu, szd = basis.up.size, basis.down.size
        upw, dnw = basis.up.words, basis.down.words
        iu = np.arange(szu, dtype=np.int64)
        idn = np.arange(szd, dtype=np.int64)

        occ_u = {a: bits.get_bit(upw, a) for a in range(nb)}
        occ_d = {a: bits.get_bit(dnw, a) for a in range(nb)}

        hop_pairs = [(a, b) for a in range(nb) for b in range(a + 1, nb)
                     if self.hop[a, b] != 0]
        is_p33 = self.mode == "INT_PAPER33"
        u2_pairs = [(i * o + o1, i * o + o2) for i in range(n)
                    for o1 in range(o) for o2 in range(o1 + 1, o)
                    if is_p33 and (self.u[2] != 0 or self.u[3] != 0)]
        # INT_IMPURITY / INT_KSPACE onsite quartic moves at site 0
        # (setOffDiagonalJimpurity FeBasedSc.h:744-783,
        # setOffDiagonalKspace FeBasedSc.h:785-827): ordered
        # (orb1, orb2, orb3, orb4): up moves orb2 -> orb1, down moves
        # orb4 -> orb3
        quartics = []
        if self.mode == "INT_IMPURITY" and self.u[3] != 0:
            for o1 in range(o):
                for o2 in range(o):
                    if o1 == o2:
                        continue
                    # type 0: down pair (orb3, orb4) = (o2, o1);
                    # type 1: (o1, o2)
                    quartics.append((o1, o2, o2, o1, self.u[3]))
                    quartics.append((o1, o2, o1, o2, self.u[3]))
        if self.mode == "INT_KSPACE" and self.u[0] != 0:
            for o1 in range(o):
                for o2 in range(o):
                    if o1 == o2:
                        continue
                    for o3 in range(o):
                        o4 = (o3 + o1 - o2) % o  # momentum conservation
                        if o3 == o4:
                            continue
                        quartics.append((o1, o2, o3, o4, self.u[0]))
        jpm_pairs = []
        if is_p33 and np.any(self.jpm_site):
            for i in range(n):
                for j in range(i + 1, n):
                    if self.jpm_site[i, j] == 0:
                        continue
                    for o1 in range(o):
                        for o2 in range(o):
                            jpm_pairs.append((i * o + o1, j * o + o2,
                                              self.jpm_site[i, j]))

        k = max(2 * len(u2_pairs) + len(jpm_pairs) + len(quartics), 0)
        cols = np.tile(np.arange(dim, dtype=np.int64)[:, None],
                       (1, max(k, 1)))
        vals = np.zeros((dim, max(k, 1)), dtype=dtype)
        cols3 = cols.reshape(szd, szu, max(k, 1))
        vals3 = vals.reshape(szd, szu, max(k, 1))
        slot = 0

        def site_orb(a):
            return a // o, a % o

        def full_idx(up_t, dn_t):
            return up_t[None, :] + dn_t[:, None] * szu

        base_u = iu
        base_d = idn

        # hopping is spin-conserving: keep it as one-spin Kronecker
        # factors (I (x) A_up + A_dn (x) I) applied as gathers, or as
        # GEMMs after densify_factors(): index memory O(size_spin)
        # instead of the O(dim) broadcast the flat ELL would need
        # (reference builds the full CRS: FeBasedSc.h setupHamiltonian)
        ku = max(len(hop_pairs), 1)
        up_cols = np.tile(iu[:, None], (1, ku))
        up_vals = np.zeros((szu, ku), dtype=dtype)
        dn_cols = np.tile(idn[:, None], (1, ku))
        dn_vals = np.zeros((szd, ku), dtype=dtype)
        for hk, (a, b) in enumerate(hop_pairs):
            i, orb = site_orb(a)
            j, orb2 = site_orb(b)
            h = self.hop[a, b]
            flip = WORD((1 << a) | (1 << b))
            for (wrd, occ, is_up) in ((upw, occ_u, True),
                                      (dnw, occ_d, False)):
                one = (occ[a] + occ[b]) == 1
                extra = np.where(occ[a] == 1, -1, 1)
                sgn = _one_spin_dosign(wrd, i, orb, j, orb2, o)
                amp1 = np.where(one, h * extra * sgn, 0)
                onespin = basis.up if is_up else basis.down
                base = base_u if is_up else base_d
                tgt1 = np.where(one, onespin.rank(wrd ^ flip), base)
                if is_up:
                    up_cols[:, hk] = tgt1
                    up_vals[:, hk] = amp1
                else:
                    dn_cols[:, hk] = tgt1
                    dn_vals[:, hk] = amp1

        # onsite U2 transverse exchange + U3 pair hopping share flips
        for (a, b) in u2_pairs:
            i, o1 = site_orb(a)
            _, o2 = site_orb(b)
            flip = WORD((1 << a) | (1 << b))
            sgn_u = _one_spin_dosign(upw, i, o1, i, o2, o)
            sgn_d = _one_spin_dosign(dnw, i, o1, i, o2, o)
            # U2: S+_{o1} S-_{o2} (and mirror), value U2/2 * jTermSign
            c1 = ((occ_u[b] == 1)[None, :] & (occ_u[a] == 0)[None, :] &
                  (occ_d[a] == 1)[:, None] & (occ_d[b] == 0)[:, None])
            c2 = ((occ_u[a] == 1)[None, :] & (occ_u[b] == 0)[None, :] &
                  (occ_d[b] == 1)[:, None] & (occ_d[a] == 0)[:, None])
            up_t = basis.up.rank(upw ^ flip)
            dn_t = basis.down.rank(dnw ^ flip)
            cond = c1 | c2
            sign = sgn_u[None, :] * sgn_d[:, None]
            cols3[:, :, slot] = np.where(cond, full_idx(up_t, dn_t),
                                         full_idx(base_u, base_d))
            vals3[:, :, slot] = np.where(cond, 0.5 * self.u[2] * sign, 0)
            slot += 1
            # U3 pair hopping: up+down pair moves b -> a or a -> b
            p1 = ((occ_u[b] == 1)[None, :] & (occ_u[a] == 0)[None, :] &
                  (occ_d[b] == 1)[:, None] & (occ_d[a] == 0)[:, None])
            p2 = ((occ_u[a] == 1)[None, :] & (occ_u[b] == 0)[None, :] &
                  (occ_d[a] == 1)[:, None] & (occ_d[b] == 0)[:, None])
            cond = p1 | p2
            cols3[:, :, slot] = np.where(cond, full_idx(up_t, dn_t),
                                         full_idx(base_u, base_d))
            vals3[:, :, slot] = np.where(cond, -self.u[3] * sign, 0)
            slot += 1

        # onsite quartic moves (INT_IMPURITY / INT_KSPACE), site 0
        for (o1, o2, o3, o4, coef) in quartics:
            a1, a2 = o1, o2            # up: remove a2, create a1
            b3, b4 = o3, o4            # down: remove b4, create b3
            flip_u = WORD((1 << a1) | (1 << a2))
            flip_d = WORD((1 << b3) | (1 << b4))
            ok_u = (occ_u[a2] == 1) & (occ_u[a1] == 0)
            ok_d = (occ_d[b4] == 1) & (occ_d[b3] == 0)
            sgn_u = _one_spin_dosign(upw, 0, a1, 0, a2, o)
            sgn_d = _one_spin_dosign(dnw, 0, b3, 0, b4, o)
            up_t = basis.up.rank(upw ^ flip_u)
            dn_t = basis.down.rank(dnw ^ flip_d)
            cond = ok_u[None, :] & ok_d[:, None]
            amp = coef * sgn_u[None, :] * sgn_d[:, None]
            cols3[:, :, slot] = np.where(cond, full_idx(up_t, dn_t),
                                         full_idx(base_u, base_d))
            vals3[:, :, slot] = np.where(cond, amp, 0)
            slot += 1

        # cross-site J_PM transverse exchange, J/2 per direction
        for (a, b, jv) in jpm_pairs:
            i, o1 = site_orb(a)
            j, o2 = site_orb(b)
            flip = WORD((1 << a) | (1 << b))
            sgn_u = _one_spin_dosign(upw, i, o1, j, o2, o)
            sgn_d = _one_spin_dosign(dnw, i, o1, j, o2, o)
            c1 = ((occ_u[b] == 1)[None, :] & (occ_u[a] == 0)[None, :] &
                  (occ_d[a] == 1)[:, None] & (occ_d[b] == 0)[:, None])
            c2 = ((occ_u[a] == 1)[None, :] & (occ_u[b] == 0)[None, :] &
                  (occ_d[b] == 1)[:, None] & (occ_d[a] == 0)[:, None])
            cond = c1 | c2
            up_t = basis.up.rank(upw ^ flip)
            dn_t = basis.down.rank(dnw ^ flip)
            sign = sgn_u[None, :] * sgn_d[:, None]
            cols3[:, :, slot] = np.where(cond, full_idx(up_t, dn_t),
                                         full_idx(base_u, base_d))
            vals3[:, :, slot] = np.where(cond, 0.5 * jv * sign, 0)
            slot += 1

        # cols3 and vals3 are views of cols and vals: the slots are filled
        return hamiltonian_from_numpy(
            self.diagonal(basis).astype(dtype),
            cols if k > 0 else None, vals if k > 0 else None,
            up_cols, up_vals, dn_cols, dn_vals, (szd, szu), device=device,
            dtype=torch_dtype)

    # -- operator maps ----------------------------------------------------

    def block_kron_hamiltonian(self, basis: FeAsBasis,
                               dtype: torch.dtype = torch.float64,
                               device="cpu"):
        """Single-block BlockKron form of the sector Hamiltonian: the
        spin-conserving hops as DENSE one-spin operators (two GEMMs
        through ``factor_matmul`` on the (size_down, size_up) state
        block) and every
        interaction-remainder slot — U2 transverse, U3 pair hopping,
        cross-site J_PM, the INT_IMPURITY/INT_KSPACE quartic moves —
        decomposed into its exact (down-op ⊗ up-op) partial-
        permutation channels (one PermCrossTerm: row and column gathers
        on the 2-D state block in one ``perm_gather`` launch).
        Every slot of `hamiltonian`'s ELL is a sum of ≤2 such products
        (the c1/c2 branches are disjoint), so this form is EXACT.  The
        block layout IS the flat basis order (index = iu + idn*szu),
        so no PermutedHamiltonian wrap is needed.  Reference hot loop:
        src/Models/FeBasedSc/FeBasedSc.h:52-116."""
        from lanczosplusplus_tpu_torch.core.blockkron import (
            BlockKronHamiltonian, make_perm_cross, to_device)

        torch_dtype, dtype = dtype, numpy_dtype(dtype)

        n = self.geometry.number_of_sites()
        o = self.norb
        nb = n * o
        szu, szd = basis.up.size, basis.down.size
        upw, dnw = basis.up.words, basis.down.words
        iu = np.arange(szu, dtype=np.int64)
        idn = np.arange(szd, dtype=np.int64)
        occ_u = {a: bits.get_bit(upw, a) for a in range(nb)}
        occ_d = {a: bits.get_bit(dnw, a) for a in range(nb)}
        cplx = np.iscomplexobj(np.zeros(0, dtype))
        fdt = np.complex128 if cplx else np.float64

        def site_orb(a):
            return a // o, a % o

        # dense one-spin hop operators
        h_up = np.zeros((szu, szu), fdt)
        h_dn = np.zeros((szd, szd), fdt)
        for (a, b) in [(a, b) for a in range(nb)
                       for b in range(a + 1, nb)
                       if self.hop[a, b] != 0]:
            i, orb = site_orb(a)
            j, orb2 = site_orb(b)
            h = self.hop[a, b]
            flip = WORD((1 << a) | (1 << b))
            for (wrd, occ, mat, onespin) in (
                    (upw, occ_u, h_up, basis.up),
                    (dnw, occ_d, h_dn, basis.down)):
                one = (occ[a] + occ[b]) == 1
                extra = np.where(occ[a] == 1, -1, 1)
                sgn = _one_spin_dosign(wrd, i, orb, j, orb2, o)
                amp = np.where(one, h * extra * sgn, 0)
                tgt = onespin.rank(wrd ^ flip)
                rows = np.arange(mat.shape[0])
                np.add.at(mat, (rows[one], tgt[one]), amp[one])

        # interaction channels: (dn_src, dn_amp, up_src, up_amp)
        chans = []

        def add(dn_cond, dn_amp, dn_t, up_cond, up_amp, up_t):
            chans.append((
                np.where(dn_cond, dn_t, 0).astype(np.int64),
                np.where(dn_cond, dn_amp, 0),
                np.where(up_cond, up_t, 0).astype(np.int64),
                np.where(up_cond, up_amp, 0)))

        is_p33 = self.mode == "INT_PAPER33"
        u2_pairs = [(i * o + o1, i * o + o2) for i in range(n)
                    for o1 in range(o) for o2 in range(o1 + 1, o)
                    if is_p33 and (self.u[2] != 0 or self.u[3] != 0)]
        for (a, b) in u2_pairs:
            i, o1 = site_orb(a)
            _, o2 = site_orb(b)
            flip = WORD((1 << a) | (1 << b))
            sgn_u = _one_spin_dosign(upw, i, o1, i, o2, o)
            sgn_d = _one_spin_dosign(dnw, i, o1, i, o2, o)
            up_t = basis.up.rank(upw ^ flip)
            dn_t = basis.down.rank(dnw ^ flip)
            u_c1 = (occ_u[b] == 1) & (occ_u[a] == 0)
            u_c2 = (occ_u[a] == 1) & (occ_u[b] == 0)
            d_c1 = (occ_d[a] == 1) & (occ_d[b] == 0)
            d_c2 = (occ_d[b] == 1) & (occ_d[a] == 0)
            if self.u[2] != 0:
                add(d_c1, 0.5 * self.u[2] * sgn_d, dn_t,
                    u_c1, sgn_u, up_t)
                add(d_c2, 0.5 * self.u[2] * sgn_d, dn_t,
                    u_c2, sgn_u, up_t)
            if self.u[3] != 0:
                d_p1 = (occ_d[b] == 1) & (occ_d[a] == 0)
                d_p2 = (occ_d[a] == 1) & (occ_d[b] == 0)
                add(d_p1, -self.u[3] * sgn_d, dn_t, u_c1, sgn_u, up_t)
                add(d_p2, -self.u[3] * sgn_d, dn_t, u_c2, sgn_u, up_t)
        if self.mode == "INT_IMPURITY" and self.u[3] != 0:
            quartics = []
            for o1 in range(o):
                for o2 in range(o):
                    if o1 != o2:
                        quartics.append((o1, o2, o2, o1, self.u[3]))
                        quartics.append((o1, o2, o1, o2, self.u[3]))
            for (o1, o2, o3, o4, coef) in quartics:
                flip_u = WORD((1 << o1) | (1 << o2))
                flip_d = WORD((1 << o3) | (1 << o4))
                ok_u = (occ_u[o2] == 1) & (occ_u[o1] == 0)
                ok_d = (occ_d[o4] == 1) & (occ_d[o3] == 0)
                sgn_u = _one_spin_dosign(upw, 0, o1, 0, o2, o)
                sgn_d = _one_spin_dosign(dnw, 0, o3, 0, o4, o)
                add(ok_d, coef * sgn_d, basis.down.rank(dnw ^ flip_d),
                    ok_u, sgn_u, basis.up.rank(upw ^ flip_u))
        if self.mode == "INT_KSPACE" and self.u[0] != 0:
            for o1 in range(o):
                for o2 in range(o):
                    if o1 == o2:
                        continue
                    for o3 in range(o):
                        o4 = (o3 + o1 - o2) % o
                        if o3 == o4:
                            continue
                        flip_u = WORD((1 << o1) | (1 << o2))
                        flip_d = WORD((1 << o3) | (1 << o4))
                        ok_u = (occ_u[o2] == 1) & (occ_u[o1] == 0)
                        ok_d = (occ_d[o4] == 1) & (occ_d[o3] == 0)
                        sgn_u = _one_spin_dosign(upw, 0, o1, 0, o2, o)
                        sgn_d = _one_spin_dosign(dnw, 0, o3, 0, o4, o)
                        add(ok_d, self.u[0] * sgn_d,
                            basis.down.rank(dnw ^ flip_d),
                            ok_u, sgn_u, basis.up.rank(upw ^ flip_u))
        if is_p33 and np.any(self.jpm_site):
            for i in range(n):
                for j in range(i + 1, n):
                    jv = self.jpm_site[i, j]
                    if jv == 0:
                        continue
                    for o1 in range(o):
                        for o2 in range(o):
                            a, b = i * o + o1, j * o + o2
                            flip = WORD((1 << a) | (1 << b))
                            sgn_u = _one_spin_dosign(upw, i, o1, j,
                                                     o2, o)
                            sgn_d = _one_spin_dosign(dnw, i, o1, j,
                                                     o2, o)
                            up_t = basis.up.rank(upw ^ flip)
                            dn_t = basis.down.rank(dnw ^ flip)
                            u_c1 = (occ_u[b] == 1) & (occ_u[a] == 0)
                            u_c2 = (occ_u[a] == 1) & (occ_u[b] == 0)
                            d_c1 = (occ_d[a] == 1) & (occ_d[b] == 0)
                            d_c2 = (occ_d[b] == 1) & (occ_d[a] == 0)
                            add(d_c1, 0.5 * jv * sgn_d, dn_t,
                                u_c1, sgn_u, up_t)
                            add(d_c2, 0.5 * jv * sgn_d, dn_t,
                                u_c2, sgn_u, up_t)

        perm_cross = []
        if chans:
            nbch = len(chans)
            row_src = np.stack([c[0] for c in chans])
            row_amp = np.stack([c[1] for c in chans]).astype(fdt)
            col_src = np.stack([c[2] for c in chans])
            col_amp = np.stack([c[3] for c in chans]).astype(fdt)
            perm_cross.append(make_perm_cross(
                row_src, row_amp, col_src, col_amp, 0, 0, torch_dtype,
                device))
        diag2 = np.asarray(self.diagonal(basis)).reshape(szd, szu)
        return BlockKronHamiltonian(
            diag=(to_device(diag2, torch_dtype, device),),
            row_ops=(to_device(h_dn, torch_dtype, device),),
            col_ops=(to_device(h_up, torch_dtype, device),),
            cross=(), shapes=((szd, szu),),
            perm_cross=tuple(perm_cross))

    def operator_map(self, op, site, spin, orb, src_basis: FeAsBasis,
                     dst_basis: FeAsBasis):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        o = self.norb
        upw, dnw = src_basis.up.words, src_basis.down.words
        szu_s = src_basis.up.size
        szu_d = dst_basis.up.size
        orb_scalar = orb if isinstance(orb, (int, np.integer)) else 0
        pos = site * o + orb_scalar
        up_occ = bits.get_bit(upw, pos)
        dn_occ = bits.get_bit(dnw, pos)
        iu = np.arange(src_basis.up.size, dtype=np.int64)
        idn = np.arange(src_basis.down.size, dtype=np.int64)

        def outer(tgt_u, tgt_d, amp_u, amp_d, ok_u, ok_d):
            mask = (ok_u[None, :] & ok_d[:, None]).reshape(-1)
            tgt = (tgt_u[None, :] + tgt_d[:, None] * szu_d).reshape(-1)
            amp = (amp_u[None, :] * amp_d[:, None]).reshape(-1)
            return (np.where(mask, tgt, -1), np.where(mask, amp, 0.0),
                    dst_basis.size)

        name = op.name
        if name in (ops.C, ops.CDAGGER):
            want = 1 if name == ops.C else 0
            flip = WORD(1) << WORD(pos)
            if spin == 0:
                ok = up_occ == want
                tgt_u = np.where(ok, dst_basis.up.rank(upw ^ flip), 0)
                sgn = _dosign_gf(upw, site, orb_scalar, o).astype(np.float64)
                return outer(tgt_u, idn, sgn, np.ones_like(idn, float),
                             ok, np.ones_like(idn, bool))
            ok = dn_occ == want
            tgt_d = np.where(ok, dst_basis.down.rank(dnw ^ flip), 0)
            sgn_d = _dosign_gf(dnw, site, orb_scalar, o).astype(np.float64)
            # crossing all up electrons (BasisFeAsBasedSc.h:170-178)
            sgn_u = np.where(bits.popcount(upw) & 1, -1.0, 1.0)
            return outer(iu, tgt_d, sgn_u, sgn_d,
                         np.ones_like(iu, bool), ok)

        if name == ops.N:
            occ = up_occ if spin == 0 else dn_occ
            if spin == 0:
                return outer(iu, idn, occ.astype(float),
                             np.ones_like(idn, float), occ == 1,
                             np.ones_like(idn, bool))
            return outer(iu, idn, np.ones_like(iu, float),
                         occ.astype(float), np.ones_like(iu, bool),
                         occ == 1)

        if name == ops.CDAGGER_A_UP_C_B_UP:
            # c^dag_{orb a, up} c_{orb b, up} at the site, value 1, same
            # sector (reference: BasisFeAsBasedSc.h:139-141, 381-399;
            # non-fermionic label so no string sign is applied there)
            a, b = orb if isinstance(orb, (tuple, list)) else (0, 1)
            pa, pb = site * o + a, site * o + b
            occ_a = bits.get_bit(upw, pa)
            occ_b = bits.get_bit(upw, pb)
            ok = (occ_b == 1) & (occ_a == 0)
            flip = (WORD(1) << WORD(pa)) | (WORD(1) << WORD(pb))
            tgt_u = np.where(ok, dst_basis.up.rank(upw ^ flip), 0)
            return outer(tgt_u, idn, ok.astype(float),
                         np.ones_like(idn, float), ok,
                         np.ones_like(idn, bool))

        if name == ops.SZ:
            val = up_occ[None, :] - dn_occ[:, None]
            both = (up_occ[None, :] == 1) & (dn_occ[:, None] == 1)
            val = np.where(both, 0, val).reshape(-1)
            idx = (iu[None, :] + idn[:, None] * szu_d).reshape(-1)
            return (np.where(val != 0, idx, -1), val.astype(np.float64),
                    dst_basis.size)

        raise ValueError(f"feas operator_map: unsupported {name}")
