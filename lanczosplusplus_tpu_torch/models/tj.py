"""t-J model (multi-orbital capable, no double occupancy).

Counterpart of ``lanczosplusplus_tpu/models/tj.py``.  The basis and the
arrays are built on the host in numpy and moved to the device once
(``hamiltonian_from_numpy``).

reference: src/Models/TjMultiOrb/{TjMultiOrb.h,BasisTjMultiOrbLanczos.h,
ParametersTjMultiOrb.h}.  Four geometry terms: hopping (0), J_pm (1),
J_zz (2), W = ninj (3) (TjMultiOrb.h:63-79).

Basis: one bit per (site, orbital) per spin word; constraint: no
(site, orbital) doubly occupied (combineAndFilter,
BasisTjMultiOrbLanczos.h:354-370); states sorted by the combined word
(down << nbits) | up; additionally nup + ndown <= nsite for sector maps
(TjMultiOrb.h:553, 580).

Hamiltonian (orbitals = 1 is the standard t-J chain):
- hopping with no-double-occupancy guards on the destination site
  (TjMultiOrb.h:649-695), single pass i < j with boundary extraSign;
- diagonal: potentialV (spin- and orbital-resolved), Jzz/4 SzSz, W ninj
  with multi-orbital projector factors proi*proj (TjMultiOrb.h:586-647);
- (J_pm/2) S+_i S-_j exchange with explicit parity-string signs
  evaluated on the bra words (TjMultiOrb.h:697-800).

Design: everything is whole-dim ELL (the occupancy constraint
couples the spin words, so no Kronecker factorization); rank is a
searchsorted on the sorted combined-word array (replaces the
reference's bounded binary search, BasisTjMultiOrbLanczos.h:70-105).

`JHundInfinity` (reinterpretAndTruncate, TjMultiOrb.h:201-294) rotates
per-site states 6/9 into bonding/antibonding combinations and truncates
the removed codes; see _reinterpret_and_truncate.
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.combinatorics import enumerate_combinations
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, coo_to_ell, hamiltonian_from_numpy)


class TjBasis:
    def __init__(self, nsite: int, nup: int, ndown: int, orbitals: int = 1):
        self.nsite = nsite
        self.nup = nup
        self.ndown = ndown
        self.orbitals = orbitals
        nbits = nsite * orbitals
        self.nbits = nbits
        # O(dim) construction (never the O(C(n,nup) * C(n,ndn)) pair
        # mask): for each down word, the allowed up words are all
        # nup-subsets of its complement, deposited into the free bit
        # positions.  The order-preserving deposit keeps up words
        # ascending within each dn block, and dn blocks are ascending,
        # so the combined key array comes out sorted — no argsort.
        dns = enumerate_combinations(nbits, ndown)
        nf = nbits - ndown
        if nup > nf:
            self.key = np.zeros(0, dtype=WORD)
            self.up_words = np.zeros(0, dtype=WORD)
            self.dn_words = np.zeros(0, dtype=WORD)
            return
        patterns = enumerate_combinations(nf, nup)
        occ = bits.bits_to_table(dns, nbits)               # (D, nbits)
        d = dns.shape[0]
        free_pos = (np.nonzero(1 - occ)[1].reshape(d, nf)
                    if nf else np.zeros((d, 0), dtype=np.int64))
        p = patterns.shape[0]
        up = np.zeros((d, p), dtype=WORD)
        for j in range(nf):
            bit = ((patterns >> WORD(j)) & WORD(1))[None, :]
            up |= bit << free_pos[:, j:j + 1].astype(WORD)
        self.up_words = up.reshape(-1)
        self.dn_words = np.repeat(dns, p)
        self.key = (self.dn_words.astype(np.uint64) << WORD(nbits)) \
            | self.up_words

    @property
    def parts(self):
        return (self.nup, self.ndown)

    @property
    def size(self) -> int:
        return self.key.shape[0]

    def rank(self, up_w: np.ndarray, dn_w: np.ndarray) -> np.ndarray:
        key = (dn_w.astype(WORD) << WORD(self.nbits)) | up_w
        return np.minimum(np.searchsorted(self.key, key),
                          self.size - 1)

    def contains(self, up_w: np.ndarray, dn_w: np.ndarray) -> np.ndarray:
        """True where (up, down) is a valid constrained state (used to
        guard operator strings that can leave the t-J space)."""
        key = (dn_w.astype(WORD) << WORD(self.nbits)) | up_w
        pos = np.minimum(np.searchsorted(self.key, key), self.size - 1)
        return self.key[pos] == key


class TjMultiOrbModel:
    is_fermionic = True

    def __init__(self, inp, geometry):
        self.geometry = geometry
        self.norb = inp.integer("Orbitals", default=1)
        self.reinterpret = inp.integer("JHundInfinity", default=0)
        if self.reinterpret and self.norb != 2:
            raise ValueError("JHundInfinity needs Orbitals=2")
        n = geometry.number_of_sites()
        nb = n * self.norb
        self.hop = np.zeros((nb, nb))
        self.jpm = np.zeros((nb, nb))
        self.jzz = np.zeros((nb, nb))
        self.w = np.zeros((nb, nb))
        terms = geometry.terms()
        for (mat, t) in ((self.hop, 0), (self.jpm, 1), (self.jzz, 2),
                         (self.w, 3)):
            if t >= terms:
                continue
            c = geometry.coupling_tensor(t)
            dof = c.shape[2]
            for i in range(n):
                for j in range(n):
                    for o1 in range(min(dof, self.norb)):
                        for o2 in range(min(dof, self.norb)):
                            mat[i * self.norb + o1,
                                j * self.norb + o2] = c[i, j, o1, o2]
        pv = np.array(inp.vector("potentialV", default=[]), dtype=np.float64)
        self.potential_v = pv

    def symmetry_form(self, basis: TjBasis,
                      dtype: torch.dtype = torch.float64, device="cpu"):
        """The form symmetry sectors read their rows from: the spatial
        half-cut BlockKron form, or None where this basis has none."""
        from lanczosplusplus_tpu_torch.models.tj_factored import (
            build_factored_tj)
        return build_factored_tj(self, basis, dtype=dtype, device=device)

    def create_basis(self, parts) -> TjBasis:
        return TjBasis(self.geometry.number_of_sites(), parts[0], parts[1],
                       self.norb)

    def default_parts(self, inp):
        return (inp.integer("TargetElectronsUp"),
                inp.integer("TargetElectronsDown"))

    def orbitals(self, site) -> int:
        return self.norb

    def has_new_parts(self, parts, op, spin, orb):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        nup, ndown = parts
        nsite = self.geometry.number_of_sites()
        if op.name in (ops.C, ops.CDAGGER):
            c = -1 if op.name == ops.C else 1
            new = (nup + c, ndown) if spin == 0 else (nup, ndown + c)
        elif op.name in (ops.SPLUS, ops.SMINUS):
            c = 1 if op.name == ops.SPLUS else -1
            if spin == 0:
                new = (nup + c, ndown - c)
            else:
                new = (nup - c, ndown + c)
        elif op.name in (ops.SZ, ops.N, ops.NIL):
            return parts
        else:
            raise ValueError(f"tj hasNewParts: unsupported {op.name}")
        # (0, 0) allowed as a capability extension (see hubbard.py)
        if min(new) < 0 or max(new) > nsite:
            return None
        if new[0] + new[1] > nsite:
            return None  # no double occupancy
        return new

    # -- Hamiltonian ------------------------------------------------------

    def _occupations(self, basis: TjBasis):
        nu = bits.bits_to_table(basis.up_words, basis.nbits).astype(np.float64)
        nd = bits.bits_to_table(basis.dn_words, basis.nbits).astype(np.float64)
        return nu, nd

    def _projectors(self, nu, nd, basis):
        """pro_i = |n_i - 1| if n_i > 0 else 0 per site (total across
        orbitals); equals 1 everywhere when orbitals == 1 under the t-J
        constraint."""
        n = self.geometry.number_of_sites()
        o = basis.orbitals
        ntot = (nu + nd).reshape(-1, n, o).sum(axis=2)
        pro = np.where(ntot > 0, np.abs(ntot - 1), 0.0)
        return pro  # (dim, nsite)

    def diagonal(self, basis: TjBasis) -> np.ndarray:
        nu, nd = self._occupations(basis)
        n = self.geometry.number_of_sites()
        o = basis.orbitals
        dim = basis.size
        diag = np.zeros(dim)
        if self.potential_v.size:
            nb = n * o
            # potentialV layout: site + orb*nsite (+ orbitals*nsite for
            # down) (TjMultiOrb.h:614-617)
            vu = np.zeros(nb)
            vd = np.zeros(nb)
            for site in range(n):
                for orb in range(o):
                    k = site + orb * n
                    if k < self.potential_v.size:
                        vu[site * o + orb] = self.potential_v[k]
                    k2 = site + orb * n + o * n
                    if k2 < self.potential_v.size:
                        vd[site * o + orb] = self.potential_v[k2]
            diag += nu @ vu + nd @ vd
        sz2 = nu - nd     # (dim, nbits) 2*Sz per bit
        ntot = nu + nd
        if o == 1:
            quad_zz = np.einsum("sa,ab,sb->s", sz2, self.jzz, sz2)
            self_zz = np.einsum("sa,aa,sa->s", sz2,
                                np.diag(np.diag(self.jzz)), sz2)
            diag += 0.25 * 0.5 * (quad_zz - self_zz)
            quad_w = np.einsum("sa,ab,sb->s", ntot, self.w, ntot)
            self_w = np.einsum("sa,aa,sa->s", ntot,
                               np.diag(np.diag(self.w)), ntot)
            diag += 0.5 * (quad_w - self_w)
        else:
            pro = self._projectors(nu, nd, basis)  # (dim, nsite)
            prob = np.repeat(pro, o, axis=1)       # per bit
            a_zz = prob * sz2
            a_w = prob * ntot
            # i < j only and i != j sites: mask couplings between bits
            # of the same site
            site_of = np.repeat(np.arange(n), o)
            same_site = site_of[:, None] == site_of[None, :]
            jzz_eff = np.where(same_site, 0.0, self.jzz)
            w_eff = np.where(same_site, 0.0, self.w)
            diag += 0.25 * 0.5 * np.einsum("sa,ab,sb->s", a_zz, jzz_eff,
                                           a_zz)
            diag += 0.5 * np.einsum("sa,ab,sb->s", a_w, w_eff, a_w)
        return diag

    def hamiltonian(self, basis: TjBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        dim = basis.size
        nb = basis.nbits
        upw, dnw = basis.up_words, basis.dn_words
        hop_pairs = [(a, b) for a in range(nb) for b in range(a + 1, nb)
                     if self.hop[a, b] != 0]
        jpm_pairs = [(a, b) for a in range(nb) for b in range(a + 1, nb)
                     if self.jpm[a, b] != 0]
        k = max(2 * len(hop_pairs) + len(jpm_pairs), 1)
        cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
        vals = np.zeros((dim, k), dtype=dtype)
        slot = 0
        occ_u = {a: bits.get_bit(upw, a) for a in range(nb)}
        occ_d = {a: bits.get_bit(dnw, a) for a in range(nb)}
        if self.norb > 1:
            nu, nd = self._occupations(basis)
            pro = self._projectors(nu, nd, basis)
        for (a, b) in hop_pairs:
            h = self.hop[a, b]
            flip = WORD((1 << a) | (1 << b))
            pair_sign_u = bits.pair_hop_sign(upw, a, b)
            pair_sign_d = bits.pair_hop_sign(dnw, a, b)
            # up-spin hop between bits a < b; extraSign -1 when the
            # electron sits at the lower bit (TjMultiOrb.h:676)
            one_up = (occ_u[a] + occ_u[b]) == 1
            guard = ~(((occ_u[b] == 0) & (occ_d[b] == 1)) |
                      ((occ_u[b] == 1) & (occ_d[a] == 1)))
            ok = one_up & guard
            extra = np.where(occ_u[a] == 1, -1, 1)
            tgt = np.where(ok, basis.rank(upw ^ flip, dnw), np.arange(dim))
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, h * extra * pair_sign_u, 0)
            slot += 1
            one_dn = (occ_d[a] + occ_d[b]) == 1
            guard = ~(((occ_d[b] == 0) & (occ_u[b] == 1)) |
                      ((occ_d[b] == 1) & (occ_u[a] == 1)))
            ok = one_dn & guard
            extra = np.where(occ_d[a] == 1, -1, 1)
            tgt = np.where(ok, basis.rank(upw, dnw ^ flip), np.arange(dim))
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, h * extra * pair_sign_d, 0)
            slot += 1
        for (a, b) in jpm_pairs:
            h = 0.5 * self.jpm[a, b]
            flip = WORD((1 << a) | (1 << b))
            # branch 1: up at a, up empty at b, down empty at a, down at b
            c1 = (occ_u[a] == 1) & (occ_u[b] == 0) & \
                 (occ_d[a] == 0) & (occ_d[b] == 1)
            # branch 2: mirrored
            c2 = (occ_u[a] == 0) & (occ_u[b] == 1) & \
                 (occ_d[a] == 1) & (occ_d[b] == 0)
            ok = c1 | c2
            bra_u = upw ^ flip
            bra_d = dnw ^ flip
            # signSplusSminus on the bra words (TjMultiOrb.h:772-786)
            s = bits.parity_sign_below(bra_d, b) * \
                bits.parity_sign_below(bra_d, a) * \
                bits.parity_sign_below(bra_u, a) * \
                bits.parity_sign_below(bra_u, b)
            if self.norb > 1:
                site_a = a // self.norb
                site_b = b // self.norb
                proij = pro[:, site_a] * pro[:, site_b]
            else:
                proij = 1.0
            tgt = np.where(ok, basis.rank(bra_u, bra_d), np.arange(dim))
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, proij * h * s, 0)
            slot += 1
        diag = self.diagonal(basis).astype(dtype)
        if self.reinterpret:
            diag, cols, vals = self._reinterpret_and_truncate(
                diag, cols, vals, basis, dtype)
        return hamiltonian_from_numpy(
            diag, cols, vals, None, None, None, None, None, device=device,
            dtype=torch_dtype)

    # -- JHundInfinity rotation (reference: TjMultiOrb.h:201-294) ---------

    def _reinterpret_and_truncate(self, diag, cols, vals, basis: TjBasis,
                                  dtype):
        """Rotate per-site states 6/9 into bonding/antibonding combos
        |6'> = (|6>+|9>)/sqrt2, |9'> = (|6>-|9>)/sqrt2, then drop rows
        containing removed per-site codes (6 always; 0 for level>1;
        1 or 4 for level>2).  Takes and returns host (diag, cols, vals);
        the returned arrays live in the truncated rotated basis (as in
        the reference, which truncates the matrix only);
        `self.kept_indices` maps back."""
        import scipy.sparse as sp

        n = self.geometry.number_of_sites()
        dim = basis.size
        upw = basis.up_words.astype(np.int64)
        dnw = basis.dn_words.astype(np.int64)
        rows, cols_, vals_ = [], [], []
        targets = set()
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        for s in range(dim):
            u, d = int(upw[s]), int(dnw[s])
            codes = [((u >> (2 * i)) & 3) | (((d >> (2 * i)) & 3) << 2)
                     for i in range(n)]
            branches = [([], 1.0)]
            for i, code in enumerate(codes):
                if code in (6, 9):
                    newb = []
                    for (pat, val) in branches:
                        newb.append((pat + [6], val * inv_sqrt2))
                        sign = 1.0 if code == 6 else -1.0
                        newb.append((pat + [9], sign * val * inv_sqrt2))
                    branches = newb
                else:
                    branches = [(pat + [code], val)
                                for (pat, val) in branches]
            for (pat, val) in branches:
                bu = sum((c & 3) << (2 * i) for i, c in enumerate(pat))
                bd = sum(((c >> 2) & 3) << (2 * i)
                         for i, c in enumerate(pat))
                t = int(basis.rank(np.array([bu], dtype=np.uint64),
                                   np.array([bd], dtype=np.uint64))[0])
                rows.append(s)
                cols_.append(t)
                vals_.append(val)
                if self._code_removed(pat):
                    targets.add(t)
        rot = sp.coo_matrix((vals_, (rows, cols_)),
                            shape=(dim, dim)).tocsr()
        ell_rows = np.repeat(np.arange(dim), cols.shape[1])
        h = sp.coo_matrix((vals.reshape(-1), (ell_rows, cols.reshape(-1))),
                          shape=(dim, dim)).tocsr() + sp.diags(diag)
        rotated = rot @ h @ rot.conj().T
        keep = np.array([i for i in range(dim) if i not in targets],
                        dtype=np.int64)
        self.kept_indices = keep
        m = rotated[np.ix_(keep, keep)].tocoo()
        on_diag = m.row == m.col
        new_diag = np.zeros(m.shape[0], dtype=dtype)
        np.add.at(new_diag, m.row[on_diag],
                  m.data[on_diag] if np.iscomplexobj(new_diag)
                  else np.real(m.data[on_diag]))
        new_cols, new_vals = coo_to_ell(
            m.shape[0], m.row[~on_diag], m.col[~on_diag],
            m.data[~on_diag].astype(dtype))
        return new_diag, new_cols, new_vals

    def _code_removed(self, pat) -> bool:
        for c in pat:
            if c == 6:
                return True
            if self.reinterpret > 1 and c == 0:
                return True
            if self.reinterpret > 2 and c in (1, 4):
                return True
        return False

    # -- operator maps (orbitals == 1, as in reference) -------------------

    def operator_map(self, op, site, spin, orb, src_basis: TjBasis,
                     dst_basis: TjBasis):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        if self.norb != 1:
            raise NotImplementedError(
                "t-J operator maps for orbitals > 1 unsupported "
                "(as in reference, BasisTjMultiOrbLanczos.h:385 assert)")
        dim = src_basis.size
        upw, dnw = src_basis.up_words, src_basis.dn_words
        up_occ = bits.get_bit(upw, site)
        dn_occ = bits.get_bit(dnw, site)
        idx = np.arange(dim, dtype=np.int64)
        flip = WORD(1) << WORD(site)

        if op.name in (ops.C, ops.CDAGGER):
            want = 1 if op.name == ops.C else 0
            if spin == 0:
                ok = up_occ == want
                if op.name == ops.CDAGGER:
                    ok = ok & (dn_occ == 0)  # no double occupancy
                new_up, new_dn = upw ^ flip, dnw
                sign = bits.parity_sign_below(upw, site).astype(np.float64)
            else:
                ok = dn_occ == want
                if op.name == ops.CDAGGER:
                    ok = ok & (up_occ == 0)
                new_up, new_dn = upw, dnw ^ flip
                sign = (np.where(bits.popcount(upw) & 1, -1, 1) *
                        bits.parity_sign_below(dnw, site)).astype(np.float64)
            tgt = np.where(ok, dst_basis.rank(np.where(ok, new_up, upw),
                                              np.where(ok, new_dn, dnw)), -1)
            return tgt, np.where(ok, sign, 0.0), dst_basis.size

        if op.name == ops.N:
            occ = up_occ if spin == 0 else dn_occ
            return (np.where(occ == 1, idx, -1), occ.astype(np.float64),
                    dst_basis.size)

        if op.name == ops.SZ:
            val = (up_occ - dn_occ).astype(np.float64)
            return (np.where(val != 0, idx, -1), val, dst_basis.size)

        if op.name in (ops.SPLUS, ops.SMINUS):
            if op.name == ops.SPLUS:
                ok = (up_occ == 0) & (dn_occ == 1)
            else:
                ok = (up_occ == 1) & (dn_occ == 0)
            new_up, new_dn = upw ^ flip, dnw ^ flip
            s = bits.parity_sign_below(upw, site) * \
                bits.parity_sign_below(dnw, site)
            tgt = np.where(ok, dst_basis.rank(np.where(ok, new_up, upw),
                                              np.where(ok, new_dn, dnw)), -1)
            return tgt, np.where(ok, s, 0).astype(np.float64), dst_basis.size

        raise ValueError(f"tj operator_map: unsupported {op.name}")
