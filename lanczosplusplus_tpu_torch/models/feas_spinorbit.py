"""FeBasedSc with the onsite SpinOrbit 4x4 matrix: spin-mixing basis.

Counterpart of ``lanczosplusplus_tpu/models/feas_spinorbit.py``.  The
basis and the arrays are built on the host in numpy and moved to the
device once (``hamiltonian_from_numpy``).

reference: src/Models/FeBasedSc/BasisFeAsSpinOrbit.h (union over
nup = 0..N of FeAs one-spin product blocks, down index fastest,
BasisFeAsSpinOrbit.h:48-71) + FeBasedSc.h:434-482
setSpinOrbitOffDiagonal and the diagonal spin-orbit part
(FeBasedSc.h:611-615); selected by ModelSelector when a 4x4 SpinOrbit
matrix is present (reference: src/Engine/ModelSelector.h:45-96).

The spin-orbit operator is
  sum_{i, orb1, orb2, spin1, spin2}
    SO[spin1 + 2*spin2, orb1 + O*orb2] c^dag_{i,orb2,spin2} c_{i,orb1,spin1}
with the cross-spin fermionic sign doSignSpinOrbit
(BasisFeAsBasedSc.h:180-200).  All INT_PAPER33 terms are carried over,
evaluated on flat per-state word arrays.
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.models.feas import (
    FeAsOneSpin, FeBasedScModel, _dosign_gf, _one_spin_dosign)


class FeAsSpinOrbitBasis:
    """Union basis over (nup, ne-nup); state = (up word, down word)."""

    def __init__(self, nsite: int, nup: int, ndown: int, orbitals: int):
        self.nsite = nsite
        self.nup = nup
        self.ndown = ndown
        self.orbitals = orbitals
        self.ne = nup + ndown
        ups, dns = [], []
        for nu in range(self.ne + 1):
            nd = self.ne - nu
            if nu > nsite * orbitals or nd > nsite * orbitals:
                continue
            b1 = FeAsOneSpin(nsite, nu, orbitals)
            b2 = FeAsOneSpin(nsite, nd, orbitals)
            # down index fastest (BasisFeAsSpinOrbit.h:64-68)
            ups.append(np.repeat(b1.words, b2.size))
            dns.append(np.tile(b2.words, b1.size))
        self.up_words = np.concatenate(ups)
        self.dn_words = np.concatenate(dns)
        nb = nsite * orbitals
        key = (self.up_words.astype(np.uint64) << WORD(nb)) | \
            self.dn_words.astype(np.uint64)
        order = np.argsort(key, kind="stable")
        self._sorted_key = key[order]
        self._order = order
        self._nb = nb

    @property
    def parts(self):
        return (self.nup, self.ndown)

    @property
    def size(self) -> int:
        return self.up_words.shape[0]

    def rank(self, up_w: np.ndarray, dn_w: np.ndarray) -> np.ndarray:
        key = (up_w.astype(WORD) << WORD(self._nb)) | dn_w.astype(WORD)
        pos = np.searchsorted(self._sorted_key, key)
        pos = np.minimum(pos, self.size - 1)
        return self._order[pos]

    # RDM support
    def words_up(self, i):
        return self.up_words[np.asarray(i)]

    def words_down(self, i):
        return self.dn_words[np.asarray(i)]


class FeAsSpinOrbitModel(FeBasedScModel):
    """FeBasedSc INT_PAPER33 + onsite SpinOrbit in the spin-mixing
    basis.  Conserves only the total electron number."""

    def __init__(self, inp, geometry):
        # bypass the SpinOrbit gate of the parent
        so = inp.entries.pop("SpinOrbit")
        try:
            super().__init__(inp, geometry)
        finally:
            inp.entries["SpinOrbit"] = so
        nrow, ncol, vals = so[0]
        if nrow != 4:
            raise ValueError("SpinOrbit must have 4 rows")
        self.spin_orbit = np.array(vals, dtype=np.complex128).reshape(
            nrow, ncol)

    def symmetry_form(self, basis: FeAsSpinOrbitBasis,
                      dtype: torch.dtype = torch.complex128, device="cpu"):
        """None: symmetry sectors read the flat form's rows (the parent's
        single-block form does not serve the union basis)."""
        return None

    def create_basis(self, parts) -> FeAsSpinOrbitBasis:
        return FeAsSpinOrbitBasis(self.geometry.number_of_sites(),
                                  parts[0], parts[1], self.norb)

    def has_new_parts(self, parts, op, spin, orb):
        from lanczosplusplus_tpu_torch.engine import operators as ops
        if op.name in (ops.SZ, ops.N, ops.NIL):
            return parts
        # sector-changing single-particle operators would need the
        # N +- 1 union basis; supported via total-N bookkeeping
        if op.name in (ops.C, ops.CDAGGER):
            c = -1 if op.name == ops.C else 1
            ne = parts[0] + parts[1]
            nmax = 2 * self.norb * self.geometry.number_of_sites()
            if ne + c < 0 or ne + c > nmax:
                return None
            return (parts[0] + c if parts[0] + c >= 0 else 0,
                    parts[1]) if spin == 0 else (parts[0], parts[1] + c)
        return None

    def hamiltonian(self, basis: FeAsSpinOrbitBasis,
                    dtype: torch.dtype = torch.complex128,
                    device="cpu") -> Hamiltonian:
        """Always complex: a real dtype asked for becomes the complex one
        of its precision, and the solver takes its dtype from the
        Hamiltonian."""
        torch_dtype = {torch.float64: torch.complex128,
                       torch.float32: torch.complex64}.get(dtype, dtype)
        dtype = numpy_dtype(torch_dtype)
        n = self.geometry.number_of_sites()
        o = self.norb
        nb = n * o
        dim = basis.size
        upw = basis.up_words
        dnw = basis.dn_words
        idx = np.arange(dim, dtype=np.int64)
        occ_u = {a: bits.get_bit(upw, a) for a in range(nb)}
        occ_d = {a: bits.get_bit(dnw, a) for a in range(nb)}

        # ---- diagonal (PAPER33 + spin-orbit diagonal) -------------------
        u = self.u
        diag = np.zeros(dim)
        for i in range(n):
            for orb in range(o):
                a = i * o + orb
                diag += u[0] * occ_u[a] * occ_d[a]
                diag += self.potential_v[i + orb * n] * occ_u[a]
                diag += self.potential_v[i + (orb + o) * n] * occ_d[a]
                for orb2 in range(orb + 1, o):
                    b = i * o + orb2
                    na = occ_u[a] + occ_d[a]
                    nb2 = occ_u[b] + occ_d[b]
                    diag += u[1] * na * nb2
                    diag += u[4] * 0.25 * (occ_u[a] - occ_d[a]) * \
                        (occ_u[b] - occ_d[b])
                    diag += u[5] * (occ_u[a] * occ_u[b] +
                                    occ_d[a] * occ_d[b])
                # spin-orbit diagonal (FeBasedSc.h:611-615)
                diag = diag + \
                    np.real(self.spin_orbit[0, orb + orb * o]) * occ_u[a] + \
                    np.real(self.spin_orbit[3, orb + orb * o]) * occ_d[a]
        if self.anisotropy_d:
            for i in range(n):
                sz = np.zeros(dim)
                for orb in range(o):
                    a = i * o + orb
                    sz = sz + 0.5 * (occ_u[a] - occ_d[a])
                diag += self.anisotropy_d * sz * sz

        # ---- off-diagonal slots ----------------------------------------
        hop_pairs = [(a, b) for a in range(nb) for b in range(a + 1, nb)
                     if self.hop[a, b] != 0]
        u2_pairs = [(i * o + o1, i * o + o2) for i in range(n)
                    for o1 in range(o) for o2 in range(o1 + 1, o)
                    if self.u[2] != 0 or self.u[3] != 0]
        so_moves = []
        for i in range(n):
            for o1 in range(o):
                for o2 in range(o):
                    for s1 in range(2):
                        for s2 in range(2):
                            val = self.spin_orbit[s1 + 2 * s2,
                                                  o1 + o * o2]
                            if val == 0:
                                continue
                            if s1 == s2 and o1 == o2:
                                continue  # diagonal handled above
                            so_moves.append((i, o1, s1, o2, s2, val))

        k = max(2 * len(hop_pairs) + 2 * len(u2_pairs) + len(so_moves), 1)
        cols = np.tile(idx[:, None], (1, k))
        vals = np.zeros((dim, k), dtype=dtype)
        slot = 0

        def pair_rank(new_up, new_dn, ok):
            safe_up = np.where(ok, new_up, upw)
            safe_dn = np.where(ok, new_dn, dnw)
            return np.where(ok, basis.rank(safe_up, safe_dn), idx)

        for (a, b) in hop_pairs:
            i, orb = a // o, a % o
            j, orb2 = b // o, b % o
            h = self.hop[a, b]
            flip = WORD((1 << a) | (1 << b))
            for wrd, occ, is_up in ((upw, occ_u, True), (dnw, occ_d, False)):
                one = (occ[a] + occ[b]) == 1
                extra = np.where(occ[a] == 1, -1, 1)
                sgn = _one_spin_dosign(wrd, i, orb, j, orb2, o)
                if is_up:
                    tgt = pair_rank(upw ^ flip, dnw, one)
                else:
                    tgt = pair_rank(upw, dnw ^ flip, one)
                cols[:, slot] = tgt
                vals[:, slot] = np.where(one, h * extra * sgn, 0)
                slot += 1

        for (a, b) in u2_pairs:
            i, o1 = a // o, a % o
            _, o2 = b // o, b % o
            flip = WORD((1 << a) | (1 << b))
            sgn = _one_spin_dosign(upw, i, o1, i, o2, o) * \
                _one_spin_dosign(dnw, i, o1, i, o2, o)
            c1 = (occ_u[b] == 1) & (occ_u[a] == 0) & \
                 (occ_d[a] == 1) & (occ_d[b] == 0)
            c2 = (occ_u[a] == 1) & (occ_u[b] == 0) & \
                 (occ_d[b] == 1) & (occ_d[a] == 0)
            cond = c1 | c2
            tgt = pair_rank(upw ^ flip, dnw ^ flip, cond)
            cols[:, slot] = tgt
            vals[:, slot] = np.where(cond, 0.5 * self.u[2] * sgn, 0)
            slot += 1
            p1 = (occ_u[b] == 1) & (occ_u[a] == 0) & \
                 (occ_d[b] == 1) & (occ_d[a] == 0)
            p2 = (occ_u[a] == 1) & (occ_u[b] == 0) & \
                 (occ_d[a] == 1) & (occ_d[b] == 0)
            cond = p1 | p2
            tgt = pair_rank(upw ^ flip, dnw ^ flip, cond)
            cols[:, slot] = tgt
            vals[:, slot] = np.where(cond, -self.u[3] * sgn, 0)
            slot += 1

        n_up_tot = sum(occ_u[a] for a in range(nb))
        for (i, o1, s1, o2, s2, val) in so_moves:
            i1 = i * o + o1
            i2 = i * o + o2
            w1 = upw if s1 == 0 else dnw
            w2 = upw if s2 == 0 else dnw
            occ1 = occ_u[i1] if s1 == 0 else occ_d[i1]
            occ2 = occ_u[i2] if s2 == 0 else occ_d[i2]
            ok = (occ1 == 1) & (occ2 == 0)
            if s1 == s2:
                flip = WORD((1 << i1) | (1 << i2))
                new_up = upw ^ flip if s1 == 0 else upw
                new_dn = dnw ^ flip if s1 == 1 else dnw
                sgn = _one_spin_dosign(w1, i, min(o1, o2), i,
                                       max(o1, o2), o)
                if o1 > o2:
                    sgn = -sgn
            else:
                new_up = upw ^ (WORD(1) << WORD(i1 if s1 == 0 else i2))
                new_dn = dnw ^ (WORD(1) << WORD(i1 if s1 == 1 else i2))
                # doSignSpinOrbit cross-spin (BasisFeAsBasedSc.h:193-199)
                x = -1 if s1 == 1 else 1
                s_par = np.where(n_up_tot & 1, -1, 1)
                if s1 == 1:
                    sgn = x * s_par * _dosign_gf(upw, i, o2, o) * \
                        _dosign_gf(dnw, i, o1, o)
                else:
                    sgn = x * s_par * _dosign_gf(upw, i, o1, o) * \
                        _dosign_gf(dnw, i, o2, o)
            tgt = pair_rank(new_up, new_dn, ok)
            cols[:, slot] = tgt
            vals[:, slot] = np.where(ok, val * sgn, 0)
            slot += 1

        return hamiltonian_from_numpy(
            diag.astype(dtype), cols, vals, None, None, None, None, None,
            device=device, dtype=torch_dtype)

    def operator_map(self, op, site, spin, orb, src_basis, dst_basis):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        o = self.norb
        upw, dnw = src_basis.up_words, src_basis.dn_words
        pos = site * o + (orb if isinstance(orb, (int, np.integer)) else 0)
        occ = bits.get_bit(upw if spin == 0 else dnw, pos)
        idx = np.arange(src_basis.size, dtype=np.int64)
        if op.name == ops.N:
            return (np.where(occ == 1, idx, -1), occ.astype(np.float64),
                    dst_basis.size)
        if op.name == ops.SZ:
            val = (bits.get_bit(upw, pos) -
                   bits.get_bit(dnw, pos)).astype(np.float64)
            return (np.where(val != 0, idx, -1), val, dst_basis.size)
        raise NotImplementedError(
            f"FeAsSpinOrbit operator_map: {op.name} unsupported")
