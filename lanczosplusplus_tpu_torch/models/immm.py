"""Immm model: heterogeneous orbitals per site (Cu 1 orbital / O 2).

Counterpart of ``lanczosplusplus_tpu/models/immm.py``.  The basis and the
arrays are built on the host in numpy and moved to the device once
(``hamiltonian_from_numpy``).

reference: src/Models/Immm/{Immm.h,BasisImmm.h,BasisOneSpinImmm.h,
ParametersImmm.h}.  Hamiltonian (Immm.h:96-276, hole language):
- hopping, orbital-resolved, geometry term 0;
- diagonal: U_i (1-n_up)(1-n_down) per (site, orb), V_i total charge,
  and Upd (2-n_Oorb)(2-n_Cu) between O orbitals and Cu sites
  (geometry term 1).

The reference derives the 1-vs-2-orbital site pattern from PsimagLite's
KTwoNiFFour geometry (BasisImmm.h:49-57), which is not available here;
the pattern is taken from an `OrbsPerSite` input vector when present,
else defaults to alternating O(2), Cu(1) starting at site 0.  Bit
layout: stride orbs() = 2 per site, Cu sites use orbital 0 only
(unused bits stay 0), matching Immm.h:191 ii = i*basis.orbs()+orb.
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
from lanczosplusplus_tpu_torch.models.feas import (
    _dosign_gf, _one_spin_dosign)


class ImmmOneSpin:
    """Words over the valid (site, orb) bits with fixed particle count."""

    def __init__(self, orbs_per_site, npart: int):
        self.orbs_per_site = list(orbs_per_site)
        self.nsite = len(self.orbs_per_site)
        self.stride = 2
        valid = []
        for i, o in enumerate(self.orbs_per_site):
            for orb in range(o):
                valid.append(i * self.stride + orb)
        self.valid_bits = np.array(valid, dtype=np.int64)
        nvalid = len(valid)
        combs = enumerate_combinations(nvalid, npart)
        # map combination bit k -> collated bit valid[k]
        words = np.zeros(combs.shape[0], dtype=WORD)
        for k, pos in enumerate(valid):
            bit = (combs >> WORD(k)) & WORD(1)
            words |= bit << WORD(pos)
        self.words = np.sort(words)
        self.npart = npart

    @property
    def size(self):
        return self.words.shape[0]

    def rank(self, words: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self.words, words.astype(WORD))
        return np.minimum(pos, self.size - 1)

    def occupation_table(self) -> np.ndarray:
        return bits.bits_to_table(self.words, self.nsite * self.stride)


class ImmmBasis:
    def __init__(self, orbs_per_site, nup, ndown):
        self.orbs_per_site = list(orbs_per_site)
        self.nsite = len(self.orbs_per_site)
        self.nup = nup
        self.ndown = ndown
        self.up = ImmmOneSpin(orbs_per_site, nup)
        self.down = ImmmOneSpin(orbs_per_site, ndown)

    @property
    def parts(self):
        return (self.nup, self.ndown)

    @property
    def size(self):
        return self.up.size * self.down.size

    def words_up(self, i):
        return self.up.words[np.asarray(i) % self.up.size]

    def words_down(self, i):
        return self.down.words[np.asarray(i) // self.up.size]


class ImmmModel:
    is_fermionic = True

    def __init__(self, inp, geometry):
        self.geometry = geometry
        n = geometry.number_of_sites()
        if inp.has("OrbsPerSite"):
            self.orbs_per_site = [int(x) for x in inp.vector("OrbsPerSite")]
        elif geometry.kind(0).lower() == "ktwoniffour":
            # the reference's pattern source: KTwoNiFFour site types,
            # TYPE_C -> 1 orbital, O -> 2 (BasisImmm.h:49-57)
            from lanczosplusplus_tpu_torch.geometry.geometry import \
                ktwoniffour_types
            self.orbs_per_site = [1 if t == "C" else 2
                                  for t in ktwoniffour_types(n)]
        else:
            # O(2), Cu(1) alternating — see module docstring
            self.orbs_per_site = [2 if i % 2 == 0 else 1 for i in range(n)]
        self.hubbard_u = np.array(inp.vector("hubbardU"), dtype=np.float64)
        self.potential_v = np.array(inp.vector("potentialV"),
                                    dtype=np.float64)[:n]
        c = geometry.coupling_tensor(0)
        dof = c.shape[2]
        self.stride = 2
        nb = n * self.stride
        self.hop = np.zeros((nb, nb))
        for i in range(n):
            for j in range(n):
                for o1 in range(min(dof, self.orbs_per_site[i])):
                    for o2 in range(min(dof, self.orbs_per_site[j])):
                        self.hop[i * 2 + o1, j * 2 + o2] = c[i, j, o1, o2]
        self.upd = geometry.coupling_matrix(1) if geometry.terms() > 1 \
            else np.zeros((n, n))

    def create_basis(self, parts) -> ImmmBasis:
        return ImmmBasis(self.orbs_per_site, parts[0], parts[1])

    def default_parts(self, inp):
        return (inp.integer("TargetElectronsUp"),
                inp.integer("TargetElectronsDown"))

    def orbitals(self, site) -> int:
        return self.orbs_per_site[site]

    def has_new_parts(self, parts, op, spin, orb):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        nup, ndown = parts
        nmax = sum(self.orbs_per_site)
        if op.name in (ops.C, ops.CDAGGER):
            c = -1 if op.name == ops.C else 1
            new = (nup + c, ndown) if spin == 0 else (nup, ndown + c)
        elif op.name in (ops.SZ, ops.N, ops.NIL):
            return parts
        else:
            raise ValueError(f"immm hasNewParts: unsupported {op.name}")
        if min(new) < 0 or max(new) > nmax:
            return None
        return new

    def diagonal(self, basis: ImmmBasis) -> np.ndarray:
        n = basis.nsite
        nu = basis.up.occupation_table().astype(np.float64)
        nd = basis.down.occupation_table().astype(np.float64)
        szu, szd = basis.up.size, basis.down.size
        diag2d = np.zeros((szd, szu))
        cu_sites = [i for i in range(n) if self.orbs_per_site[i] == 1]
        for i in range(n):
            for orb in range(self.orbs_per_site[i]):
                a = i * 2 + orb
                # hole-language Hubbard: U (1-n_up)(1-n_down)
                diag2d += self.hubbard_u[i] * \
                    (1.0 - nu[:, a])[None, :] * (1.0 - nd[:, a])[:, None]
                charge = nu[:, a][None, :] + nd[:, a][:, None]
                diag2d += self.potential_v[i] * charge
                if self.orbs_per_site[i] == 1:
                    continue
                for j in cu_sites:
                    if self.upd[i, j] == 0:
                        continue
                    b = j * 2
                    charge2 = nu[:, b][None, :] + nd[:, b][:, None]
                    diag2d += self.upd[i, j] * (2.0 - charge) * \
                        (2.0 - charge2)
        return diag2d.reshape(-1)

    def hamiltonian(self, basis: ImmmBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        n = basis.nsite
        dim = basis.size
        szu, szd = basis.up.size, basis.down.size
        upw, dnw = basis.up.words, basis.down.words
        iu = np.arange(szu, dtype=np.int64)
        idn = np.arange(szd, dtype=np.int64)
        nb = n * 2
        pairs = [(a, b) for a in range(nb) for b in range(a + 1, nb)
                 if self.hop[a, b] != 0]
        # the off-diagonal is hopping-only (reference: Immm.h:96-160),
        # which is spin-conserving: keep it as one-spin Kronecker
        # factors instead of broadcasting over the full dim
        ku = max(len(pairs), 1)
        up_cols = np.tile(iu[:, None], (1, ku))
        up_vals = np.zeros((szu, ku), dtype=dtype)
        dn_cols = np.tile(idn[:, None], (1, ku))
        dn_vals = np.zeros((szd, ku), dtype=dtype)
        for hk, (a, b) in enumerate(pairs):
            i, orb = a // 2, a % 2
            j, orb2 = b // 2, b % 2
            h = self.hop[a, b]
            flip = WORD((1 << a) | (1 << b))
            for (wrd, onespin, is_up) in ((upw, basis.up, True),
                                          (dnw, basis.down, False)):
                occ_a = bits.get_bit(wrd, a)
                occ_b = bits.get_bit(wrd, b)
                one = (occ_a + occ_b) == 1
                extra = np.where(occ_a == 1, -1, 1)
                sgn = _one_spin_dosign(wrd, i, orb, j, orb2, 2)
                amp = np.where(one, h * extra * sgn, 0)
                tgt = np.where(one, onespin.rank(wrd ^ flip),
                               iu if is_up else idn)
                if is_up:
                    up_cols[:, hk] = tgt
                    up_vals[:, hk] = amp
                else:
                    dn_cols[:, hk] = tgt
                    dn_vals[:, hk] = amp
        return hamiltonian_from_numpy(
            self.diagonal(basis).astype(dtype), None, None, up_cols,
            up_vals, dn_cols, dn_vals, (szd, szu), device=device,
            dtype=torch_dtype)

    def operator_map(self, op, site, spin, orb, src_basis: ImmmBasis,
                     dst_basis: ImmmBasis):
        from lanczosplusplus_tpu_torch.engine import operators as ops

        upw, dnw = src_basis.up.words, src_basis.down.words
        szu_d = dst_basis.up.size
        pos = site * 2 + orb
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

        if op.name in (ops.C, ops.CDAGGER):
            want = 1 if op.name == ops.C else 0
            flip = WORD(1) << WORD(pos)
            if spin == 0:
                ok = up_occ == want
                tgt_u = np.where(ok, dst_basis.up.rank(upw ^ flip), 0)
                sgn = _dosign_gf(upw, site, orb, 2).astype(np.float64)
                return outer(tgt_u, idn, sgn,
                             np.ones_like(idn, float), ok,
                             np.ones_like(idn, bool))
            ok = dn_occ == want
            tgt_d = np.where(ok, dst_basis.down.rank(dnw ^ flip), 0)
            sgn_d = _dosign_gf(dnw, site, orb, 2).astype(np.float64)
            sgn_u = np.where(bits.popcount(upw) & 1, -1.0, 1.0)
            return outer(iu, tgt_d, sgn_u, sgn_d,
                         np.ones_like(iu, bool), ok)

        if op.name == ops.N:
            occ = up_occ if spin == 0 else dn_occ
            idx = (iu[None, :] + idn[:, None] * szu_d).reshape(-1)
            full = (np.broadcast_to(occ[None, :]
                                    if spin == 0 else occ[:, None],
                                    (len(idn), len(iu)))).reshape(-1)
            return (np.where(full == 1, idx, -1), full.astype(np.float64),
                    dst_basis.size)

        raise ValueError(f"immm operator_map: unsupported {op.name}")
