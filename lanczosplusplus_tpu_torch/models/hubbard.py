"""One-orbital Hubbard model family.

Counterpart of ``lanczosplusplus_tpu/models/hubbard.py`` (``HubbardParams``,
``directed_bonds`` and ``HubbardModel`` with its Hamiltonian,
``has_new_parts`` and ``operator_map``).
Model= strings: HubbardOneBand, HubbardOneBandExtended,
SuperHubbardExtended, KaneMeleHubbard (reference:
src/Models/HubbardOneOrbital/{HubbardOneOrbital.h,HubbardHelper.h}).

Hamiltonian (reference HubbardHelper.h:138-343):
- hopping   sum_{ij,s} t_ij c^dag_js c_is            (term 0; KaneMele adds term 1)
- Hubbard U sum_i U_i n_iu n_id
- potential sum_i V_i (n_iu + n_id)  (+ time-dependent PotentialT)
- Coulomb   0.5 sum_ij W_ij n_i n_j                  (Extended/Super, term 1)
- Heisenberg J: 0.5 sum_ij J_ij Sz_i Sz_j + (J_ij/2)(S+_i S-_j + h.c.)
  with fermionic pair signs                          (Super, term 2)

Hopping is spin-separable (Kronecker one-spin factors); U/V/W/SzSz form
a closed-form diagonal; S+S- couples both spin words and is a generic
ELL part.  Everything is built on the host in numpy and moved to the
device once.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.basis import HubbardBasis
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy, one_spin_ell)


def directed_bonds(tmat: np.ndarray):
    """All ordered (i, j, t[i,j]) with nonzero coupling."""
    n = tmat.shape[0]
    out = []
    for i in range(n):
        for j in range(n):
            if i != j and tmat[i, j] != 0:
                out.append((i, j, tmat[i, j]))
    return out


class HubbardParams:
    """reference: src/Models/HubbardOneOrbital/ParametersModelHubbard.h:92-113."""

    def __init__(self, inp, nsite):
        self.model = inp.string("Model")
        self.hubbard_u = np.array(inp.vector("hubbardU"), dtype=np.float64)
        pv = np.array(inp.vector("potentialV"), dtype=np.float64)
        # the reference reads 2*nsite values but uses only the first
        # nsite, applied to n_up + n_down (HubbardHelper.h:180-183)
        self.potential_v = pv[:nsite]
        self.potential_t = np.array(inp.vector("PotentialT", default=[]),
                                    dtype=np.float64)
        self.time_factor = inp.real("timeFactor", default=0.0)


class HubbardModel:
    TERM_HOPPING, TERM_NINJ, TERM_SUPER = 0, 1, 2

    is_fermionic = True

    def __init__(self, inp, geometry):
        self.geometry = geometry
        self.params = HubbardParams(inp, geometry.number_of_sites())
        name = self.params.model
        self.has_j = name == "SuperHubbardExtended"
        self.has_ninj = name in ("HubbardOneBandExtended",
                                 "SuperHubbardExtended")
        kane_mele = name == "KaneMeleHubbard"
        t = geometry.coupling_matrix(self.TERM_HOPPING).copy()
        if kane_mele:
            t2 = geometry.coupling_matrix(1)
            if np.iscomplexobj(t2) and not np.iscomplexobj(t):
                t = t.astype(complex)
            t = t + t2
        self.hoppings = t
        self.jmat = (geometry.coupling_matrix(self.TERM_SUPER)
                     if self.has_j else None)
        self.wmat = (geometry.coupling_matrix(self.TERM_NINJ)
                     if self.has_ninj else None)

    # -- sector bookkeeping ----------------------------------------------

    def create_basis(self, parts) -> HubbardBasis:
        nup, ndown = parts
        return HubbardBasis(self.geometry.number_of_sites(), nup, ndown)

    def default_parts(self, inp):
        return (inp.integer("TargetElectronsUp"),
                inp.integer("TargetElectronsDown"))

    def orbitals(self, site) -> int:
        return 1

    def has_new_parts(self, parts, op, spin, orb):
        """Sector reached by applying op; None if outside the Hilbert
        space (reference: HubbardOneOrbital.h:213-263)."""
        from lanczosplusplus_tpu_torch.engine import operators as ops

        nup, ndown = parts
        nsite = self.geometry.number_of_sites()
        if op.name in (ops.C, ops.CDAGGER):
            c = -1 if op.name == ops.C else 1
            new = (nup + c, ndown) if spin == 0 else (nup, ndown + c)
            # capability extension: the reference forbids the vacuum
            # sector (HubbardOneOrbital.h:232 newPart1==0 && newPart2==0),
            # dropping physical spectral weight for 1-electron sectors;
            # we allow it.
            if min(new) < 0 or max(new) > nsite:
                return None
            return new
        if op.name in (ops.SPLUS, ops.SMINUS):
            c = 1 if op.name == ops.SPLUS else -1
            new = (nup + c, ndown - c)
            if min(new) < 0 or max(new) > nsite:
                return None
            return new
        if op.name in (ops.SZ, ops.N, ops.NIL):
            return parts  # diagonal in the sector
        raise ValueError(f"hasNewParts: unsupported operator {op.name}")

    def operator_map(self, op, site, spin, orb, src_basis: HubbardBasis,
                     dst_basis: HubbardBasis):
        """Whole-basis index map for a labeled operator: arrays
        (tgt, amp) over the source sector, tgt = -1 where annihilated.

        amp folds in getBraIndex's value and the fermion signs applied
        by accModifiedState_ (reference: BasisHubbardLanczos.h:106-141
        doSignGf, 157-166 doSignSpSm; Engine.h:416-458).
        """
        from lanczosplusplus_tpu_torch.engine import operators as ops

        upw, dnw = src_basis.up.words, src_basis.down.words
        szu_s = src_basis.up.size
        szu_d = dst_basis.up.size
        up_occ = bits.get_bit(upw, site)
        dn_occ = bits.get_bit(dnw, site)
        iu = np.arange(src_basis.up.size, dtype=np.int64)
        idn = np.arange(src_basis.down.size, dtype=np.int64)

        def outer_index(up_t, dn_t):
            return (up_t[None, :] + dn_t[:, None] * szu_d).reshape(-1)

        def outer_amp(up_a, dn_a):
            return (up_a[None, :] * dn_a[:, None]).reshape(-1)

        name = op.name
        if name in (ops.C, ops.CDAGGER):
            want = 1 if name == ops.C else 0
            if spin == 0:
                ok = up_occ == want
                new_up = bits.flip_bit(upw, site)
                up_t = np.where(ok, dst_basis.up.rank(new_up), -1)
                sign = bits.parity_sign_below(upw, site)
                tgt = outer_index(np.where(ok, up_t, 0), idn)
                tgt = np.where((ok[None, :] * np.ones_like(idn)[:, None])
                               .reshape(-1).astype(bool), tgt, -1)
                amp = outer_amp(np.where(ok, sign, 0).astype(np.float64),
                                np.ones_like(idn, dtype=np.float64))
            else:
                ok = dn_occ == want
                new_dn = bits.flip_bit(dnw, site)
                dn_t = np.where(ok, dst_basis.down.rank(new_dn), -1)
                sign = bits.parity_sign_below(dnw, site)
                # crossing the whole up word (reference doSignGf:
                # parity of all up electrons)
                up_parity = np.where(bits.popcount(upw) & 1, -1, 1)
                tgt = outer_index(iu, np.where(ok, dn_t, 0))
                tgt = np.where((np.ones_like(iu)[None, :] *
                                ok[:, None]).reshape(-1).astype(bool),
                               tgt, -1)
                amp = outer_amp(up_parity.astype(np.float64),
                                np.where(ok, sign, 0).astype(np.float64))
            return tgt, amp, dst_basis.size

        if name == ops.N:
            occ = up_occ if spin == 0 else dn_occ
            if spin == 0:
                tgt = outer_index(np.where(occ == 1, iu, -1), idn)
                tgt = np.where((np.asarray(occ == 1)[None, :] *
                                np.ones_like(idn, bool)[:, None])
                               .reshape(-1), tgt, -1)
                amp = outer_amp(occ.astype(np.float64),
                                np.ones_like(idn, dtype=np.float64))
            else:
                tgt = outer_index(iu, idn)
                mask = (np.ones_like(iu, bool)[None, :] *
                        np.asarray(occ == 1)[:, None]).reshape(-1)
                tgt = np.where(mask, tgt, -1)
                amp = outer_amp(np.ones_like(iu, dtype=np.float64),
                                occ.astype(np.float64))
            return tgt, amp, dst_basis.size

        if name == ops.SZ:
            # getBraIndexSz: value +1 if up occupied, -1 if down occupied,
            # skip if both or neither (reference BasisHubbardLanczos.h:216-229).
            # NOTE this is the reference's gf-sz convention: amplitudes
            # are n_up - n_dn WITHOUT the physical 1/2 (the reference's
            # own twoPoint path instead uses 0.5 n_up - 0.5 n_dn,
            # Engine.h:537-599 — we reproduce each path's convention)
            val = up_occ[None, :] - dn_occ[:, None]          # (szd, szu)
            both = (up_occ[None, :] == 1) & (dn_occ[:, None] == 1)
            val = np.where(both, 0, val)
            tgt = outer_index(iu, idn)
            tgt = np.where(val.reshape(-1) != 0, tgt, -1)
            return tgt, val.reshape(-1).astype(np.float64), dst_basis.size

        if name in (ops.SPLUS, ops.SMINUS):
            # splus: up empty & down occupied -> move; sminus mirror
            if name == ops.SPLUS:
                ok_u = up_occ == 0
                ok_d = dn_occ == 1
            else:
                ok_u = up_occ == 1
                ok_d = dn_occ == 0
            new_up = bits.flip_bit(upw, site)
            new_dn = bits.flip_bit(dnw, site)
            up_t = np.where(ok_u, dst_basis.up.rank(new_up), 0)
            dn_t = np.where(ok_d, dst_basis.down.rank(new_dn), 0)
            s_u = bits.parity_sign_below(upw, site)
            s_d = bits.parity_sign_below(dnw, site)
            mask = (ok_u[None, :] & ok_d[:, None]).reshape(-1)
            tgt = np.where(mask, outer_index(up_t, dn_t), -1)
            amp = np.where(mask, outer_amp(s_u.astype(np.float64),
                                           s_d.astype(np.float64)), 0.0)
            return tgt, amp, dst_basis.size

        raise ValueError(f"operator_map: unsupported operator {name}")

    # -- Hamiltonian ------------------------------------------------------

    def diagonal(self, basis: HubbardBasis) -> np.ndarray:
        """Closed-form diagonal via occupation-table quadratic forms
        (reference: HubbardHelper.h:138-189 calcDiagonalElements)."""
        nu = basis.up.occupation_table().astype(np.float64)    # (szu, n)
        nd = basis.down.occupation_table().astype(np.float64)  # (szd, n)
        u = self.params.hubbard_u
        v = self.params.potential_v.copy()
        if self.params.potential_t.size:
            v = v + self.params.potential_t * self.params.time_factor

        # Hubbard U: sum_i U_i nu_i nd_i  -> cross term (szd, szu)
        diag2d = (nd * u[None, :]) @ nu.T
        # potential: v.(nu + nd)
        diag2d = diag2d + (nu @ v)[None, :] + (nd @ v)[:, None]

        if self.jmat is not None:
            j = self.jmat
            au = np.einsum("ui,ij,uj->u", nu, j, nu)
            ad = np.einsum("di,ij,dj->d", nd, j, nd)
            cross = nd @ j @ nu.T
            # 0.5 sum_ij J_ij sz_i sz_j with sz = (nu - nd)/2
            diag2d = diag2d + 0.125 * (au[None, :] + ad[:, None]) \
                - 0.25 * cross
        if self.wmat is not None:
            w = self.wmat
            au = np.einsum("ui,ij,uj->u", nu, w, nu)
            ad = np.einsum("di,ij,dj->d", nd, w, nd)
            cross = nd @ w @ nu.T
            # 0.5 sum_ij W_ij n_i n_j with n = nu + nd
            diag2d = diag2d + 0.5 * (au[None, :] + ad[:, None]) + cross
        return diag2d.reshape(-1)

    def _j_offdiagonal_coo(self, basis: HubbardBasis, dtype):
        """S+_i S-_j + S+_j S-_i exchange entries as full-dim ELL columns
        (reference: HubbardHelper.h:282-343).  Numpy (cols, vals) of shape
        (dim, number of J bonds), or None without bonds."""
        szu, szd = basis.up.size, basis.down.size
        upw, dnw = basis.up.words, basis.down.words
        n = self.geometry.number_of_sites()
        pairs = [(a, b) for a in range(n) for b in range(a + 1, n)
                 if self.jmat[a, b] != 0]
        if not pairs:
            return None
        cols = np.tile(np.arange(basis.size, dtype=np.int64)[:, None],
                       (1, len(pairs)))
        vals = np.zeros((basis.size, len(pairs)), dtype=dtype)
        iu_grid = np.arange(szu, dtype=np.int64)
        id_grid = np.arange(szd, dtype=np.int64)
        for k, (a, b) in enumerate(pairs):
            jv = self.jmat[a, b]
            su = bits.pair_hop_sign(upw, a, b)      # (szu,)
            sd = bits.pair_hop_sign(dnw, a, b)      # (szd,)
            up_a = bits.get_bit(upw, a)
            up_b = bits.get_bit(upw, b)
            dn_a = bits.get_bit(dnw, a)
            dn_b = bits.get_bit(dnw, b)
            flip = np.uint64((1 << a) | (1 << b))
            up_t = basis.up.rank(upw ^ flip)        # target up index
            dn_t = basis.down.rank(dnw ^ flip)      # target down index
            # S+_a S-_b: up: b occupied, a empty; down: a occupied, b empty
            c1u = (up_b == 1) & (up_a == 0)
            c1d = (dn_a == 1) & (dn_b == 0)
            # S+_b S-_a: mirror
            c2u = (up_a == 1) & (up_b == 0)
            c2d = (dn_b == 1) & (dn_a == 0)
            cond = (c1u[None, :] & c1d[:, None]) | \
                   (c2u[None, :] & c2d[:, None])
            tgt = up_t[None, :] + dn_t[:, None] * szu
            sign = su[None, :] * sd[:, None]
            cols[:, k] = np.where(cond,
                                  tgt,
                                  (iu_grid[None, :] +
                                   id_grid[:, None] * szu)).reshape(-1)
            vals[:, k] = np.where(cond, 0.5 * jv * sign, 0).reshape(-1)
        return cols.astype(np.int32), vals

    def hamiltonian(self, basis: HubbardBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        """The sector Hamiltonian in gather form on `device`."""
        np_dtype = numpy_dtype(dtype)
        bonds = directed_bonds(self.hoppings)
        up_cols, up_vals = one_spin_ell(basis.up.words, basis.up.rank,
                                        bonds, np_dtype)
        dn_cols, dn_vals = one_spin_ell(basis.down.words, basis.down.rank,
                                        bonds, np_dtype)
        j_ell = None
        if self.jmat is not None:
            j_ell = self._j_offdiagonal_coo(basis, np_dtype)
        ell_cols, ell_vals = j_ell if j_ell is not None else (None, None)
        return hamiltonian_from_numpy(
            self.diagonal(basis).astype(np_dtype), ell_cols, ell_vals,
            up_cols, up_vals, dn_cols, dn_vals, basis.spin_shape,
            device=device, dtype=dtype)
