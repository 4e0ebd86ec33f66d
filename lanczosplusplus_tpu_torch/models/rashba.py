"""Hubbard model with Rashba spin-orbit coupling: conserves only total N.

Counterpart of ``lanczosplusplus_tpu/models/rashba.py``: the flat ELL
form (``hamiltonian``) and the (nup, ndown) block-Kronecker form
(``block_kron_hamiltonian``).  The basis and the arrays are built on the
host in numpy and moved to the device once.

reference: src/Models/HubbardOneOrbitalRashbaSOC/
{HubbardOneOrbitalRashbaSOC.h,BasisRashbaSOC.h} + the Rashba branch of
src/Models/HubbardOneOrbital/HubbardHelper.h:245-278.

Basis: union over ndown = 0..N of (nup = N - ndown, ndown) product
blocks, block-internal index = idown + iup * size_down
(BasisRashbaSOC.h:36-50: down index fastest).  Two geometry terms:
hopping (term 0) and Rashba SOC (term 1):

  H = sum_{ij,s} t_ij c^dag_js c_is + U n_u n_d + V n
    + sum_ij r_ij [ c^dag_ju c_id + h.c. ]   with the spin-flip carrying
      (-1)^{N_up} x within-word parities (HubbardHelper.h:250-278).

Design: spin-conserving terms are per-block Kronecker maps; Rashba
spin-flips are cross-block whole-dim ELL entries.  Everything collapses
to one ELL Hamiltonian over the union dimension C(2 nsite, N).
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis
from lanczosplusplus_tpu_torch.core.combinatorics import binomial_table
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.models.hubbard import (
    HubbardParams, directed_bonds)


class RashbaBasis:
    """Union basis over (nup, ndown) blocks with nup + ndown = N."""

    def __init__(self, nsite: int, ne: int):
        self.nsite = nsite
        self.ne = ne
        self.blocks = []       # per ndown: (up_basis, down_basis, offset)
        off = 0
        for ndown in range(ne + 1):
            nup = ne - ndown
            if nup > nsite or ndown > nsite:
                self.blocks.append(None)
                continue
            up = OneSpinBasis(nsite, nup)
            dn = OneSpinBasis(nsite, ndown)
            self.blocks.append((up, dn, off))
            off += up.size * dn.size
        self._size = off
        expected = int(binomial_table(2 * nsite)[2 * nsite, ne]) \
            if ne <= 2 * nsite else 0
        assert self._size == expected, (self._size, expected)

    @property
    def parts(self):
        return ("ne", self.ne)

    @property
    def size(self) -> int:
        return self._size

    def block(self, ndown):
        return self.blocks[ndown]

    def block_index(self, ndown, iu, idn):
        up, dn, off = self.blocks[ndown]
        return off + idn + iu * dn.size


class RashbaSOCModel:
    is_fermionic = True

    def __init__(self, inp, geometry):
        self.geometry = geometry
        if geometry.terms() != 2:
            raise ValueError("Rashba needs two Hamiltonian terms")
        self.params = HubbardParams(inp, geometry.number_of_sites())
        self.hoppings = geometry.coupling_matrix(0)
        self.rashba = geometry.coupling_matrix(1)

    def symmetry_form(self, basis: RashbaBasis,
                      dtype: torch.dtype = torch.float64, device="cpu"):
        """The form symmetry sectors read their rows from: the spatial
        half-cut form, so that no sector materializes the flat ELL."""
        from lanczosplusplus_tpu_torch.models.rashba_halfcut import (
            build_halfcut_rashba)
        return build_halfcut_rashba(self, basis, dtype=dtype, device=device)

    def create_basis(self, parts) -> RashbaBasis:
        return RashbaBasis(self.geometry.number_of_sites(), parts[1])

    def default_parts(self, inp):
        return ("ne", inp.integer("TargetElectronsTotal"))

    def orbitals(self, site) -> int:
        return 1

    def has_new_parts(self, parts, op, spin, orb):
        """Always the same basis (reference:
        HubbardOneOrbitalRashbaSOC.h:88-95 returns false); diagonal ops
        stay, sector-changing ops are unsupported."""
        from lanczosplusplus_tpu_torch.engine import operators as ops
        if op.name in (ops.SZ, ops.N, ops.NIL):
            return parts
        return None

    def hamiltonian(self, basis: RashbaBasis,
                    dtype: torch.dtype = torch.float64,
                    device="cpu") -> Hamiltonian:
        torch_dtype, dtype = dtype, numpy_dtype(dtype)
        n = self.geometry.number_of_sites()
        dim = basis.size
        u = self.params.hubbard_u
        v = self.params.potential_v
        bonds = directed_bonds(self.hoppings)
        rbonds = directed_bonds(self.rashba)
        k = max(2 * len(bonds) + 2 * len(rbonds), 1)
        diag = np.zeros(dim, dtype=np.float64)
        cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
        vals = np.zeros((dim, k), dtype=dtype)

        for ndown in range(basis.ne + 1):
            blk = basis.block(ndown)
            if blk is None:
                continue
            up, dn, off = blk
            szu, szd = up.size, dn.size
            bdim = szu * szd
            nu = up.occupation_table().astype(np.float64)
            nd = dn.occupation_table().astype(np.float64)
            # block diagonal: U n_u n_d + V (n_u + n_d); block index
            # idn + iu*szd (down fastest)
            d2 = (nu * u[None, :]) @ nd.T      # (szu, szd)
            d2 = d2 + (nu @ v)[:, None] + (nd @ v)[None, :]
            diag[off:off + bdim] = d2.reshape(-1)

            iu = np.arange(szu, dtype=np.int64)
            idn = np.arange(szd, dtype=np.int64)
            slot = 0
            # spin-conserving hopping within the block
            for (i, j, t) in bonds:
                # up hop
                occ_i = bits.get_bit(up.words, i)
                occ_j = bits.get_bit(up.words, j)
                ok = (occ_i == 1) & (occ_j == 0)
                mid = bits.flip_bit(up.words, i)
                sgn = bits.parity_sign_below(up.words, i) * \
                    bits.parity_sign_below(mid, j)
                tgt_u = np.where(ok, up.rank(bits.flip_bit(mid, j)), iu)
                tgt = off + idn[None, :] + tgt_u[:, None] * szd
                rows = slice(off, off + bdim)
                cols_blk = cols[rows].reshape(szu, szd, k)
                vals_blk = vals[rows].reshape(szu, szd, k)
                cols_blk[:, :, slot] = tgt
                vals_blk[:, :, slot] = np.where(ok, t * sgn, 0)[:, None]
                slot += 1
                # down hop
                occ_i = bits.get_bit(dn.words, i)
                occ_j = bits.get_bit(dn.words, j)
                ok = (occ_i == 1) & (occ_j == 0)
                mid = bits.flip_bit(dn.words, i)
                sgn = bits.parity_sign_below(dn.words, i) * \
                    bits.parity_sign_below(mid, j)
                tgt_d = np.where(ok, dn.rank(bits.flip_bit(mid, j)), idn)
                cols_blk[:, :, slot] = off + tgt_d[None, :] + \
                    iu[:, None] * szd
                vals_blk[:, :, slot] = np.where(ok, t * sgn, 0)[None, :]
                slot += 1
            # Rashba spin flips
            for (i, j, r) in rbonds:
                # c^dag_j_up c_i_down: needs up empty at j, down occ at i
                blk_to = basis.block(ndown - 1) if ndown >= 1 else None
                if blk_to is not None:
                    up2, dn2, off2 = blk_to
                    oku = bits.get_bit(up.words, j) == 0
                    okd = bits.get_bit(dn.words, i) == 1
                    s_u = bits.parity_sign_below(up.words, j)
                    s_d = bits.parity_sign_below(dn.words, i)
                    # (-1)^{popcount(up word)} (HubbardHelper.h:257-258)
                    s_n = np.where(bits.popcount(up.words) & 1, -1, 1)
                    tgt_u = np.where(oku, up2.rank(bits.flip_bit(up.words, j)),
                                     0)
                    tgt_d = np.where(okd, dn2.rank(bits.flip_bit(dn.words, i)),
                                     0)
                    tgt = off2 + tgt_d[None, :] + tgt_u[:, None] * dn2.size
                    ok2 = oku[:, None] & okd[None, :]
                    amp = r * (s_u * s_n)[:, None] * s_d[None, :]
                    cols_blk[:, :, slot] = np.where(
                        ok2, tgt, off + idn[None, :] + iu[:, None] * szd)
                    vals_blk[:, :, slot] = np.where(ok2, amp, 0)
                slot += 1
                # c^dag_j_down c_i_up: up occ at i, down empty at j
                blk_to = basis.block(ndown + 1) if ndown + 1 <= basis.ne \
                    else None
                if blk_to is not None:
                    up2, dn2, off2 = blk_to
                    oku = bits.get_bit(up.words, i) == 1
                    okd = bits.get_bit(dn.words, j) == 0
                    s_u = bits.parity_sign_below(up.words, i)
                    s_d = bits.parity_sign_below(dn.words, j)
                    # crossing factor (-1)^(n_up - 1): the created down
                    # operator passes the up string AFTER c_i_up removed
                    # one electron.  The reference uses (-1)^(n_up)
                    # (HubbardHelper.h:272-273), which breaks
                    # hermiticity for its own symmetric connectors and
                    # contradicts its analytic oracle
                    # (scripts/dispersion.pl6: bands (t+-r)(-2 cos k));
                    # this sign restores both.
                    s_n = np.where(bits.popcount(up.words) & 1, 1, -1)
                    tgt_u = np.where(oku, up2.rank(bits.flip_bit(up.words, i)),
                                     0)
                    tgt_d = np.where(okd, dn2.rank(bits.flip_bit(dn.words, j)),
                                     0)
                    tgt = off2 + tgt_d[None, :] + tgt_u[:, None] * dn2.size
                    ok2 = oku[:, None] & okd[None, :]
                    # the reference conjugates hr here
                    # (HubbardHelper.h:274), which breaks hermiticity
                    # for its own HERMITIAN connector matrices
                    # (geometry stores rashba[j,i] = conj(rashba[i,j])):
                    # the h.c. of branch A's r_ij c^dag_ju c_id arrives
                    # from bond (j,i) through this branch and needs
                    # amp = r_ij = conj(r_ji).  Same deliberate-fix
                    # family as the (-1)^(n_up-1) crossing sign above.
                    amp = r * (s_u * s_n)[:, None] * s_d[None, :]
                    cols_blk[:, :, slot] = np.where(
                        ok2, tgt, off + idn[None, :] + iu[:, None] * szd)
                    vals_blk[:, :, slot] = np.where(ok2, amp, 0)
                slot += 1
            cols[rows] = cols_blk.reshape(bdim, k)
            vals[rows] = vals_blk.reshape(bdim, k)

        return hamiltonian_from_numpy(
            diag.astype(dtype), cols, vals, None, None, None, None, None,
            device=device, dtype=torch_dtype)

    def block_kron_hamiltonian(self, basis: RashbaBasis,
                               dtype: torch.dtype = torch.float64,
                               device="cpu"):
        """The same Hamiltonian in block-Kronecker form: per-(nup,
        ndown)-block dense one-spin hop factors (GEMMs through
        ``factor_matmul``) plus the Rashba spin flips as partial
        permutations between adjacent blocks (``perm_gather``).  Flat
        ordering is identical to `hamiltonian` (block offset + idn + iu *
        szd).  No dispatch reaches it; the JAX package's bench compares
        it with the half-cut form."""
        from lanczosplusplus_tpu_torch.core.blockkron import (
            BlockKronHamiltonian, PermCrossTerm, to_device)

        torch_dtype, dtype = dtype, numpy_dtype(dtype)

        n = self.geometry.number_of_sites()
        u = self.params.hubbard_u
        v = self.params.potential_v
        bonds = directed_bonds(self.hoppings)
        rbonds = directed_bonds(self.rashba)
        cplx = np.iscomplexobj(np.zeros(0, dtype))

        def hop_dense(one_spin):
            """Dense one-spin hop operator A[row, col]: y[r] += A x."""
            sz = one_spin.size
            a = np.zeros((sz, sz),
                         dtype=np.complex128 if cplx else np.float64)
            rows = np.arange(sz, dtype=np.int64)
            for (i, j, t) in bonds:
                occ_i = bits.get_bit(one_spin.words, i)
                occ_j = bits.get_bit(one_spin.words, j)
                ok = (occ_i == 1) & (occ_j == 0)
                mid = bits.flip_bit(one_spin.words, i)
                sgn = bits.parity_sign_below(one_spin.words, i) * \
                    bits.parity_sign_below(mid, j)
                tgt = one_spin.rank(bits.flip_bit(mid, j))
                np.add.at(a, (rows[ok], tgt[ok]), (t * sgn)[ok])
            return a

        block_pos = {}
        shapes, diags, row_ops, col_ops = [], [], [], []
        for ndown in range(basis.ne + 1):
            blk = basis.block(ndown)
            if blk is None:
                continue
            up, dn, off = blk
            block_pos[ndown] = len(shapes)
            szu, szd = up.size, dn.size
            shapes.append((szu, szd))
            nu = up.occupation_table().astype(np.float64)
            nd = dn.occupation_table().astype(np.float64)
            d2 = (nu * u[None, :]) @ nd.T
            d2 = d2 + (nu @ v)[:, None] + (nd @ v)[None, :]
            diags.append(to_device(d2, torch_dtype, device))
            row_ops.append(to_device(hop_dense(up), torch_dtype, device))
            col_ops.append(to_device(hop_dense(dn), torch_dtype, device))

        cross = []
        nb = len(rbonds)
        for ndown, pos in block_pos.items():
            up, dn, _ = basis.block(ndown)
            szu, szd = up.size, dn.size
            # ELL convention: y rows of THIS block receive from the
            # neighbour block's columns (H[this, other] = amp), so the
            # cross term's dst is this block and src the neighbour.
            # The c-maps are partial permutations on each spin factor,
            # so the couplings are PermCrossTerms (one perm_gather
            # launch for all bonds) — dense (nb, szu', szu) factors
            # would cost nb GEMMs and O(nb szu^2) memory.
            # c^dag_j_up c_i_down branch: columns in ndown - 1
            if ndown - 1 in block_pos:
                up2, dn2, _ = basis.block(ndown - 1)
                row_src = np.zeros((nb, szu), np.int32)
                row_amp = np.zeros((nb, szu),
                                   dtype=np.complex128 if cplx
                                   else np.float64)
                col_src = np.zeros((nb, szd), np.int32)
                col_amp = np.zeros((nb, szd), dtype=row_amp.dtype)
                for bidx, (i, j, r) in enumerate(rbonds):
                    oku = bits.get_bit(up.words, j) == 0
                    okd = bits.get_bit(dn.words, i) == 1
                    s_u = bits.parity_sign_below(up.words, j)
                    s_d = bits.parity_sign_below(dn.words, i)
                    s_n = np.where(bits.popcount(up.words) & 1, -1, 1)
                    tgt_u = up2.rank(bits.flip_bit(up.words, j))
                    tgt_d = dn2.rank(bits.flip_bit(dn.words, i))
                    row_src[bidx] = np.where(oku, tgt_u, 0)
                    row_amp[bidx] = np.where(oku, r * s_u * s_n, 0)
                    col_src[bidx] = np.where(okd, tgt_d, 0)
                    col_amp[bidx] = np.where(okd, s_d, 0)
                cross.append(PermCrossTerm(
                    row_src=to_device(row_src, torch.int32, device),
                    row_amp=to_device(row_amp, torch_dtype, device),
                    col_src=to_device(col_src, torch.int32, device),
                    col_amp=to_device(col_amp, torch_dtype, device),
                    src=block_pos[ndown - 1], dst=pos))
            # c^dag_j_down c_i_up branch: columns in ndown + 1
            if ndown + 1 in block_pos:
                up2, dn2, _ = basis.block(ndown + 1)
                row_src = np.zeros((nb, szu), np.int32)
                row_amp = np.zeros((nb, szu),
                                   dtype=np.complex128 if cplx
                                   else np.float64)
                col_src = np.zeros((nb, szd), np.int32)
                col_amp = np.zeros((nb, szd), dtype=row_amp.dtype)
                for bidx, (i, j, r) in enumerate(rbonds):
                    oku = bits.get_bit(up.words, i) == 1
                    okd = bits.get_bit(dn.words, j) == 0
                    s_u = bits.parity_sign_below(up.words, i)
                    s_d = bits.parity_sign_below(dn.words, j)
                    # (-1)^(n_up - 1) crossing sign; see the
                    # hermiticity note in `hamiltonian`
                    s_n = np.where(bits.popcount(up.words) & 1, 1, -1)
                    tgt_u = up2.rank(bits.flip_bit(up.words, i))
                    tgt_d = dn2.rank(bits.flip_bit(dn.words, j))
                    row_src[bidx] = np.where(oku, tgt_u, 0)
                    row_amp[bidx] = np.where(oku, r * s_u * s_n, 0)
                    col_src[bidx] = np.where(okd, tgt_d, 0)
                    col_amp[bidx] = np.where(okd, s_d, 0)
                cross.append(PermCrossTerm(
                    row_src=to_device(row_src, torch.int32, device),
                    row_amp=to_device(row_amp, torch_dtype, device),
                    col_src=to_device(col_src, torch.int32, device),
                    col_amp=to_device(col_amp, torch_dtype, device),
                    src=block_pos[ndown + 1], dst=pos))
        return BlockKronHamiltonian(
            diag=tuple(diags), row_ops=tuple(row_ops),
            col_ops=tuple(col_ops), cross=(),
            shapes=tuple(shapes), perm_cross=tuple(cross))

    def operator_map(self, op, site, spin, orb, src_basis, dst_basis):
        """n and sz (diagonal) only, consistent with the reference's
        capability (BasisRashbaSOC getBraIndex throws)."""
        from lanczosplusplus_tpu_torch.engine import operators as ops

        dim = src_basis.size
        occ_up = np.zeros(dim, dtype=np.int64)
        occ_dn = np.zeros(dim, dtype=np.int64)
        for ndown in range(src_basis.ne + 1):
            blk = src_basis.block(ndown)
            if blk is None:
                continue
            up, dn, off = blk
            bdim = up.size * dn.size
            ou = bits.get_bit(up.words, site)
            od = bits.get_bit(dn.words, site)
            occ_up[off:off + bdim] = np.repeat(ou, dn.size)
            occ_dn[off:off + bdim] = np.tile(od, up.size)
        idx = np.arange(dim, dtype=np.int64)
        if op.name == ops.N:
            occ = occ_up if spin == 0 else occ_dn
            return (np.where(occ == 1, idx, -1), occ.astype(np.float64),
                    dim)
        if op.name == ops.SZ:
            val = occ_up - occ_dn
            return (np.where(val != 0, idx, -1), val.astype(np.float64),
                    dim)
        raise NotImplementedError(
            f"RashbaSOC operator_map: {op.name} unsupported "
            "(as in reference)")
