"""Symmetry-sector block diagonalization: translation (momentum) and
reflection (parity) blocks.

Counterpart of ``lanczosplusplus_tpu/symmetry/blocks.py``, function for
function: the signed state permutations (``_permute_word``,
``_permutation_parity_sign``, ``_bit_perm``, ``_StatePermutation``), the
representative rows read straight off a sector's Hamiltonian form
(``_restricted_rows``, ``_blockkron_restricted_rows``), the orbit-block
assembly (``_OrbitBlockSymmetry``) and its groups (``TranslationSymmetry``
with the second ladder direction, ``ReflectionSymmetry``,
``DefaultSymmetry``, ``build_symmetry``).  reference:
src/Engine/{DefaultSymmetry,TranslationSymmetry,ReflectionSymmetry}.h.
Duck-typed interface (used by Engine::computeAllStatesBelow,
Engine.h:601-657): sectors(), block_hamiltonian(s), transform(vec, sector)
back to the site basis.

Design differences from the reference, as in the JAX package:
- T and R act on Slater words *with* the parity of the site permutation
  (the reference's word translation and reflection ignore the fermionic
  sign, TranslationSymmetry.h:147-167, ReflectionSymmetry.h:66-117); for
  spin models the signs are the identity.
- the split checks that the Hamiltonian commutes with the group and raises
  otherwise (the reference's split silently drops off-block elements,
  TranslationSymmetry.h:359-393).

The set-up and every block are host numpy and scipy.  The form whose rows
are read is built on the CPU (its tables are only read back); each block
becomes a ``Hamiltonian`` with a padded ELL on the device the symmetry is
given, which the solver applies through ``ell_spmv``: float64 for a real
block, complex128 (its diagonal too) for a momentum block with complex
entries, and a float32 (complex64) block as that block's narrowed copy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from lanczosplusplus_tpu_torch.config import numpy_dtype, real_dtype_of
from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD
from lanczosplusplus_tpu_torch.core.blockkron import (BlockKronHamiltonian,
                                                      PermutedHamiltonian)
from lanczosplusplus_tpu_torch.core.sparse import (Hamiltonian, coo_to_ell,
                                                   hamiltonian_from_numpy)
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    FactoredKitaevHamiltonian)
from lanczosplusplus_tpu_torch.ops.refine import solve_pair


def _host(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _csr_to_ell_ham(m: sp.csr_matrix, dtype: torch.dtype, device):
    """A block's CSR matrix as a ``Hamiltonian`` on `device`: its diagonal
    apart, the rest a padded ELL whose padding points at its own row with
    value 0; values and diagonal of `dtype`.  Returns it with the count of
    the ELL's nonzero entries (its padding excluded), taken on the host."""
    m = m.tocoo()
    dim = m.shape[0]
    np_dtype = numpy_dtype(dtype)
    diag_mask = m.row == m.col
    diag = np.zeros(dim, dtype=np_dtype)
    np.add.at(diag, m.row[diag_mask], m.data[diag_mask]
              if dtype.is_complex else np.real(m.data[diag_mask]))
    off = ~diag_mask
    cols, vals = coo_to_ell(dim, m.row[off], m.col[off],
                            m.data[off].astype(np_dtype))
    return (hamiltonian_from_numpy(diag, cols, vals, None, None, None, None,
                                   None, device, dtype),
            int(np.count_nonzero(m.data[off])))


def _permute_word(words: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """New word with bit perm[site] = old bit site."""
    out = np.zeros_like(words, dtype=WORD)
    for site, tgt in enumerate(perm):
        bit = (words >> WORD(site)) & WORD(1)
        out |= bit << WORD(int(tgt))
    return out


def _permutation_parity_sign(words: np.ndarray, perm: np.ndarray,
                             fermionic: bool) -> np.ndarray:
    """Sign of reordering the occupied-mode creation string after the
    site relabeling site -> perm[site]."""
    if not fermionic:
        return np.ones(words.shape[0])
    n = len(perm)
    occ = bits.bits_to_table(words, n).astype(np.int64)  # (dim, n)
    # parity of the permutation sorting the new positions of the occupied
    # modes: count inversions pairwise (n is small)
    signs = np.ones(words.shape[0], dtype=np.int64)
    for a in range(n):
        for b in range(a + 1, n):
            both = (occ[:, a] == 1) & (occ[:, b] == 1)
            inverted = both & (perm[a] > perm[b])
            signs = np.where(inverted, -signs, signs)
    return signs.astype(np.float64)


def _dense_to_ell_host(m, tol=0.0):
    """Host ELL (cols, vals) of a small dense matrix, rows padded to
    the max row-nnz with (col=0, val=0) slots."""
    m = _host(m)
    csr = sp.csr_matrix(m)
    if tol:
        csr.data[np.abs(csr.data) < tol] = 0
        csr.eliminate_zeros()
    nnz_per_row = np.diff(csr.indptr)
    k = max(1, int(nnz_per_row.max(initial=1)))
    n = m.shape[0]
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k), m.dtype)
    rows = np.repeat(np.arange(n), nnz_per_row)
    slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    cols[rows, slot] = csr.indices
    vals[rows, slot] = csr.data
    return cols, vals


def _blockkron_restricted_rows(bk: BlockKronHamiltonian, reps):
    """Representative ROWS of a BlockKronHamiltonian in INNER (block)
    order: (cols (n, K), vals (n, K), diag (n,)) with inner column
    indices.  Every contribution (per-block row/col operators, dense
    CrossTerms with their Hermitian partners, PermCrossTerm channels) is
    read off the factor structure; nothing dim x K is built."""
    shapes = bk.shapes
    sizes = np.array([r * c for (r, c) in shapes], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    reps = np.asarray(reps)
    blk = np.searchsorted(offs, reps, side="right") - 1
    vdt = np.complex128 if bk.dtype.is_complex else np.float64
    n = reps.shape[0]
    diag_out = np.zeros(n, vdt)
    chunks = [None] * n  # per-rep (cols, vals) 1-D arrays

    # index cross terms by block
    pc_by_dst = {}
    for t in bk.perm_cross:
        pc_by_dst.setdefault(t.dst, []).append(t)
    cr_by_dst = {}
    cr_by_src = {}
    for t in bk.cross:
        cr_by_dst.setdefault(t.dst, []).append(t)
        if t.add_hc:
            cr_by_src.setdefault(t.src, []).append(t)

    for b in np.unique(blk):
        sel = np.nonzero(blk == b)[0]
        R, C = shapes[b]
        r, c = np.divmod(reps[sel] - offs[b], C)
        diag_out[sel] = _host(bk.diag[b]).astype(vdt)[r, c]
        cs, vs = [], []
        if bk.row_ops[b] is not None:
            rc, rv = _dense_to_ell_host(bk.row_ops[b])
            cs.append(offs[b] + rc[r] * C + c[:, None])
            vs.append(rv[r].astype(vdt))
        if bk.col_ops[b] is not None:
            cc, cv = _dense_to_ell_host(bk.col_ops[b])
            cs.append(offs[b] + (r * C)[:, None] + cc[c])
            vs.append(cv[c].astype(vdt))
        for t in pc_by_dst.get(int(b), ()):
            Cs = shapes[t.src][1]
            rs = _host(t.row_src)
            ra = _host(t.row_amp).astype(vdt)
            csrc = _host(t.col_src)
            ca = _host(t.col_amp).astype(vdt)
            for k in range(rs.shape[0]):
                cs.append((offs[t.src] + rs[k][r].astype(np.int64) * Cs
                           + csrc[k][c].astype(np.int64))[:, None])
                vs.append((ra[k][r] * ca[k][c])[:, None])
        for t in cr_by_dst.get(int(b), ()):
            Cs = shapes[t.src][1]
            left = _host(t.left)
            right = _host(t.right)
            for k in range(left.shape[0]):
                lc, lv = _dense_to_ell_host(left[k])
                rc2, rv2 = _dense_to_ell_host(right[k])
                cs.append((offs[t.src]
                           + lc[r][:, :, None] * Cs
                           + rc2[c][:, None, :]).reshape(len(sel), -1))
                vs.append((lv[r][:, :, None].astype(vdt)
                           * rv2[c][:, None, :]).reshape(len(sel), -1))
        for t in cr_by_src.get(int(b), ()):
            # Hermitian partner: H[src (r, c), dst (o, d)] =
            # sum_k conj(left[k][o, r]) conj(right[k][d, c])
            Cd = shapes[t.dst][1]
            left = _host(t.left)
            right = _host(t.right)
            for k in range(left.shape[0]):
                lc, lv = _dense_to_ell_host(np.conj(left[k]).T)
                rc2, rv2 = _dense_to_ell_host(np.conj(right[k]).T)
                cs.append((offs[t.dst]
                           + lc[r][:, :, None] * Cd
                           + rc2[c][:, None, :]).reshape(len(sel), -1))
                vs.append((lv[r][:, :, None].astype(vdt)
                           * rv2[c][:, None, :]).reshape(len(sel), -1))
        gc = np.concatenate(cs, axis=1) if cs else \
            np.zeros((len(sel), 1), np.int64)
        gv = np.concatenate(vs, axis=1) if vs else \
            np.zeros((len(sel), 1), vdt)
        for i, idx in enumerate(sel):
            chunks[idx] = (gc[i], gv[i])
    K = max(ch[0].shape[0] for ch in chunks)
    cols = np.zeros((n, K), np.int64)
    vals = np.zeros((n, K), vdt)
    for i, (gc, gv) in enumerate(chunks):
        cols[i, :gc.shape[0]] = gc
        vals[i, :gv.shape[0]] = gv
    return cols, vals, diag_out


def _restricted_rows(ham, reps):
    """(cols (nb, K), vals (nb, K), diag (nb,)) of the FLAT Hamiltonian
    at the representative rows only, assembled straight from the factor
    structure: the full dim x K flat ELL (multi-GB at the flagship dims)
    is never materialized (reference builds whole-sector CRS then
    conjugates, TranslationSymmetry.h:251-268).

    Supported forms: the flat ``Hamiltonian`` (diagonal + generic ELL +
    Kronecker spin factors, expanded per rep), the factored Kitaev
    half-cut (hl/hr/p,q rows through per-matrix host ELLs), and the
    BlockKron/Permuted half-cut factorizations (t-J, Rashba,
    Heisenberg-factored, FeAs) via `_blockkron_restricted_rows`."""
    reps = np.asarray(reps)
    if isinstance(ham, PermutedHamiltonian):
        # row f of H_flat is row inv[f] of the inner block form with
        # columns mapped through perm and the optional Jordan-Wigner wrap
        # sign applied on both sides
        inv = _host(ham.inv).astype(np.int64)
        perm = _host(ham.perm).astype(np.int64)
        p = inv[reps]
        cols_i, vals, diag = _blockkron_restricted_rows(ham.inner, p)
        if ham.sign is not None:
            s = _host(ham.sign)
            vals = vals * s[p][:, None] * s[cols_i]
        return perm[cols_i], vals, diag
    if isinstance(ham, BlockKronHamiltonian):
        return _blockkron_restricted_rows(ham, reps)
    if isinstance(ham, FactoredKitaevHamiltonian):
        diag2d = _host(ham.diag2d)
        dl, dr = diag2d.shape
        a, b = np.divmod(reps, dr)
        diag = diag2d.reshape(-1)[reps]
        blocks_c, blocks_v = [], []
        hl_c, hl_v = _dense_to_ell_host(ham.hl)
        blocks_c.append(hl_c[a] * dr + b[:, None])
        blocks_v.append(hl_v[a])
        hr_c, hr_v = _dense_to_ell_host(_host(ham.hr_t).T)
        blocks_c.append(a[:, None] * dr + hr_c[b])
        blocks_v.append(hr_v[b])
        p, q = _host(ham.p), _host(ham.q)
        for k in range(p.shape[0]):
            p_c, p_v = _dense_to_ell_host(p[k])
            q_c, q_v = _dense_to_ell_host(q[k])
            # row (a, b) of P_k (x) Q_k: outer product of the two row
            # slot lists; padded slots carry val 0 (col 0 is harmless)
            blocks_c.append((p_c[a][:, :, None] * dr +
                             q_c[b][:, None, :]).reshape(len(reps), -1))
            blocks_v.append((p_v[a][:, :, None] *
                             q_v[b][:, None, :]).reshape(len(reps), -1))
        return (np.concatenate(blocks_c, axis=1),
                np.concatenate(blocks_v, axis=1), diag)
    if ham.factorized is not None:
        szd, szu = ham.spin_shape
        f = ham.factorized
        d, u = np.divmod(reps, szu)
        diag = _host(ham.diag)[reps]
        blocks_c, blocks_v = [], []
        if f.up_cols is not None:
            cu = _host(f.up_cols).astype(np.int64)
            blocks_c.append(cu[u] + (d * szu)[:, None])
            blocks_v.append(_host(f.up_vals)[u])
        if f.dn_cols is not None:
            cd = _host(f.dn_cols).astype(np.int64)
            blocks_c.append(cd[d] * szu + u[:, None])
            blocks_v.append(_host(f.dn_vals)[d])
        if ham.ell is not None:
            blocks_c.append(_host(ham.ell.cols)[reps].astype(np.int64))
            blocks_v.append(_host(ham.ell.vals)[reps])
        return (np.concatenate(blocks_c, axis=1),
                np.concatenate(blocks_v, axis=1), diag)
    return (_host(ham.ell.cols)[reps].astype(np.int64),
            _host(ham.ell.vals)[reps], _host(ham.diag)[reps])


def _bit_perm(perm, orbitals: int) -> np.ndarray:
    """Expand a SITE permutation to the BIT permutation of a collated
    multi-orbital word layout (bit = site*orbitals + orb): orbitals
    ride along with their site, preserving within-site order."""
    perm = np.asarray(perm)
    if orbitals == 1:
        return perm
    out = np.empty(perm.shape[0] * orbitals, dtype=np.int64)
    for s, t in enumerate(perm):
        for orb in range(orbitals):
            out[s * orbitals + orb] = int(t) * orbitals + orb
    return out


class _StatePermutation:
    """Index map + sign of a site permutation on a basis: the two-word
    (up, down) product bases, the Heisenberg digit words, t-J's combined
    words, Kitaev's identity basis and the Rashba total-N union.
    Multi-orbital bases (FeAs, multi-orbital t-J: bit layout
    site*orbitals + orb) expand the site permutation to the bit level
    (the reference supports any basis through perfectIndex,
    TranslationSymmetry.h:147-167)."""

    def __init__(self, basis, perm, fermionic=True):
        perm = _bit_perm(perm, getattr(basis, "orbitals", 1))
        if hasattr(basis, "up"):
            upw = basis.up.words
            dnw = basis.down.words
            new_up = _permute_word(upw, perm)
            new_dn = _permute_word(dnw, perm)
            s_up = _permutation_parity_sign(upw, perm, fermionic)
            s_dn = _permutation_parity_sign(dnw, perm, fermionic)
            iu = basis.up.rank(new_up)
            idn = basis.down.rank(new_dn)
            self.tgt = (iu[None, :] +
                        idn[:, None] * basis.up.size).reshape(-1)
            self.sign = (s_up[None, :] * s_dn[:, None]).reshape(-1)
        elif hasattr(basis, "digits"):  # Heisenberg: bosonic, digit word
            words = basis.words
            new = np.zeros_like(words)
            mask = WORD((1 << basis.bits) - 1)
            for site, t in enumerate(perm):
                digit = (words >> WORD(site * basis.bits)) & mask
                new |= digit << WORD(int(t) * basis.bits)
            self.tgt = basis.rank(new)
            self.sign = np.ones(basis.size)
        elif hasattr(basis, "up_words"):  # t-J combined words
            new_up = _permute_word(basis.up_words, perm)
            new_dn = _permute_word(basis.dn_words, perm)
            s_up = _permutation_parity_sign(basis.up_words, perm, fermionic)
            s_dn = _permutation_parity_sign(basis.dn_words, perm, fermionic)
            self.tgt = basis.rank(new_up, new_dn)
            self.sign = s_up * s_dn
        elif hasattr(basis, "words"):  # Kitaev: one bit/site, full 2^n
            new = _permute_word(basis.words, perm)
            self.tgt = basis.rank(new)
            self.sign = np.ones(basis.size)
        elif hasattr(basis, "blocks") and hasattr(basis, "ne"):
            # Rashba total-N union basis: per-state (up, dn) words via
            # the union tables, ranked back through the union layout
            from lanczosplusplus_tpu_torch.models.rashba_halfcut import (
                _union_rank, _union_tables)
            upw, dnw = _union_tables(basis)
            new_up = _permute_word(upw, perm)
            new_dn = _permute_word(dnw, perm)
            s_up = _permutation_parity_sign(upw, perm, fermionic)
            s_dn = _permutation_parity_sign(dnw, perm, fermionic)
            ok = np.ones(basis.size, bool)
            self.tgt = _union_rank(basis, new_up, new_dn, ok)
            self.sign = s_up * s_dn
        else:
            raise ValueError("symmetry: unsupported basis")


class DefaultSymmetry:
    """Identity symmetry, 1 sector (reference: DefaultSymmetry.h)."""

    def __init__(self, basis, geometry, model, device="cpu"):
        self.basis = basis
        self.model = model
        self.device = device

    def sectors(self) -> int:
        return 1

    def block_hamiltonian(self, s, dtype=torch.float64) -> Hamiltonian:
        return self.model.hamiltonian(self.basis, dtype=dtype,
                                      device=self.device)

    def transform(self, vec, sector):
        return np.asarray(vec)


class _OrbitBlockSymmetry:
    """Shared row-restricted machinery for symmetry-adapted blocks of
    an abelian group acting by signed state permutations.

    A subclass provides the composed group action (`g_tgt`, `g_sign`,
    both (G, dim)) and a character table `chars` (S, G); the base
    assembles each sector's block ELL from the representative ROWS of
    the flat term index maps alone:

        H_s[a, b] = G * sum_{slots of row rep_a} val * w_s[col]
                      / (||v_a|| ||v_b||),   b = orbit(col)

    where w_s[x] = sum_g chars[s, g] sigma_g(b) [x = g . rep_b] is the
    symmetry-adapted amplitude table (one O(dim) pass per group
    element).  No full-sector CSR, no dense projector, no U.H.U^dag
    SpGEMM: O(dim * K / G) per block."""

    def _setup(self, ham, g_tgt, g_sign, chars, dtype, device):
        dim = g_tgt.shape[1]
        self._ham = ham
        self._g_tgt = g_tgt
        self._g_sign = g_sign
        self._chars = np.asarray(chars, dtype=np.complex128)
        self.device = torch.device(device)
        # orbits: the canonical element of each orbit is its minimum
        # over the group action, so one vectorized min + unique pass
        # replaces a per-state scan
        canon = g_tgt.min(axis=0)
        reps = np.unique(canon)
        self._orbit_of = np.searchsorted(reps, canon)
        self._reps = reps

        # restricted rows straight from the factor structure (the full
        # flat ELL is never materialized)
        self._rep_cols, self._rep_vals, self._rep_diag = \
            _restricted_rows(ham, reps)
        self._dtype = dtype
        self._sector_cache = {}
        # sector -> the nonzero entries of its block's ELL (no padding)
        self.block_entries = {}
        # sector row selection via the stabilizer twisted character:
        # for g in stab(b), sigma_g(b) restricted to the stabilizer is
        # itself a +-1 character, so w[x] has CONSTANT magnitude
        # |sum_{g in stab} chars[s,g] sigma_g(b)| on the whole orbit:
        # one (G, nreps) stabilizer table serves every sector at
        # O(S * nreps) instead of an O(S * G * dim) per-sector w-table
        # scan
        stab_phase = np.where(g_tgt[:, reps] == reps[None, :],
                              g_sign[:, reps], 0.0)     # (G, nreps)
        total = 0
        self._sector_rows = []
        for s in range(self._chars.shape[0]):
            coef = self._chars[s][:, None] * stab_phase
            rows = np.nonzero(np.abs(coef.sum(axis=0)) > 1e-8)[0]
            self._sector_rows.append(rows)
            total += rows.shape[0]
        if total != dim:
            raise ValueError(f"symmetry blocks sum {total} != {dim}")

    def _validate_commutation(self, ham, generators, dim,
                              max_dim: int = 1 << 21):
        """[H, g] = 0 on a random vector, signs included (replaces the
        reference's off-block scan, TranslationSymmetry.h:359-393,
        ReflectionSymmetry.h:302-331), through the form's matvec on the
        CPU.  Above `max_dim` the probe's host matvecs would dominate the
        whole build (flagship sectors); the block-size sum check in
        _setup still runs there."""
        if dim > max_dim:
            return
        rng = np.random.default_rng(11)
        z = rng.standard_normal(dim)

        def apply(v):
            return _host(ham.matvec(torch.as_tensor(v).to(ham.dtype)))
        hz = apply(z)
        for step in generators:
            tz = np.zeros(dim)
            np.add.at(tz, step.tgt, step.sign * z)
            htz = apply(tz)
            thz = np.zeros(dim)
            np.add.at(thz, step.tgt, step.sign * hz)
            err = np.abs(htz - thz).max()
            scale = max(np.abs(hz).max(), 1.0)
            if err > 1e-8 * scale:
                raise ValueError(
                    "Hamiltonian does not commute with the "
                    f"symmetry (residual {err:.2e})")

    def _w_table(self, s):
        """w[x] = sum_g chars[s,g] sigma [x = g rep(x)], plus per-orbit
        norm^2 (= ||v_b||^2)."""
        dim = self._g_tgt.shape[1]
        w = np.zeros(dim, dtype=np.complex128)
        for g in range(self._g_tgt.shape[0]):
            members = self._g_tgt[g, self._reps]
            np.add.at(w, members,
                      self._chars[s, g] * self._g_sign[g, self._reps])
        norm2 = np.zeros(self._reps.shape[0])
        np.add.at(norm2, self._orbit_of, np.abs(w) ** 2)
        return w, norm2

    def sectors(self) -> int:
        return len(self._sector_rows)

    def block_hamiltonian(self, s, dtype=None):
        """Sector s's block as a ``Hamiltonian`` on the symmetry's device
        (None for an empty sector), cached by sector and precision: in
        `dtype`'s precision (default the symmetry's), real where the block
        is real and complex where it is not.  A float32 or complex64 block
        is the float64 one narrowed (``block_pair``)."""
        key = (s, real_dtype_of(dtype or self._dtype))
        if key in self._sector_cache:
            return self._sector_cache[key]
        return self.block_pair(s, dtype)[0]

    def block_pair(self, s, dtype=None):
        """(sector s's block in `dtype`'s precision, the float64 or
        complex128 block it was narrowed from), or (None, None) for an
        empty sector (``ops/refine.solve_pair``).  Every block is
        assembled in float64 (complex128 for a momentum block with complex
        entries), and a float32 one is that block's copy (JAX
        ``block_hamiltonian(s, dtype=np.float32)`` casts the same float64
        entries), so the wide block is the twin a float32 solve refines
        its energies against.  Only the block in `dtype`'s precision is
        cached: the wide one of a float32 block is assembled anew (or
        taken from the float64 cache), and is the caller's to drop."""
        if self._sector_rows[s].shape[0] == 0:
            return None, None
        real = real_dtype_of(dtype or self._dtype)
        wide = self._sector_cache.get((s, torch.float64))
        if wide is None:
            wide = self._assemble(s)
        if (s, real) not in self._sector_cache:
            self._sector_cache[(s, real)] = solve_pair(wide, real)[0]
        return self._sector_cache[(s, real)], wide

    def _assemble(self, s):
        """Sector s's block in float64, or complex128 where its entries
        are complex; its nonzero ELL entries go to ``block_entries``."""
        rows = self._sector_rows[s]
        w, norm2 = self._w_table(s)
        nb = rows.shape[0]
        kidx = np.full(self._reps.shape[0], -1, dtype=np.int64)
        kidx[rows] = np.arange(nb)
        g = self._g_tgt.shape[0]
        inv_norm = np.zeros_like(norm2)
        inv_norm[rows] = 1.0 / np.sqrt(norm2[rows])
        cols = self._rep_cols[rows]            # (nb, K) global states
        vals = self._rep_vals[rows]
        b_orb = self._orbit_of[cols]
        bcols = kidx[b_orb]
        amp = vals * w[cols] * g * \
            (inv_norm[rows][:, None] * inv_norm[b_orb])
        ok = bcols >= 0
        bcols = np.where(ok, bcols, 0)
        amp = np.where(ok, amp, 0)
        # merge duplicates + split diagonal
        ridx = np.repeat(np.arange(nb), cols.shape[1])
        m = sp.coo_matrix((amp.reshape(-1),
                           (ridx, bcols.reshape(-1))),
                          shape=(nb, nb)).tocsr()
        m = m + sp.diags(self._rep_diag[rows].astype(np.complex128))
        m.data[np.abs(m.data) < 1e-14] = 0
        m.eliminate_zeros()
        imag_max = float(np.max(np.abs(m.data.imag))) if m.nnz else 0.0
        if imag_max < 1e-10:
            block, entries = _csr_to_ell_ham(m.real.tocsr(), torch.float64,
                                             self.device)
        else:
            block, entries = _csr_to_ell_ham(m, torch.complex128,
                                             self.device)
        self.block_entries[s] = entries
        return block

    def transform(self, vec, sector):
        """Back to the site basis: psi[x] = c[orbit(x)] w[x]/||v||, a host
        array, real where its imaginary part vanishes."""
        w, norm2 = self._w_table(sector)
        rows = self._sector_rows[sector]
        c_full = np.zeros(self._reps.shape[0], dtype=np.complex128)
        inv_norm = np.zeros_like(norm2)
        inv_norm[rows] = 1.0 / np.sqrt(norm2[rows])
        c_full[rows] = _host(vec)
        out = c_full[self._orbit_of] * w * inv_norm[self._orbit_of]
        if np.abs(out.imag).max() < 1e-10:
            return out.real
        return out


def _symmetry_ham(model, basis, dtype):
    """The Hamiltonian form that row-restricted block assembly reads, on
    the CPU (its tables are only read back): the model's `symmetry_form`
    where it has one (a factored form whose rows come without the flat
    ELL: Kitaev's half-cut form also serves the commutation probe, the
    t-J, Rashba and FeAs forms feed `_blockkron_restricted_rows`), else,
    or where that hook returns None or raises NotImplementedError for this
    basis, the flat form, which keeps its Kronecker factors unexpanded."""
    form = getattr(model, "symmetry_form", None)
    if form is not None:
        try:
            ham = form(basis, dtype=dtype)
        except NotImplementedError:
            ham = None
        if ham is not None:
            return ham
    return model.hamiltonian(basis, dtype=dtype)


class TranslationSymmetry(_OrbitBlockSymmetry):
    """Momentum blocks over the lattice translation group (reference:
    TranslationSymmetry.h) on the shared row-restricted machinery
    (_OrbitBlockSymmetry): characters exp(2i pi (kx rx/lx + ky ry/ly))
    over the cyclic product group.

    `use_y=True` (input label UseTranslationSymmetry=2) extends the
    group with the second ladder direction (the product of the two
    commuting cyclic translation groups; the reference supports
    direction 0 only).  Commutation [H, T] = 0 is validated by a
    randomized identity check instead of the dense off-block scan."""

    def __init__(self, basis, geometry, model, fermionic=True,
                 dtype=torch.float64, use_y=False, device="cpu"):
        nsite = geometry.number_of_sites()
        lx = geometry.length(0)
        ly = geometry.length(1) if use_y else 1
        dim = basis.size
        self.basis = basis
        ham = _symmetry_ham(model, basis, dtype)

        permx = np.array([geometry.translate(s, 0, 1)
                          for s in range(nsite)])
        stepx = _StatePermutation(basis, permx, fermionic)
        gens = [stepx]
        if ly > 1:
            permy = np.array([geometry.translate(s, 1, 1)
                              for s in range(nsite)])
            gens.append(_StatePermutation(basis, permy, fermionic))
        self._validate_commutation(ham, gens, dim)

        # composed group maps g = Ty^ry Tx^rx: (ly, lx, dim) index+sign
        g_tgt = np.empty((ly, lx, dim), dtype=np.int64)
        g_sign = np.empty((ly, lx, dim))
        g_tgt[0, 0] = np.arange(dim)
        g_sign[0, 0] = 1.0
        for rx in range(lx - 1):
            g_tgt[0, rx + 1] = stepx.tgt[g_tgt[0, rx]]
            g_sign[0, rx + 1] = g_sign[0, rx] * \
                stepx.sign[g_tgt[0, rx]]
        if ly > 1:
            stepy = gens[1]
            for ry in range(ly - 1):
                g_tgt[ry + 1] = stepy.tgt[g_tgt[ry]]
                g_sign[ry + 1] = g_sign[ry] * stepy.sign[g_tgt[ry]]
        self.lx, self.ly = lx, ly
        self._momenta = [(kx, ky) for ky in range(ly)
                         for kx in range(lx)]
        # characters over the flattened group index g = ry * lx + rx
        rys, rxs = np.divmod(np.arange(ly * lx), lx)
        chars = np.stack([
            np.exp(2j * np.pi * (kx * rxs / lx + ky * rys / ly))
            for (kx, ky) in self._momenta])
        self._setup(ham, g_tgt.reshape(-1, dim),
                    g_sign.reshape(-1, dim), chars, dtype, device)


class ReflectionSymmetry(_OrbitBlockSymmetry):
    """Parity (+/-) blocks under the lattice reflection (reference:
    ReflectionSymmetry.h) on the same row-restricted machinery as
    TranslationSymmetry: the group is {1, R} with characters (+1, +1)
    and (+1, -1), orbits are the {s, Rs} pairs (fixed points live in
    the sector their sign selects), and each block's ELL comes from
    representative rows (reference builds the plus/minus permutation
    directly, ReflectionSymmetry.h:66-190)."""

    def __init__(self, basis, geometry, model, fermionic=True,
                 dtype=torch.float64, device="cpu"):
        nsite = geometry.number_of_sites()
        perm = np.array([geometry.find_reflection(s)
                         for s in range(nsite)])
        refl = _StatePermutation(basis, perm, fermionic)
        dim = basis.size
        ham = _symmetry_ham(model, basis, dtype)
        self.basis = basis
        self._validate_commutation(ham, [refl], dim)
        g_tgt = np.stack([np.arange(dim, dtype=np.int64), refl.tgt])
        g_sign = np.stack([np.ones(dim), refl.sign])
        chars = np.array([[1.0, 1.0], [1.0, -1.0]])
        self._setup(ham, g_tgt, g_sign, chars, dtype, device)


def build_symmetry(inp, basis, geometry, model, fermionic=True,
                   device="cpu"):
    """The input's symmetry (UseTranslationSymmetry=1, or =2 with the
    second ladder direction, a capability extension over the reference's
    direction-0 group; UseReflectionSymmetry=1), its blocks on
    `device`."""
    use_t = inp.integer("UseTranslationSymmetry", default=0)
    if use_t > 0:
        return TranslationSymmetry(basis, geometry, model, fermionic,
                                   use_y=(use_t >= 2), device=device)
    if inp.integer("UseReflectionSymmetry", default=0) > 0:
        return ReflectionSymmetry(basis, geometry, model, fermionic,
                                  device=device)
    return DefaultSymmetry(basis, geometry, model, device=device)
