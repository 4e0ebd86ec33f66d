"""Spin-orbital SU(2)xSU(2) chain (reference: src/SpinOrbital.cpp).

Counterpart of ``lanczosplusplus_tpu/models/spin_orbital.py``.  The basis
and the arrays are built on the host in numpy and moved to the device once
(``hamiltonian_from_numpy``).

Open chain; each site carries a spin-J degree of freedom S and an
orbital-J one L (J = twiceJ/2).  The bond Hamiltonian is the product of
per-sector exchange pieces:

    H = sum_i sum_{w0,w1 in {+-, -+, zz}} T_S(i, w0) (x) T_L(i, w1)

with the reference's amplitudes (SpinOrbital.cpp:96-127): the +- term
carries 0.5*(J(J+1) - m_i(m_i+1)), the -+ term
0.5*(J(J+1) - m_j(m_j+1)) and zz carries m_i*m_j.  For J=1/2 this is
exactly (S_i.S_{i+1})(L_i.L_{i+1}); for higher J we reproduce the
reference's amplitudes verbatim (they are NOT the sqrt SU(2) matrix
elements — a faithful behavioral transcription, like the FeAs INT_V
dead code).

The build is vectorized: states are base-(2J+1) digit words (site 0 =
lowest digit, SpinOrbital.cpp:161-173), each sector's one-bond term is
a (value, target) array over its chain, and the full term is the outer
product over the S and L chains — no per-state host loop.
"""

from __future__ import annotations

import numpy as np
import torch
from lanczosplusplus_tpu_torch.config import numpy_dtype
from lanczosplusplus_tpu_torch.core.sparse import (
    Hamiltonian, coo_to_ell, hamiltonian_from_numpy)


def _digit_tables(nsites: int, nper: int):
    states = nper ** nsites
    ids = np.arange(states)
    digits = np.empty((states, nsites), dtype=np.int64)
    tmp = ids.copy()
    for i in range(nsites):
        digits[:, i] = tmp % nper
        tmp //= nper
    return states, digits


def _one_sector_terms(nsites: int, twice_j: int):
    """Per bond (i, i+1) and `which` in {0: +-, 1: -+, 2: zz}: value and
    target-state arrays over one chain's state space (-1 target =
    forbidden move)."""
    nper = twice_j + 1
    states, digits = _digit_tables(nsites, nper)
    jv = 0.5 * twice_j
    out = {}
    for i in range(nsites - 1):
        j = i + 1
        mi = digits[:, i] - jv
        mj = digits[:, j] - jv
        # which = 0: raise at i, lower at j
        ok0 = (digits[:, i] < twice_j) & (digits[:, j] > 0)
        val0 = 0.5 * (jv * (jv + 1) - mi * (mi + 1))
        tgt0 = np.where(ok0,
                        np.arange(states) + nper ** i - nper ** j, -1)
        # which = 1: lower at i, raise at j
        ok1 = (digits[:, j] < twice_j) & (digits[:, i] > 0)
        val1 = 0.5 * (jv * (jv + 1) - mj * (mj + 1))
        tgt1 = np.where(ok1,
                        np.arange(states) - nper ** i + nper ** j, -1)
        # which = 2: zz (diagonal)
        val2 = mi * mj
        tgt2 = np.arange(states)
        out[(i, 0)] = (np.where(ok0, val0, 0.0), tgt0)
        out[(i, 1)] = (np.where(ok1, val1, 0.0), tgt1)
        out[(i, 2)] = (val2, tgt2)
    return states, out


def build_spin_orbital(nsites: int, twice_j: int = 2,
                       dtype: torch.dtype = torch.float64,
                       device="cpu") -> Hamiltonian:
    """Full (statesS * statesL) Hamiltonian; row id = idS + idL*statesS
    (reference: SpinOrbital.cpp:155-159 packSandL)."""
    torch_dtype, dtype = dtype, numpy_dtype(dtype)
    states, terms = _one_sector_terms(nsites, twice_j)
    total = states * states
    rows_l, cols_l, vals_l = [], [], []
    ids = np.arange(states)
    for i in range(nsites - 1):
        for w0 in range(3):
            for w1 in range(3):
                vs, ts = terms[(i, w0)]   # spin chain factor
                vl, tl = terms[(i, w1)]   # orbital chain factor
                # outer product over (idS, idL)
                val = vs[None, :] * vl[:, None]
                ok = (ts[None, :] >= 0) & (tl[:, None] >= 0) & (val != 0)
                row = ids[None, :] + ids[:, None] * states
                col = ts[None, :] + tl[:, None] * states
                rows_l.append(row[ok])
                cols_l.append(col[ok])
                vals_l.append(val[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l).astype(dtype)
    ell_cols, ell_vals = coo_to_ell(total, rows, cols, vals)
    # pull the diagonal out of the ELL (zz (x) zz terms land there)
    on_diag = ell_cols == np.arange(total)[:, None]
    diag = np.where(on_diag, ell_vals, 0).sum(axis=1)
    ell_vals = np.where(on_diag, 0, ell_vals)
    return hamiltonian_from_numpy(
        diag.astype(dtype), ell_cols, ell_vals, None, None, None, None,
        None, device=device, dtype=torch_dtype)
