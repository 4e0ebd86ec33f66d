"""Pole-list broadening onto real or Matsubara frequency grids.

Counterpart of ``lanczosplusplus_tpu/engine/broadening.py`` (``prune``,
``lorentzian_grid``), host numpy, line for line.  Replaces the
reference's `lorentzian` binary (src/lorentzian.cpp:86-212):
G(z) = sum_i w_i / (z - e_i), evaluated at z = omega + i*eps (real mode)
or z = eps + i*omega_n, omega_n = 2 pi n / beta (matsubara mode), with
weights normalized by max |w| as the reference does.
"""

from __future__ import annotations

import numpy as np


def prune(e, w, tol: float = 1e-6):
    """Sort by energy and trim leading/trailing near-zero weights
    (reference: lorentzian.cpp sort + prune)."""
    e = np.asarray(e, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    order = np.argsort(e)
    e, w = e[order], w[order]
    nz = np.nonzero(np.abs(w) > tol)[0]
    if nz.size == 0:
        return e[:0], w[:0]
    return e[nz[0]:nz[-1] + 1], w[nz[0]:nz[-1] + 1]


def lorentzian_grid(e, w, total: int, mode: str = "real", eps: float = 0.1,
                    beta: float = 0.0, start=None, step=None):
    """Returns (omega, complex G(omega)) arrays, normalized by
    max |w| (reference: lorentzian.cpp:200-211)."""
    e, w = prune(e, w)
    if e.size == 0:
        om = np.zeros(total)
        return om, np.zeros(total, dtype=np.complex128)
    emin, emax = e.min(), e.max()
    wabsmax = np.abs(w).max()
    if mode == "real":
        omega_init = emin if start is None else start
        omega_step = (emax - omega_init) / (total - 1) if step is None \
            else step
        omegas = omega_init + omega_step * np.arange(total)
        z = omegas + 1j * eps
    elif mode == "matsubara":
        if beta <= 0:
            raise ValueError("beta must be positive in matsubara mode")
        half = total // 2
        n = np.arange(total)
        w_n = np.where(n < half, -(half - n), (1 + n) - half)
        omegas = 2.0 * np.pi / beta * w_n
        z = eps + 1j * omegas
    else:
        raise ValueError(f"unknown mode {mode}")
    g = (w[None, :] / (z[:, None] - e[None, :])).sum(axis=1) / wabsmax
    return omegas, g
