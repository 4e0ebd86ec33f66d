"""Real-time evolution by Chebyshev expansion of the propagator.

Counterpart of ``lanczosplusplus_tpu/engine/chebyshev_time.py``
(``evolve``, ``autocorrelation``).  The reference has no real-time
propagation (its dynamics are frequency-domain continued fractions,
Engine.h:460-490 + scripts/dynamicsFt.pl):

    e^{-iHt} = e^{-ibt} [ J_0(at) + 2 sum_{k>=1} (-i)^k J_k(at)
                          T_k((H - b)/a) ]

(Tal-Ezer & Kosloff, J. Chem. Phys. 81, 3967 (1984)).  The Bessel
coefficients J_k(at) decay super-exponentially once k > at, so the series
truncates sharply.  The work on the device is the KPM module's
two-vector Chebyshev recurrence, one matvec a term, with the (K, nt)
coefficient table (made on the host with scipy) folded into the (nt, dim)
accumulator one term at a time; the JAX package runs it as a
``lax.scan``.  For a real H and a real psi0 the recurrence stays real and
only the accumulator is complex.
"""

from __future__ import annotations

import numpy as np
import scipy.special
import torch

from lanczosplusplus_tpu_torch.engine.kpm import spectral_bounds


def _evolve_recurrence(ham, psi0: torch.Tensor, a: float, b: float,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """acc[t] = sum_k coeffs[k, t] T_k(Ht) psi0, on psi0's device."""
    def ht(x):
        return ham.matvec(x).sub_(x, alpha=b).mul_(1.0 / a)

    t0, t1 = psi0, ht(psi0)
    acc = torch.outer(coeffs[0], t0.to(coeffs.dtype))
    acc.addr_(coeffs[1], t1.to(coeffs.dtype))
    for ck in coeffs[2:]:
        t0, t1 = t1, ht(t1).mul_(2.0).sub_(t0)
        acc.addr_(ck, t1.to(coeffs.dtype))
    return acc


def evolve(ham, psi0, times, bounds=None, extra_terms: int = 40):
    """psi(t) = e^{-iHt} psi0 for each t in `times`, on the Hamiltonian's
    device.

    Returns a (len(times), dim) complex numpy array.  The expansion order
    is ceil(1.1 * a * max|t|) + extra_terms (Bessel tail cutoff)."""
    times = np.asarray(times, dtype=np.float64)
    if bounds is None:
        bounds = spectral_bounds(ham)
    emin, emax = bounds
    a = 0.5 * (emax - emin)
    b = 0.5 * (emax + emin)
    at = a * np.abs(times).max()
    # the recurrence needs T_0 and T_1 unconditionally
    K = max(int(np.ceil(1.1 * at)) + int(extra_terms), 2)
    k = np.arange(K)
    bessel = scipy.special.jv(k[:, None], a * times[None, :])  # (K, nt)
    phase = np.exp(-1j * b * times)[None, :]
    pref = np.where(k == 0, 1.0, 2.0)[:, None] * (-1j) ** k[:, None]
    coeffs = (pref * bessel * phase).astype(np.complex128)
    psi0 = torch.as_tensor(psi0, device=ham.device)
    cdt = torch.complex64 if psi0.dtype in (torch.float32, torch.complex64) \
        else torch.complex128
    acc = _evolve_recurrence(ham, psi0, a, b,
                             torch.as_tensor(coeffs, device=ham.device)
                             .to(cdt))
    return acc.cpu().numpy()


def autocorrelation(ham, psi0, times, bounds=None, extra_terms=40):
    """C(t) = <psi0 | e^{-iHt} | psi0>: the survival amplitude, whose
    Fourier transform is the spectral function of |psi0>."""
    psi_t = evolve(ham, psi0, times, bounds=bounds,
                   extra_terms=extra_terms)
    return psi_t @ np.conj(np.asarray(torch.as_tensor(psi0).cpu()))
