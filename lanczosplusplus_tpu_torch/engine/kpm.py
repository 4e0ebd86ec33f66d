"""Kernel polynomial method (KPM) spectral densities.

Counterpart of ``lanczosplusplus_tpu/engine/kpm.py``: ``spectral_bounds``,
``jackson_kernel``, ``_moment_recurrence``, ``KPMResult.density``,
``chebyshev_moments`` (with its ``|mu_k| <= 2 mu_0`` guard),
``kpm_dos`` and ``kpm_spectral``.  KPM (Weisse, Wellein, Alvermann &
Fehske, RMP 78, 275 (2006)) expands

    A_phi(omega) = <phi| delta(omega - (H - E0)) |phi>

in Chebyshev polynomials of the rescaled Hamiltonian: the recurrence
|t_{k+1}> = 2 Ht |t_k> - |t_{k-1}> keeps two vectors and does not
reorthogonalize, and the product rule (mu_{2k} = 2<t_k|t_k> - mu_0,
mu_{2k+1} = 2<t_{k+1}|t_k> - mu_1) gives two moments a matvec.  The
reference computes dynamic correlations only as continued fractions
(Engine.h:460-490).

The JAX package runs the recurrence as a ``lax.scan``.  Here it is a
Python loop over a batch-major (R, dim) block on the Hamiltonian's
device, one ``apply_block_t`` (the batched kernels) a moment pair; the
moments stay on the device and come to the host once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of
from lanczosplusplus_tpu_torch.core.sparse import apply_block_t
from lanczosplusplus_tpu_torch.solver import lanczos as lz


def spectral_bounds(ham, steps: int = 64, seed: int = 271828,
                    margin: float = 0.05):
    """(emin, emax) safely enclosing spec(H): extremal Ritz values of a
    short plain Lanczos run from a start vector drawn on the Hamiltonian's
    device, padded by `margin` of the spread."""
    steps = int(min(steps, ham.dim))
    v0 = lz.random_start_vector(ham.dim, seed, ham.dtype, ham.device)
    res = lz.tridiagonalize_plain(ham, v0, steps)
    evals, _ = lz.tridiag_eigh(res.alphas, res.betas)
    lo, hi = float(evals[0]), float(evals[-1])
    pad = margin * max(hi - lo, 1.0)
    return lo - pad, hi + pad


def jackson_kernel(n: int) -> np.ndarray:
    """Jackson damping g_k, the optimal positive kernel (RMP 78, 275,
    eq. 71): resolution ~ pi/n in the rescaled variable."""
    k = np.arange(n)
    q = np.pi / (n + 1)
    return ((n - k + 1) * np.cos(q * k) +
            np.sin(q * k) / np.tan(q)) / (n + 1)


def _moment_recurrence(ham, phi0: torch.Tensor, a: float, b: float,
                       num_pairs: int) -> torch.Tensor:
    """Chebyshev moments of the batch-major block phi0 (R, dim) for the
    rescaled Ht = (H - b)/a, by the product rule: a (num_pairs, 2, R)
    tensor on phi0's device, [k, 0] = mu_{2k} and [k, 1] = mu_{2k+1}.
    One ``apply_block_t`` a moment pair; nothing is read to the host.  On
    a row-sharded form phi0 holds this rank's rows and the dots sum over
    the ranks."""
    mesh = lz._mesh(ham)

    def ht(x):
        return apply_block_t(ham, x).sub_(x, alpha=b).mul_(1.0 / a)

    def dot(u, v):
        return lz._allsum(torch.linalg.vecdot(u, v), mesh).real

    out = torch.empty((num_pairs, 2, phi0.shape[0]),
                      dtype=real_dtype_of(phi0.dtype), device=phi0.device)
    tk, tk1 = phi0, ht(phi0)           # T_0 |phi>, T_1 |phi>
    mu0 = dot(tk, tk)
    mu1 = dot(tk, tk1)
    for k in range(num_pairs):
        out[k, 0] = 2.0 * dot(tk, tk) - mu0
        out[k, 1] = 2.0 * dot(tk1, tk) - mu1
        if k + 1 < num_pairs:
            tk, tk1 = tk1, ht(tk1).mul_(2.0).sub_(tk)
    return out


@dataclasses.dataclass
class KPMResult:
    moments: np.ndarray     # (N,) kernel-free moments, summed over R
    a: float                # scale: H = a*Ht + b
    b: float
    num_moments: int

    def density(self, energies, kernel: Optional[np.ndarray] = None):
        """rho(E) = [g_0 mu_0 + 2 sum_{k>=1} g_k mu_k T_k(x)]
        / (pi sqrt(1-x^2) a) with x = (E-b)/a, normalized so that
        integral dE rho(E) = mu_0."""
        g = jackson_kernel(self.num_moments) if kernel is None else kernel
        x = (np.asarray(energies, dtype=np.float64) - self.b) / self.a
        inside = np.abs(x) < 1.0            # zero outside spec(Ht)
        x = np.clip(x, -1.0 + 1e-12, 1.0 - 1e-12)
        theta = np.arccos(x)
        acc = g[0] * self.moments[0] * np.ones_like(x)
        for k in range(1, self.num_moments):
            acc = acc + 2.0 * g[k] * self.moments[k] * np.cos(k * theta)
        return np.where(inside,
                        acc / (np.pi * np.sqrt(1.0 - x * x) * self.a),
                        0.0)


def chebyshev_moments(ham, phi, num_moments: int,
                      bounds=None) -> KPMResult:
    """Kernel-free moments mu_k = <phi|T_k(Ht)|phi>, k < num_moments.

    phi (array or tensor) may be (dim,) or (dim, R); it runs on the
    Hamiltonian's device in the form's type (float32 for a float32 form),
    and the moments are summed on the host in float64 over the block
    columns (the stochastic-trace / multi-operator accumulation).  Moments
    past the |T_k| <= 1 bound raise: the bounds do not enclose the
    spectrum."""
    if bounds is None:
        bounds = spectral_bounds(ham)
    emin, emax = bounds
    a = 0.5 * (emax - emin)
    b = 0.5 * (emax + emin)
    phi = torch.as_tensor(phi, device=ham.device).to(ham.dtype)
    phi2 = phi[None, :] if phi.ndim == 1 else phi.T   # batch-major (R, dim)
    num_pairs = (num_moments + 1) // 2
    pairs = _moment_recurrence(ham, phi2.contiguous(), a, b, num_pairs)
    pairs = pairs.cpu().numpy().astype(np.float64).sum(axis=2)
    mu = pairs.reshape(-1)                 # mu_0, mu_1, mu_2, ...
    # |T_k| <= 1 on [-1, 1], so |mu_k| <= mu_0 whenever the bounds
    # enclose the spectrum; outside, T_k grows like cosh(k acosh|x|)
    # and the density is silently garbage: fail loudly instead
    if not np.isfinite(mu).all() or \
            np.abs(mu).max() > 2.0 * abs(mu[0]) + 1e-9:
        raise ValueError(
            "Chebyshev moments exceed the |T_k|<=1 bound: the spectral "
            "bounds do not enclose spec(H) — widen `bounds` or raise "
            "the spectral_bounds margin/steps")
    return KPMResult(moments=mu[:num_moments], a=a, b=b,
                     num_moments=num_moments)


def kpm_dos(ham, num_moments: int = 256, num_vectors: int = 16,
            seed: int = 314159, bounds=None,
            start_vectors=None) -> KPMResult:
    """Total density of states Tr[delta(E - H)] by stochastic trace:
    moments averaged over R random vectors (drawn on the Hamiltonian's
    device, or `start_vectors` (dim, R) in flat order), scaled by dim."""
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # the trace is basis-independent: run in the inner (block) order
        # and skip the flat wrap's whole-dim gathers every step
        if start_vectors is not None:
            start_vectors = ham.to_inner(torch.as_tensor(
                start_vectors, device=ham.device).T).T
        ham = ham.inner
    if start_vectors is None:
        start_vectors = lz.random_start_block(ham.dim, num_vectors, seed,
                                              ham.dtype, ham.device)
    num_vectors = start_vectors.shape[1]
    res = chebyshev_moments(ham, start_vectors, num_moments, bounds=bounds)
    res.moments *= ham.dim / num_vectors
    return res


def kpm_spectral(ham_dst, phi, omegas, e0: float,
                 num_moments: int = 512, bounds=None,
                 weight: Optional[float] = None):
    """A(omega) = <phi| delta(omega - (H_dst - e0)) |phi> on the omega
    grid, the KPM counterpart of the continued-fraction spectral function
    (Engine.h:460-490): phi = op|gs> lives in the destination sector,
    omega is measured from the ground-state energy e0 of the source
    sector."""
    res = chebyshev_moments(ham_dst, phi, num_moments, bounds=bounds)
    if weight is not None and res.moments[0] > 0:
        res.moments = res.moments * (weight / res.moments[0])
    return res.density(np.asarray(omegas, dtype=np.float64) + e0)
