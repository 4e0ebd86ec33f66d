"""The reference's answers, from a sector's ``apply`` alone, in float64.

``lowest_energy``: plain Lanczos (three-term, no reorthogonalization) from
a start vector of the reference's own seed, until the lowest eigenvalue of
the tridiagonal stops moving.  That eigenvalue decreases with every step
and stays an accurate eigenvalue however orthogonality is lost (Paige), so
no basis is stored.

``pair_gap``: how far a (value, vector) pair is from the ground state:
the larger of its value's distance from E0 and its residual
|H v - value v|, both over |E0|.

``ftlm``: the finite-temperature Lanczos estimate (Jaklic and Prelovsek,
PRB 49, 5065 (1994)) of <H>(beta) and ln Z(beta) from a given start block:
plain Lanczos on each row, each tridiagonal cut where its beta vanishes,
then ln Z = ln(dim / R) + logsumexp over rows r and Ritz pairs j of
(-beta eps_rj + ln u_rj^2), with u_rj the first component of the j-th
eigenvector.
"""

from __future__ import annotations

import numpy as np
import torch

# the tridiagonal is cut at the first beta below this share of its scale
BREAKDOWN = 1e-12


def _tridiagonal(alphas, betas) -> np.ndarray:
    m = len(alphas)
    t = np.diag(np.asarray(alphas, dtype=np.float64))
    off = np.asarray(betas[:m - 1], dtype=np.float64)
    return t + np.diag(off, 1) + np.diag(off, -1)


def _start(dim: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(dim, generator=gen, dtype=torch.float64, device=device)
    return v / torch.linalg.vector_norm(v)


def lowest_energy(sector, seed: int = 20260, max_steps: int = 600,
                  every: int = 10, settled: float = 1e-14) -> float:
    """E0 of `sector`: the lowest Ritz value of plain Lanczos, checked every
    `every` steps, once two checks in a row move it by less than `settled`
    of its size (or the Krylov space is exhausted).  Raises if it has not
    settled after `max_steps`."""
    v = _start(sector.dim, seed, sector.diag.device)
    v_prev = torch.zeros_like(v)
    alphas, betas = [], []
    beta = 0.0
    history = []
    for step in range(1, min(max_steps, sector.dim) + 1):
        w = sector.apply(v[None])[0]
        alpha = float(torch.dot(v, w))
        w -= alpha * v + beta * v_prev
        beta = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        betas.append(beta)
        scale = max(max(abs(a) for a in alphas), max(betas), 1.0)
        done = beta <= BREAKDOWN * scale or step == sector.dim
        if step % every == 0 or done:
            e0 = float(np.linalg.eigvalsh(_tridiagonal(alphas, betas))[0])
            history.append(e0)
            if done or (len(history) >= 3 and all(
                    abs(history[-k] - history[-k - 1]) <= settled * abs(e0)
                    for k in (1, 2))):
                return e0
        v_prev, v = v, w / beta
    raise RuntimeError(f"reference Lanczos unsettled after {max_steps} "
                       f"steps: last lowest Ritz values {history[-3:]}")


def pair_gap(sector, value: float, vector: torch.Tensor, e0: float) -> float:
    """max(|value - E0|, |H v - value v|) / |E0| for the unit vector along
    `vector`, taken in float64."""
    v = vector.to(torch.float64).reshape(1, -1)
    v = v / torch.linalg.vector_norm(v)
    r = sector.apply(v) - value * v
    return max(abs(value - e0), float(torch.linalg.vector_norm(r))) / abs(e0)


def ftlm(sector, block: torch.Tensor, beta_grid, steps: int):
    """(<H>(beta), ln Z(beta)) as float64 arrays, from the unit rows of
    `block` (R, dim) and `steps` Lanczos steps each."""
    v = block.to(torch.float64)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    rows, dim = v.shape
    v_prev = torch.zeros_like(v)
    b_prev = torch.zeros((rows, 1), dtype=torch.float64, device=v.device)
    alphas, betas = [], []
    for _ in range(min(steps, dim)):
        w = sector.apply(v)
        a = (v * w).sum(dim=1, keepdim=True)
        w = w - a * v - b_prev * v_prev
        b = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        alphas.append(a[:, 0])
        betas.append(b[:, 0])
        v_prev, v = v, torch.where(b > 0, w / torch.where(b > 0, b, 1.0),
                                   0.0)
        b_prev = b
    alphas = torch.stack(alphas).cpu().numpy()      # (M, R)
    betas = torch.stack(betas).cpu().numpy()
    scale = max(np.abs(alphas).max(), np.abs(betas).max(), 1.0)
    eps, logw = [], []
    for r in range(rows):
        cut = np.nonzero(betas[:-1, r] <= BREAKDOWN * scale)[0]
        m = int(cut[0]) + 1 if cut.size else alphas.shape[0]
        values, vectors = np.linalg.eigh(_tridiagonal(alphas[:m, r],
                                                      betas[:m, r]))
        weight = vectors[0] ** 2
        keep = weight > 0
        eps.append(values[keep])
        logw.append(np.log(weight[keep]))
    eps = np.concatenate(eps)
    logw = np.concatenate(logw)
    energy, log_z = [], []
    for beta in np.asarray(beta_grid, dtype=np.float64):
        x = logw - beta * eps
        top = x.max()
        p = np.exp(x - top)
        log_z.append(top + np.log(p.sum()) + np.log(dim / rows))
        energy.append(float((p * eps).sum() / p.sum()))
    return np.array(energy), np.array(log_z)
