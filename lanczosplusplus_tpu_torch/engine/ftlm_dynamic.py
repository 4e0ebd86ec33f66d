"""Finite-temperature dynamic correlations by the FTLM double-Krylov
estimator.

Counterpart of ``lanczosplusplus_tpu/engine/ftlm_dynamic.py``:
``FTLMDynamicRun``, ``FTLMDynamic`` (``poles``, ``evaluate``),
``ftlm_source_runs`` and ``ftlm_dynamic``.  The reference computes
finite-T Lehmann weights of <A(t) B> from the full spectra of every sector
(src/thermal.cpp:94-232 + grandCanonical.pl).  The FTLM estimator (Jaklic
& Prelovsek, Adv. Phys. 49, 1 (2000), eq. 2.15) replaces both with two
Lanczos runs a random vector:

    S_AB(w, b) = (1/Z) sum_n e^{-b E_n} <n|A^+ delta(w - H + E_n) B|n>
       ~= (dim/(R Zt)) sum_r sum_{j,l} e^{-b eps_j}
          <r|psi_j><psi_j|A^+|phi_l><phi_l|B|r> delta(w - et_l + eps_j)

with |psi_j> the Ritz vectors of the run from |r> (source sector) and
|phi_l> those of the run from B|r> (destination sector).

Both runs are stored-V selective ``tridiagonalize`` runs whose bases stay
on the Hamiltonian's device; the operator rows A V1 are one application of
a device operator map to the whole (m, dim) basis, and the cross matrix
G = conj(A V1) V2^T is one product on the device (numpy on the host in
the JAX package).  Only the small (m1, m2) G and the tridiagonal
eigendata reach the host.  The stored bases are reckoned before they are
made: R source runs, or a destination run, that would not fit half of the
device's free memory raise ``MemoryError`` (they are never moved to the
host).

Exactness property used by the tests: with a complete orthonormal start
set and full Krylov depth the estimator equals the exact double Lehmann
sum (the same argument as for the static FTLM trace).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from lanczosplusplus_tpu_torch.solver import lanczos as lz


@dataclasses.dataclass
class FTLMDynamicRun:
    evals1: np.ndarray   # (m1,) source Ritz values
    u0: np.ndarray       # (m1,) <r|psi_j>
    coupling: np.ndarray  # (m1, m2) <psi_j|A^+|phi_l>
    evals2: np.ndarray   # (m2,) destination Ritz values
    w0: np.ndarray       # (m2,) <phi_l|B|r>


@dataclasses.dataclass
class FTLMDynamic:
    runs: List[FTLMDynamicRun]
    e0: float            # min source Ritz value (Boltzmann shift)
    dim: int
    num_vectors: int

    def poles(self, beta: float):
        """(omega_p, weight_p) at inverse temperature beta, normalized
        by the same-estimator partition function Zt."""
        oms, wts = [], []
        z = 0.0
        for run in self.runs:
            bw = np.exp(-beta * (run.evals1 - self.e0))
            z += float((bw * np.abs(run.u0) ** 2).sum())
            w = (bw * run.u0)[:, None] * np.real(
                run.coupling * run.w0[None, :])
            oms.append((run.evals2[None, :] -
                        run.evals1[:, None]).ravel())
            wts.append(w.ravel())
        z = z if z > 0 else 1.0
        return np.concatenate(oms), np.concatenate(wts) / z

    def evaluate(self, beta: float, omegas, delta: float):
        """Lorentzian-broadened S(omega) on a grid (the lorentzian
        driver's convention, reference: src/lorentzian.cpp:86-125)."""
        om, wt = self.poles(beta)
        omegas = np.asarray(omegas, dtype=np.float64)
        return (wt[None, :] * (delta / np.pi) /
                ((omegas[:, None] - om[None, :]) ** 2 + delta ** 2)
                ).sum(axis=1)


def ftlm_source_runs(ham_src, V0, steps: int):
    """Per-column stored-V selective tridiagonalizations of the source
    sector from the (dim, R) start block V0 (array or tensor), their bases
    on the Hamiltonian's device: the dominant cost of ftlm_dynamic, made
    once so callers assembling several operator types (addition and
    removal, every momentum) share it.  Returns [(LanczosResult, evals,
    evecs)], one a column; raises MemoryError when the R bases do not
    fit."""
    V0 = torch.as_tensor(V0, device=ham_src.device).to(ham_src.dtype)
    num = V0.shape[1]
    steps = int(min(steps, ham_src.dim))
    lz.check_fits(num * steps * ham_src.dim * ham_src.dtype.itemsize,
                  f"ftlm_dynamic: {num} source runs of {steps} steps at dim "
                  f"{ham_src.dim}", ham_src.device)
    runs = []
    for r in range(num):
        res1 = lz.tridiagonalize(ham_src, V0[:, r], steps)
        evals1, evecs1 = lz.tridiag_eigh(res1.alphas, res1.betas)
        runs.append((res1, evals1, evecs1))
    return runs


def ftlm_dynamic(ham_src, ham_dst, apply_b, num_vectors: int = 16,
                 steps: int = 100, seed: int = 152917,
                 apply_a=None, start_vectors=None,
                 source_runs=None) -> FTLMDynamic:
    """Build the FTLM double-Krylov pole data for S_AB(omega, beta).

    apply_b maps a batch-major (k, dim_src) tensor on the device to B
    applied to each row, (k, dim_dst), in the destination sector; apply_a
    defaults to apply_b (the diagonal A = B spectral function).
    `start_vectors` (dim_src, R) overrides the random block (a complete
    orthonormal set and steps = dim make the estimator exact).
    `source_runs`: ``ftlm_source_runs`` of the same start block, shared
    across operator types."""
    apply_a = apply_a or apply_b
    dim = ham_src.dim
    steps = int(min(steps, dim))
    device = ham_src.device
    if start_vectors is not None:
        V0 = torch.as_tensor(start_vectors, device=device).to(ham_src.dtype)
    else:
        V0 = lz.random_start_block(dim, num_vectors, seed, ham_src.dtype,
                                   device)
    num_vectors = V0.shape[1]
    steps_dst = int(min(steps, ham_dst.dim))
    if source_runs is None:
        source_runs = ftlm_source_runs(ham_src, V0, steps)
    # the destination basis and the operator rows A V1, one run at a time
    lz.check_fits(2 * steps_dst * ham_dst.dim * ham_dst.dtype.itemsize,
                  f"ftlm_dynamic: a destination run of {steps_dst} steps at "
                  f"dim {ham_dst.dim} and its operator rows", device)
    Y = apply_b(V0.T.contiguous())                     # (R, dim_dst)
    mesh = lz._mesh(ham_dst)
    ynorms = lz._allnorm(Y, mesh, dim=1).cpu().numpy()

    runs = []
    e0 = np.inf
    for r in range(num_vectors):
        res1, evals1, evecs1 = source_runs[r]
        e0 = min(e0, float(evals1[0]))
        ynorm = float(ynorms[r])
        if ynorm < 1e-14:
            # B|r> = 0: no poles, but the run still contributes to the
            # partition-function normalization (dropping it would
            # overcount S by 1/fraction-annihilated)
            runs.append(FTLMDynamicRun(
                evals1=evals1, u0=evecs1[0].copy(),
                coupling=np.zeros((len(evals1), 0)),
                evals2=np.zeros(0), w0=np.zeros(0)))
            continue
        res2 = lz.tridiagonalize(ham_dst, Y[r] / ynorm, steps_dst)
        evals2, evecs2 = lz.tridiag_eigh(res2.alphas, res2.betas)
        # cross coupling <psi_j|A^+|phi_l> = (A V1^T u_j)^+ (V2^T w_l)
        AV1 = apply_a(res1.V[:res1.m])                 # (m1, dim_dst)
        G = lz._allsum(AV1.conj() @ res2.V[:res2.m].T,
                       mesh).cpu().numpy()                     # (m1, m2)
        del AV1, res2
        C = evecs1.T @ G @ evecs2
        runs.append(FTLMDynamicRun(
            evals1=evals1, u0=evecs1[0].copy(), coupling=C,
            evals2=evals2, w0=ynorm * evecs2[0].copy()))
    return FTLMDynamic(runs=runs, e0=float(e0), dim=dim,
                       num_vectors=num_vectors)
