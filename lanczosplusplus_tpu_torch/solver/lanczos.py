"""Lanczos ground states with selective or full reorthogonalization.

Counterpart of ``lanczosplusplus_tpu/solver/lanczos.py``: ``lowest_states``
(dense fallback, convergence check, step doubling, restarts),
``tridiagonalize`` with ``reorth="selective"`` and ``"full"``,
``tridiagonalize_plain``, ``tridiagonalize_plain_batched``,
``lowest_states_plain``, ``trim_at_breakdown``, ``tridiag_eigh``,
``finish_lanczos``, ``ritz_vectors``, ``_dense_solve`` and ``SolveInfo``.
Every entry point takes any operator with ``dim``, ``dtype``, ``device``
and ``matvec`` (``matmat_t`` for the batched recurrence): a sector
``Hamiltonian`` or a block-Kronecker form.  ``lowest_states`` solves a
``PermutedHamiltonian`` in its inner block order.
It replaces PsimagLite::LanczosSolver as the reference uses it
(reference: src/Engine/Engine.h:601-657).

The JAX package runs the recurrence as a ``lax.scan`` with ``lax.cond``
branches.  Here it is a Python loop over tensors on the Hamiltonian's
device: each step reads alpha and the norms back to the host, where the
omega recurrence of selective reorthogonalization runs in float64.  The
Krylov basis V is a (steps, dim) tensor; Gram-Schmidt passes run against
its filled rows only.  Vectors are updated in place where that saves a
dim-sized allocation.

torch cannot reproduce ``jax.random``'s stream, so every entry point
takes a caller-supplied start vector `v0`; without one, the start comes
from a ``torch.Generator`` on the Hamiltonian's device seeded with
`seed`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of

CPU_KRYLOV_BUDGET_BYTES = 6 << 30


def default_krylov_budget(device: torch.device) -> int:
    """Bytes the stored Krylov basis may take: half of the card's free
    memory on CUDA, 6 GiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return CPU_KRYLOV_BUDGET_BYTES


def random_start_vector(dim: int, seed: int, dtype: torch.dtype,
                        device) -> torch.Tensor:
    """Unit-norm normal start vector from a ``torch.Generator`` on
    `device` seeded with `seed` (reference: Engine.h:620-621 fills it from
    PsimagLite::Random48).  Complex dtypes draw the real parts first,
    then the imaginary parts."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rdt = real_dtype_of(dtype)
    v = torch.randn(dim, generator=gen, dtype=rdt, device=device)
    if dtype.is_complex:
        v = torch.complex(v, torch.randn(dim, generator=gen, dtype=rdt,
                                         device=device))
    return v / torch.linalg.vector_norm(v)


def _normalized(ham, v0) -> torch.Tensor:
    """v0 (array or tensor) as a unit vector of the Hamiltonian's dtype on
    its device."""
    v0 = torch.as_tensor(v0, device=ham.device).to(ham.dtype)
    return v0 / torch.linalg.vector_norm(v0)


def _start_vector(ham, v0, seed: int) -> torch.Tensor:
    if v0 is None:
        return random_start_vector(ham.dim, seed, ham.dtype, ham.device)
    return _normalized(ham, v0)


def _norm(w: torch.Tensor) -> float:
    return torch.linalg.vector_norm(w).item()


def _alpha(v: torch.Tensor, w: torch.Tensor) -> float:
    return torch.vdot(v, w).real.item()


def _reorth_pass(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One classical Gram-Schmidt pass of w against the rows of V."""
    coeffs = V.conj() @ w
    return w - coeffs @ V


def _reorth(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DGKS: one pass, and a second one only when the first collapsed the
    norm (eta = 1/sqrt(2)), which is when classical Gram-Schmidt loses
    orthogonality."""
    n0 = _norm(w)
    w = _reorth_pass(V, w)
    if _norm(w) < 0.7071 * n0:
        w = _reorth_pass(V, w)
    return w


def _next_vector(w: torch.Tensor, beta: float) -> torch.Tensor:
    return w.div_(beta) if beta > 0 else torch.zeros_like(w)


def _run_full(ham, v: torch.Tensor, V: torch.Tensor):
    """Lanczos with Gram-Schmidt against the whole basis every step (the
    reference's policy)."""
    alphas, betas = [], []
    for j in range(V.shape[0]):
        V[j] = v
        w = ham.matvec(v)
        alphas.append(_alpha(v, w))
        w = _reorth(V[:j + 1], w)
        betas.append(_norm(w))
        v = _next_vector(w, betas[-1])
    return alphas, betas


def _run_selective(ham, v: torch.Tensor, V: torch.Tensor):
    """Lanczos with selective reorthogonalization (Simon's omega
    recurrence).  omega[i] estimates <v_k, v_i> from the three-term
    coefficients alone; only when max|omega| crosses eps^(2/3) does the
    step pay the Gram-Schmidt passes, and the following step too, after
    which the estimates reset to the noise floor (Simon 1984)."""
    steps = V.shape[0]
    eps = torch.finfo(real_dtype_of(v.dtype)).eps
    eta = eps ** (2.0 / 3.0)      # trigger threshold
    eps1 = 10.0 * eps             # per-step noise floor of the estimate
    idx = np.arange(steps)
    omega = np.zeros(steps)
    omega_prev = np.zeros(steps)
    a_hist = np.zeros(steps)
    b_hist = np.zeros(steps)
    v_prev = torch.zeros_like(v)
    beta_prev = 0.0
    force = False
    alphas, betas = [], []
    for j in range(steps):
        V[j] = v
        w = ham.matvec(v)
        alpha = _alpha(v, w)
        w.sub_(v, alpha=alpha).sub_(v_prev, alpha=beta_prev)
        a_hist[j] = alpha
        beta0 = _norm(w)

        # beta_k omega_{k+1,i} = b_i omega_{k,i+1} + (a_i - a_k) omega_{k,i}
        #   + b_{i-1} omega_{k,i-1} - b_{k-1} omega_{k-1,i}
        omega_k = omega.copy()
        omega_k[j] = 1.0
        om_plus = np.append(omega_k[1:], 0.0)
        om_minus = np.insert(omega_k[:-1], 0, 0.0)
        b_minus = np.insert(b_hist[:-1], 0, 0.0)
        num = (b_hist * om_plus + (a_hist - alpha) * omega_k
               + b_minus * om_minus - beta_prev * omega_prev)
        om_new = num / max(beta0, 1e-30)
        om_new = om_new + np.where(om_new >= 0, eps1, -eps1)
        om_new = np.where(idx < j, om_new, 0.0)
        om_new[j] = eps1

        need = force or np.abs(om_new).max() > eta
        if need:
            w = _reorth(V[:j + 1], w)
            om_new = np.where(idx <= j, eps1, 0.0)
        force = need and not force

        beta = _norm(w)
        b_hist[j] = beta
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, _next_vector(w, beta)
        beta_prev = beta
        omega_prev, omega = omega_k, om_new
    return alphas, betas


@dataclass
class LanczosResult:
    alphas: np.ndarray   # (m,)
    betas: np.ndarray    # (m,)  beta[j] couples step j to j+1
    V: torch.Tensor | None  # (steps, dim) Krylov basis (rows >= m are
    #                         zero); None from the plain recurrences
    m: int               # effective number of steps before breakdown


def tridiagonalize(ham, v0, steps: int, reorth="selective") -> LanczosResult:
    """Run `steps` Lanczos iterations from v0 (normalized here)."""
    if reorth not in ("selective", "full"):
        raise ValueError(f"reorth must be 'selective' or 'full', not "
                         f"{reorth!r}")
    v = _normalized(ham, v0)
    steps = int(min(steps, v.shape[0]))
    V = torch.zeros((steps, v.shape[0]), dtype=v.dtype, device=v.device)
    run = _run_selective if reorth == "selective" else _run_full
    alphas, betas = run(ham, v, V)
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    return LanczosResult(alphas=alphas[:m], betas=betas[:m], V=V, m=m)


def trim_at_breakdown(alphas, betas):
    """(alphas, betas, m): float64 copies of the tridiagonal plus the
    effective step count m before Lanczos breakdown (beta underflowed
    relative to the coefficient scale)."""
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    steps = len(alphas)
    scale = max(np.abs(alphas).max(initial=0.0),
                np.abs(betas).max(initial=0.0), 1.0)
    m = steps
    for j in range(steps - 1):
        if betas[j] <= 1e-12 * scale:
            m = j + 1
            break
    return alphas, betas, m


def tridiag_eigh(alphas: np.ndarray, betas: np.ndarray):
    """Host eigensolve of the Lanczos tridiagonal."""
    if len(alphas) == 1:
        return alphas.copy(), np.ones((1, 1))
    return scipy.linalg.eigh_tridiagonal(alphas, betas[:len(alphas) - 1])


def _combine(V: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """(k, dim) = weights^T (k, m) . V[:m]."""
    m = weights.shape[0]
    w = torch.as_tensor(weights, device=V.device).to(V.dtype)
    return w.T @ V[:m]


def ritz_vectors(res: LanczosResult, weights: np.ndarray) -> torch.Tensor:
    """Columns of weights (m, k) combined over the Krylov basis."""
    return _combine(res.V, weights)


def finish_lanczos(alphas, betas, V: torch.Tensor, num_states: int):
    """Trim the tridiagonal at breakdown, eigensolve it on the host and
    assemble `num_states` normalized Ritz vectors from the stored basis V
    (steps, dim).  Returns (evals[:k], vecs (k, dim))."""
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    evals, evecs = tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = _combine(V, evecs[:, :k])
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    return evals[:k], vecs


def _plain_pass(ham, v0: torch.Tensor, steps: int, weights=None):
    """Three-term recurrence with two stored vectors.  Without weights it
    returns (alphas, betas); with weights it replays the recurrence and
    returns sum_j weights[j] v_j."""
    v, v_prev, beta_prev = v0.clone(), torch.zeros_like(v0), 0.0
    alphas, betas = [], []
    acc = None if weights is None else torch.zeros_like(v0)
    for j in range(steps):
        if acc is not None:
            acc.add_(v, alpha=float(weights[j]))
        w = ham.matvec(v)
        alpha = _alpha(v, w)
        w.sub_(v, alpha=alpha).sub_(v_prev, alpha=beta_prev)
        beta = _norm(w)
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, _next_vector(w, beta)
        beta_prev = beta
    return (alphas, betas) if acc is None else acc


def tridiagonalize_plain(ham, v0, steps: int) -> LanczosResult:
    """(alphas, betas) from the three-term recurrence with two stored
    vectors: enough for a continued fraction, which never needs the
    Krylov basis."""
    v = _normalized(ham, v0)
    steps = int(min(steps, v.shape[0]))
    alphas, betas, m = trim_at_breakdown(*_plain_pass(ham, v, steps))
    return LanczosResult(alphas=alphas[:m], betas=betas[:m], V=None, m=m)


def tridiagonalize_plain_batched(ham, v0s, steps: int) -> list[LanczosResult]:
    """R tridiagonalizations sharing one sector Hamiltonian as one batched
    recurrence over the rows of `v0s` (R, dim), unit-norm rows: the shape
    of a continued-fraction fleet, where all site pairs and operator types
    of a spectral run that land in one sector run together (reference:
    Engine.h:460-490 runs each decomposition serially).

    Every step is one ``apply_block_t`` (the batched kernels) plus
    row-wise dots and updates; alpha and beta of all rows come back to the
    host in one read per step.  A row whose recurrence breaks down
    (beta = 0) carries zeros onward, so its trailing coefficients are
    zero; when every row has, the remaining steps are not run.  Returns R
    ``LanczosResult`` (V None), each trimmed at its own breakdown."""
    from lanczosplusplus_tpu_torch.core.sparse import apply_block_t

    V = torch.as_tensor(v0s, device=ham.device).to(ham.dtype).contiguous()
    rows, dim = V.shape
    steps = int(min(steps, dim))
    V_prev = torch.zeros_like(V)
    beta_prev = torch.zeros((rows, 1), dtype=real_dtype_of(V.dtype),
                            device=V.device)
    coeffs = np.zeros((steps, 2, rows))   # [step, alpha or beta, row]
    for j in range(steps):
        W = apply_block_t(ham, V)
        alpha = torch.linalg.vecdot(V, W, dim=1).real[:, None]
        W.addcmul_(V, alpha.to(W.dtype), value=-1)
        W.addcmul_(V_prev, beta_prev.to(W.dtype), value=-1)
        beta = torch.linalg.vector_norm(W, dim=1, keepdim=True)
        coeffs[j] = torch.cat([alpha, beta], dim=1).T.cpu().numpy()
        alive = coeffs[j, 1] > 0
        if not alive.any():
            break
        if alive.all():
            W.div_(beta.to(W.dtype))
        else:
            keep = torch.as_tensor(alive, device=W.device)[:, None]
            W = torch.where(keep, W / torch.where(keep, beta, 1.0), 0.0)
        V_prev, V, beta_prev = V, W, beta
    out = []
    for r in range(rows):
        a, b, m = trim_at_breakdown(coeffs[:, 0, r], coeffs[:, 1, r])
        out.append(LanczosResult(alphas=a[:m], betas=b[:m], V=None, m=m))
    return out


def lowest_states_plain(ham, num_states: int = 1, seed: int = 7239443,
                        max_steps: int = 300, v0=None):
    """Ground/low states via plain two-pass Lanczos: the first pass builds
    (alpha, beta) with two stored vectors, the host eigensolves, the
    second pass replays the recurrence to accumulate the Ritz vectors.
    No reorthogonalization: ghosts appear as orthogonality decays, but
    extremal eigenvalues converge regardless."""
    v0 = _start_vector(ham, v0, seed)
    steps = int(min(ham.dim, max_steps))
    alphas, betas = _plain_pass(ham, v0, steps)
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    evals, evecs = tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = []
    for i in range(k):
        wts = np.zeros(steps)
        wts[:m] = evecs[:, i]
        acc = _plain_pass(ham, v0, steps, weights=wts)
        vecs.append(acc / torch.linalg.vector_norm(acc))
    return evals[:k], torch.stack(vecs)


@dataclass
class SolveInfo:
    """Convergence report of a lowest_states solve (the reference logs
    Lanczos failure and falls back to dense, Engine.h:624-639)."""
    converged: bool
    residual: float          # a-posteriori Ritz residual (relative)
    steps: int               # Lanczos steps actually run
    used_dense_fallback: bool = False
    # why SolverOptions=factored took the flat form (Engine), or None
    factored_fallback: str | None = None


def _dense_solve(ham, num_states: int):
    """Full diagonalization of ``ham.to_dense()`` in float64 (complex128);
    vectors come back on the Hamiltonian's device."""
    dense = ham.to_dense()
    dense = dense.astype(np.complex128 if np.iscomplexobj(dense)
                         else np.float64)
    evals, evecs = np.linalg.eigh(dense)
    k = min(num_states, dense.shape[0])
    vecs = torch.as_tensor(evecs[:, :k].T.copy(), device=ham.device)
    return evals[:k], vecs.to(ham.dtype)


def lowest_states(ham, num_states: int = 1, seed: int = 7239443,
                  max_steps: int = 200, tol: float = 1e-10,
                  krylov_budget_bytes: int | None = None,
                  reorth="selective", return_info: bool = False,
                  dense_fallback_dim: int = 8192,
                  strict: bool = False, v0=None):
    """Lowest `num_states` eigenpairs of a sector Hamiltonian.

    Equivalent to LanczosSolver::computeAllStatesBelow as driven by
    Engine::computeAllStatesBelow (reference: Engine.h:616-626).  Tiny
    sectors (dim <= 64) are diagonalized densely.  Otherwise the steps
    double until the Ritz residual is below `tol`; a step count whose
    Krylov basis would exceed `krylov_budget_bytes` (default: half of
    the card's free memory, or 6 GiB on the CPU) restarts from the
    current Ritz vector instead.  A solve that ends unconverged is
    diagonalized densely when `dim <= dense_fallback_dim` (reference:
    Engine.h:624-639), raised when `strict`, and reported through
    ``SolveInfo.converged`` otherwise.  When even the first basis would
    exceed the budget, the plain two-pass solver takes over.

    Returns (evals, vecs) with vecs a (k, dim) tensor on the Hamiltonian's
    device, or (evals, vecs, SolveInfo) with `return_info=True`.
    """
    def ret(evals, vecs, info):
        return (evals, vecs, info) if return_info else (evals, vecs)

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # PermutedHamiltonian: solve in the inner (block) order, where the
        # matvec needs no whole-dim gathers, and map only the returned
        # eigenvectors (the sign of a twisted form on both sides)
        if v0 is not None:
            v0 = ham.to_inner(torch.as_tensor(v0, device=ham.device))
        evals, vecs, info = lowest_states(
            ham.inner, num_states=num_states, seed=seed,
            max_steps=max_steps, tol=tol,
            krylov_budget_bytes=krylov_budget_bytes, reorth=reorth,
            return_info=True, dense_fallback_dim=dense_fallback_dim,
            strict=strict, v0=v0)
        return ret(evals, ham.to_flat(vecs), info)

    dim = ham.dim
    dtype = ham.dtype
    if krylov_budget_bytes is None:
        krylov_budget_bytes = default_krylov_budget(ham.device)
    if dim <= max(64, num_states + 2):
        evals, vecs = _dense_solve(ham, num_states)
        return ret(evals, vecs, SolveInfo(True, 0.0, 0, True))
    itemsize = dtype.itemsize
    if min(dim, max_steps) * dim * itemsize > krylov_budget_bytes:
        evals, vecs = lowest_states_plain(
            ham, num_states=num_states, seed=seed, max_steps=max_steps,
            v0=v0)
        # the plain path has no stored basis to estimate a residual from
        return ret(evals, vecs, SolveInfo(True, float("nan"),
                                          min(dim, max_steps)))

    v0 = _start_vector(ham, v0, seed)
    steps = int(min(dim, max_steps))
    restarts = 0
    res = None
    while True:
        res = None  # free the previous basis before allocating the next
        res = tridiagonalize(ham, v0, steps, reorth=reorth)
        evals, evecs = tridiag_eigh(res.alphas, res.betas)
        # a-posteriori Ritz residual estimate |beta_m * u[last]|
        k_chk = min(num_states, res.m)
        resid = abs(res.betas[res.m - 1]) * \
            np.abs(evecs[res.m - 1, :k_chk]).max()
        scale = max(np.abs(evals[0]), 1.0)
        converged = bool(res.m < steps or steps >= dim or
                         resid <= tol * scale)
        if converged or steps >= 4 * max_steps:
            break
        # not converged: extend, but never past the Krylov memory
        # budget; at the budget, restart from the current Ritz vector
        # (single-state only)
        if 2 * steps * dim * itemsize > krylov_budget_bytes:
            if num_states > 1 or restarts >= 8:
                break
            restarts += 1
            v0 = ritz_vectors(res, evecs[:, :1])[0]
            continue
        steps = int(min(dim, steps * 2))
    if not converged:
        if dim <= dense_fallback_dim:
            evals, vecs = _dense_solve(ham, num_states)
            return ret(evals, vecs,
                       SolveInfo(True, resid / scale, steps, True))
        if strict:
            raise RuntimeError(
                f"Lanczos failed to converge: relative residual "
                f"{resid / scale:.3e} > tol {tol:.1e} after {steps} "
                f"steps at dim {dim} (> dense_fallback_dim "
                f"{dense_fallback_dim})")
    k = min(num_states, res.m)
    vecs = ritz_vectors(res, evecs[:, :k])
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    return ret(evals[:k], vecs, SolveInfo(converged, resid / scale, steps))
