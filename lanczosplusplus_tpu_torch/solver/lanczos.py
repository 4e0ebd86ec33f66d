"""Lanczos ground states with selective or full reorthogonalization.

Counterpart of ``lanczosplusplus_tpu/solver/lanczos.py``: ``lowest_states``
(dense fallback, convergence check, step doubling, restarts, and the
float64 refinement of a solve below float64, ``_maybe_refine``),
``tridiagonalize`` with ``reorth="selective"`` and ``"full"``, a Krylov
basis stored below the compute type (``reorth_dtype``) and checkpoints
to resume from (``checkpoint``, ``chunk``),
``tridiagonalize_plain``, ``tridiagonalize_plain_batched``,
``lowest_states_plain``, ``trim_at_breakdown``, ``tridiag_eigh``,
``finish_lanczos``, ``ritz_vectors``, ``_dense_solve``, ``SolveInfo``,
``random_start_block`` and ``check_fits`` (the estimators' memory
reckoning against the Krylov budget).
Every entry point takes any operator with ``dim``, ``dtype``, ``device``
and ``matvec`` (``matmat_t`` for the batched recurrence): a sector
``Hamiltonian`` or a block-Kronecker form.  A row-sharded form of
``parallel/`` carries its ``mesh``: its vectors are this rank's rows, and
every dot, norm and Gram-Schmidt coefficient sums its partial sums over
the ranks through the mesh (``_allsum``, ``_allnorm``); without a mesh
none of that runs.  ``lowest_states`` solves a
``PermutedHamiltonian`` in its inner block order.
It replaces PsimagLite::LanczosSolver as the reference uses it
(reference: src/Engine/Engine.h:601-657).

The JAX package runs the recurrence as a ``lax.scan`` with ``lax.cond``
branches.  Here it is a Python loop over tensors on the Hamiltonian's
device: each step reads alpha and the norms back to the host, where the
omega recurrence of selective reorthogonalization runs in float64 (the
JAX package's runs in the state's real type).  The Krylov basis V is a
(steps, dim) tensor; Gram-Schmidt passes run against its filled rows
only.  Vectors are updated in place where that saves a dim-sized
allocation.

Precision.  A float32 or complex64 solve floors its tolerance at 1e-6
and comes back with its energies refined to the float64 bar
(``ops/refine.rqi_refined_energy``, for every form: the float64 matvec
runs on the card, so the JAX package's flop caps, which guard its host
matvec, do not apply).  A ``quantized`` form (its matvec rounds the state
to bfloat16) is reorthogonalized fully, at a tolerance of at least 1e-3,
and refined the same way.

torch cannot reproduce ``jax.random``'s stream, so every entry point
takes a caller-supplied start vector `v0`; without one, the start comes
from a ``torch.Generator`` on the Hamiltonian's device seeded with
`seed`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of

CPU_KRYLOV_BUDGET_BYTES = 6 << 30
# elements of a basis stored below the compute type widened at a time
# (256 MB of float32)
WIDEN_CHUNK_ELEMENTS = 1 << 26


def default_krylov_budget(device: torch.device) -> int:
    """Bytes the stored Krylov basis may take: half of the card's free
    memory on CUDA, 6 GiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return CPU_KRYLOV_BUDGET_BYTES


def check_fits(nbytes: int, what: str, device) -> None:
    """Raise MemoryError when `nbytes` exceed the Krylov budget of
    `device`: the estimators reckon their blocks and stored bases before
    they make them, and never move them to the host."""
    budget = default_krylov_budget(torch.device(device))
    if nbytes > budget:
        raise MemoryError(
            f"{what} need {nbytes / 1e9:.2f} GB on {device}, more than the "
            f"budget of {budget / 1e9:.2f} GB (half of the free memory); "
            f"use fewer vectors or steps, or a smaller sector")


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


def random_start_block(dim: int, num: int, seed: int, dtype: torch.dtype,
                       device) -> torch.Tensor:
    """Deterministic random (dim, num) block with unit-norm columns, from
    a ``torch.Generator`` on `device` seeded with `seed`: the start block
    of the FTLM, LTLM and KPM estimators.  The components are drawn in
    float32 and cast, so an f32 run and an f64 run get the same sample; a
    complex block is two real draws, real parts first.  The block is the
    transpose of a contiguous (num, dim) tensor, the batch-major layout
    the batched recurrences take, so ``.T`` of it costs no copy.  The
    sample differs from ``jax.random``'s: parity tests pass the JAX block
    in."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rdt = real_dtype_of(dtype)

    def draw():
        return torch.randn(num, dim, generator=gen, dtype=torch.float32,
                           device=device).to(rdt)
    v = draw()
    if dtype.is_complex:
        v = torch.complex(v, draw())
    v = v.to(dtype)
    return (v / torch.linalg.vector_norm(v, dim=1, keepdim=True)).T


def _mesh(ham):
    """The mesh of a row-sharded form (``parallel/``), or None."""
    return getattr(ham, "mesh", None)


def _allsum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Partial sums of a sharded dot summed over the mesh's ranks, the same
    bits on every rank; t itself without a mesh."""
    return t if mesh is None else mesh.sum(t)


def _allnorm(t: torch.Tensor, mesh, dim=None, keepdim=False) -> torch.Tensor:
    """``vector_norm`` of a sharded vector (or of the rows of a sharded
    block, `dim`), over all its ranks' rows."""
    if mesh is None:
        return torch.linalg.vector_norm(t, dim=dim, keepdim=keepdim)
    return mesh.norm(t, dim=dim, keepdim=keepdim)


def _normalized(ham, v0) -> torch.Tensor:
    """v0 (array or tensor) as a unit vector of the Hamiltonian's dtype on
    its device (this rank's rows of one, for a sharded form)."""
    v0 = torch.as_tensor(v0, device=ham.device).to(ham.dtype)
    return v0 / _allnorm(v0, _mesh(ham))


def _start_vector(ham, v0, seed: int) -> torch.Tensor:
    if v0 is None:
        return random_start_vector(ham.dim, seed, ham.dtype, ham.device)
    return _normalized(ham, v0)


def _norm(w: torch.Tensor, mesh=None) -> float:
    return _allnorm(w, mesh).item()


def _alpha(v: torch.Tensor, w: torch.Tensor, mesh=None) -> float:
    return _allsum(torch.vdot(v, w), mesh).real.item()


def _column_chunks(V: torch.Tensor):
    """Column slices of V that widen to at most WIDEN_CHUNK_ELEMENTS."""
    step = max(1, WIDEN_CHUNK_ELEMENTS // max(V.shape[0], 1))
    return [slice(c, c + step) for c in range(0, V.shape[1], step)]


def _reorth_pass(V: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """One classical Gram-Schmidt pass of w against the rows of V.

    V may be stored below w's type (bfloat16): the two GEMVs then read
    half the bytes, the dominant traffic of a reorthogonalized step, while
    the coefficients and the result stay in w's type.  As the JAX
    package's ``dot_general(..., preferred_element_type=w.dtype)`` sees
    them, w and then the coefficients are rounded to V's type and the
    products summed in w's; V is widened a column chunk at a time, never
    whole.  With a mesh the coefficients sum over the ranks' rows."""
    if V.dtype == w.dtype:
        coeffs = _allsum(V.conj() @ w, mesh)
        return w - coeffs @ V
    wq = w.to(V.dtype).to(w.dtype)
    coeffs = torch.zeros(V.shape[0], dtype=w.dtype, device=w.device)
    chunks = _column_chunks(V)
    for c in chunks:
        coeffs += V[:, c].to(w.dtype).conj() @ wq[c]
    cq = _allsum(coeffs, mesh).to(V.dtype).to(w.dtype)
    out = w.clone()
    for c in chunks:
        out[c] -= cq @ V[:, c].to(w.dtype)
    return out


def _reorth(V: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """DGKS: one pass, and a second one only when the first collapsed the
    norm (eta = 1/sqrt(2)), which is when classical Gram-Schmidt loses
    orthogonality."""
    n0 = _norm(w, mesh)
    w = _reorth_pass(V, w, mesh)
    if _norm(w, mesh) < 0.7071 * n0:
        w = _reorth_pass(V, w, mesh)
    return w


def _next_vector(w: torch.Tensor, beta: float) -> torch.Tensor:
    return w.div_(beta) if beta > 0 else torch.zeros_like(w)


@dataclass
class _Carry:
    """What the recurrence carries from a step to the next, and from a
    chunk of steps to the next: the current and previous vectors, beta of
    the last step, and for selective reorthogonalization the omega
    estimates, the coefficient histories and whether the next step must
    reorthogonalize (the second of a pair)."""
    v: torch.Tensor
    v_prev: torch.Tensor
    beta_prev: float
    omega: np.ndarray
    omega_prev: np.ndarray
    a_hist: np.ndarray
    b_hist: np.ndarray
    force: bool

    @classmethod
    def start(cls, v0: torch.Tensor, steps: int) -> "_Carry":
        return cls(v0, torch.zeros_like(v0), 0.0,
                   *(np.zeros(steps) for _ in range(4)), False)


def _lanczos_chunk(ham, V: torch.Tensor, carry: _Carry, js: range,
                   selective: bool):
    """Steps `js` (global indices, written into the rows of V) from
    `carry`.  Full reorthogonalization runs Gram-Schmidt against the
    whole basis every step (the reference's policy); selective (Simon's
    omega recurrence) estimates <v_k, v_i> from the three-term
    coefficients alone and pays the passes only when max|omega| crosses
    eps^(2/3), and on the following step, after which the estimates
    reset to the noise floor (Simon 1984).  eps is the larger of the
    basis's and the state's.  Returns (carry, alphas, betas, number of
    steps that reorthogonalized)."""
    steps = V.shape[0]
    eps = max(torch.finfo(V.dtype).eps,
              torch.finfo(real_dtype_of(carry.v.dtype)).eps)
    eta = eps ** (2.0 / 3.0)      # trigger threshold
    eps1 = 10.0 * eps             # per-step noise floor of the estimate
    idx = np.arange(steps)
    c = carry
    mesh = _mesh(ham)
    alphas, betas, reorthed = [], [], 0
    for j in js:
        V[j] = c.v
        w = ham.matvec(c.v)
        alpha = _alpha(c.v, w, mesh)
        alphas.append(alpha)
        if not selective:
            w = _reorth(V[:j + 1], w, mesh)
            betas.append(_norm(w, mesh))
            reorthed += 1
            c.v_prev, c.v = c.v, _next_vector(w, betas[-1])
            continue
        w.sub_(c.v, alpha=alpha).sub_(c.v_prev, alpha=c.beta_prev)
        c.a_hist[j] = alpha
        beta0 = _norm(w, mesh)

        # beta_k omega_{k+1,i} = b_i omega_{k,i+1} + (a_i - a_k) omega_{k,i}
        #   + b_{i-1} omega_{k,i-1} - b_{k-1} omega_{k-1,i}
        omega_k = c.omega.copy()
        omega_k[j] = 1.0
        om_plus = np.append(omega_k[1:], 0.0)
        om_minus = np.insert(omega_k[:-1], 0, 0.0)
        b_minus = np.insert(c.b_hist[:-1], 0, 0.0)
        num = (c.b_hist * om_plus + (c.a_hist - alpha) * omega_k
               + b_minus * om_minus - c.beta_prev * c.omega_prev)
        om_new = num / max(beta0, 1e-30)
        om_new = om_new + np.where(om_new >= 0, eps1, -eps1)
        om_new = np.where(idx < j, om_new, 0.0)
        om_new[j] = eps1

        need = c.force or np.abs(om_new).max() > eta
        if need:
            w = _reorth(V[:j + 1], w, mesh)
            om_new = np.where(idx <= j, eps1, 0.0)
            reorthed += 1
        c.force = need and not c.force

        beta = _norm(w, mesh)
        c.b_hist[j] = beta
        betas.append(beta)
        c.v_prev, c.v = c.v, _next_vector(w, beta)
        c.beta_prev = beta
        c.omega_prev, c.omega = omega_k, om_new
    return c, alphas, betas, reorthed


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bfloat16, which numpy lacks, widened to
    float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _save(path, V, carry: _Carry, alphas, betas, j, steps, mode) -> None:
    """The basis, the coefficients and the carry after step j - 1, under
    the JAX package's keys; the selective recurrence's state under s_*."""
    extra = {}
    if mode == "selective":
        extra = dict(s_vprev=_host(carry.v_prev),
                     s_betaprev=np.asarray(carry.beta_prev),
                     s_omega=carry.omega, s_omegaprev=carry.omega_prev,
                     s_ahist=carry.a_hist, s_bhist=carry.b_hist,
                     s_force=np.asarray(carry.force))
    np.savez(path, V=_host(V), v=_host(carry.v), alphas=np.asarray(alphas),
             betas=np.asarray(betas), next_step=j, steps=steps,
             dim=V.shape[1], mode=mode, **extra)


def _resume(path, V, carry: _Carry, steps, mode):
    """(next step, alphas, betas) from a checkpoint whose steps, dim and
    mode match this run (a checkpoint without a mode is a full run's), V
    and the carry restored in place; (0, [], []) when there is none or it
    does not match."""
    if path is None or not os.path.exists(path):
        return 0, [], []
    data = np.load(path)
    saved_mode = str(data["mode"]) if "mode" in data.files else "full"
    if (int(data["steps"]) != steps or int(data["dim"]) != V.shape[1]
            or saved_mode != mode):
        return 0, [], []
    dev, dtype = V.device, carry.v.dtype
    V.copy_(torch.as_tensor(data["V"], device=dev))
    carry.v = torch.as_tensor(data["v"], device=dev).to(dtype)
    if mode == "selective":
        carry.v_prev = torch.as_tensor(data["s_vprev"], device=dev).to(dtype)
        carry.beta_prev = float(data["s_betaprev"])
        carry.omega, carry.omega_prev, carry.a_hist, carry.b_hist = (
            np.array(data[key], dtype=np.float64)
            for key in ("s_omega", "s_omegaprev", "s_ahist", "s_bhist"))
        carry.force = bool(data["s_force"])
    return (int(data["next_step"]), [float(a) for a in data["alphas"]],
            [float(b) for b in data["betas"]])


def _lanczos_scan(ham, v0: torch.Tensor, steps: int, checkpoint=None,
                  chunk=None, reorth_dtype=None, reorth="selective"):
    """The whole run in chunks of `chunk` steps (all at once without a
    checkpoint; steps // 8 with one), with the basis, the coefficients,
    the current vector and the selective recurrence's state written to
    the ``.npz`` file `checkpoint` after each chunk and read back on a
    restart: the resume capability the reference lacks (SURVEY.md
    section 5).  A checkpoint resumes only a run of the same steps, dim
    and mode; another run starts afresh and overwrites it.  Returns (V,
    alphas, betas, steps that reorthogonalized)."""
    if reorth not in ("selective", "full"):
        raise ValueError(f"reorth must be 'selective' or 'full', not "
                         f"{reorth!r}")
    V = torch.zeros((steps, v0.shape[0]), dtype=reorth_dtype or v0.dtype,
                    device=v0.device)
    carry = _Carry.start(v0, steps)
    j, alphas, betas = _resume(checkpoint, V, carry, steps, reorth)
    chunk = chunk or (steps if checkpoint is None else max(steps // 8, 1))
    nreorth = 0
    while j < steps:
        n = min(chunk, steps - j)
        carry, a, b, re = _lanczos_chunk(ham, V, carry, range(j, j + n),
                                         reorth == "selective")
        alphas.extend(a)
        betas.extend(b)
        nreorth += re
        j += n
        if checkpoint is not None:
            _save(checkpoint, V, carry, alphas, betas, j, steps, reorth)
    return V, alphas, betas, nreorth


@dataclass
class LanczosResult:
    alphas: np.ndarray   # (m,)
    betas: np.ndarray    # (m,)  beta[j] couples step j to j+1
    V: torch.Tensor | None  # (steps, dim) Krylov basis (rows >= m are
    #                         zero); None from the plain recurrences
    m: int               # effective number of steps before breakdown
    dtype: torch.dtype | None = None  # the compute type, where V is
    #                                   stored below it


def tridiagonalize(ham, v0, steps: int, checkpoint=None, chunk=None,
                   reorth_dtype=None, reorth="selective") -> LanczosResult:
    """Run `steps` Lanczos iterations from v0 (normalized here),
    optionally checkpointed and resumable (`checkpoint`, a ``.npz`` path,
    written every `chunk` steps) and optionally with the Krylov basis
    stored below the compute type (`reorth_dtype`, e.g. torch.bfloat16:
    orthogonality degrades to about 1e-3, for throughput runs)."""
    v = _normalized(ham, v0)
    steps = int(min(steps, ham.dim))
    V, alphas, betas, _ = _lanczos_scan(ham, v, steps, checkpoint=checkpoint,
                                        chunk=chunk,
                                        reorth_dtype=reorth_dtype,
                                        reorth=reorth)
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    return LanczosResult(alphas=alphas[:m], betas=betas[:m], V=V, m=m,
                         dtype=v.dtype)


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


def _combine(V: torch.Tensor, weights: np.ndarray,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """(k, dim) = weights^T (k, m) . V[:m], in `dtype` (V's by default);
    a basis stored below it is widened a column chunk at a time."""
    m = weights.shape[0]
    dtype = dtype or V.dtype
    w = torch.as_tensor(weights, device=V.device).to(dtype)
    if V.dtype == dtype:
        return w.T @ V[:m]
    out = torch.empty((w.shape[1], V.shape[1]), dtype=dtype,
                      device=V.device)
    for c in _column_chunks(V[:m]):
        out[:, c] = w.T @ V[:m, c].to(dtype)
    return out


def ritz_vectors(res: LanczosResult, weights: np.ndarray) -> torch.Tensor:
    """Columns of weights (m, k) combined over the Krylov basis, in the
    run's compute type."""
    return _combine(res.V, weights, res.dtype)


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
    mesh = _mesh(ham)
    for j in range(steps):
        if acc is not None:
            acc.add_(v, alpha=float(weights[j]))
        w = ham.matvec(v)
        alpha = _alpha(v, w, mesh)
        w.sub_(v, alpha=alpha).sub_(v_prev, alpha=beta_prev)
        beta = _norm(w, mesh)
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
    steps = int(min(steps, ham.dim))
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
    rows = V.shape[0]
    steps = int(min(steps, ham.dim))
    mesh = _mesh(ham)
    V_prev = torch.zeros_like(V)
    beta_prev = torch.zeros((rows, 1), dtype=real_dtype_of(V.dtype),
                            device=V.device)
    coeffs = np.zeros((steps, 2, rows))   # [step, alpha or beta, row]
    for j in range(steps):
        W = apply_block_t(ham, V)
        alpha = _allsum(torch.linalg.vecdot(V, W, dim=1), mesh).real[:, None]
        W.addcmul_(V, alpha.to(W.dtype), value=-1)
        W.addcmul_(V_prev, beta_prev.to(W.dtype), value=-1)
        beta = _allnorm(W, mesh, dim=1, keepdim=True)
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


LOW_PRECISION = (torch.float32, torch.complex64)


def _maybe_refine(ham, evals, vecs, twin=None):
    """The energies of a solve below float64 (a float32 or complex64
    form, or a quantized one) refined to the float64 bar (reference:
    LanczosDriver.h:29-33) by ``ops/refine.rqi_refined_energy``, one RQI
    a state against `twin` (the float64 operator: by default the form's
    ``f64_twin``); other solves' as they are.  The JAX package routes a
    real flat form to its on-chip df64 RQI and caps the others by the
    flops of its host matvec; here the float64 matvec runs on the form's
    device for every form, so every form takes the full RQI."""
    if ham.dtype not in LOW_PRECISION and not getattr(ham, "quantized",
                                                      False):
        return evals
    from lanczosplusplus_tpu_torch.ops import refine
    twin = refine.f64_twin(ham) if twin is None else twin
    return np.array([refine.rqi_refined_energy(ham, v, twin=twin)
                     for v in vecs])


def lowest_states(ham, num_states: int = 1, seed: int = 7239443,
                  max_steps: int = 200, tol: float = 1e-10,
                  krylov_budget_bytes: int | None = None,
                  reorth="selective", return_info: bool = False,
                  dense_fallback_dim: int = 8192,
                  strict: bool = False, refine=True, v0=None):
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

    A float32 (complex64) form converges to at least 1e-6; a quantized
    one (its matvec rounds the state to bfloat16, which breaks the
    selective omega recurrence's exact three-term assumption) is
    reorthogonalized fully and converges to at least 1e-3.  With `refine`
    the energies of both come back refined to the float64 bar
    (``_maybe_refine``), against the form's tables in float64 or, where
    `refine` is an operator, against it: the float64 form the solved one
    was cast from (whose ``to_dense`` the dense branch then takes too).
    The vectors stay in the form's type.

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
        if hasattr(refine, "inner"):
            refine = refine.inner
        evals, vecs, info = lowest_states(
            ham.inner, num_states=num_states, seed=seed,
            max_steps=max_steps, tol=tol,
            krylov_budget_bytes=krylov_budget_bytes, reorth=reorth,
            return_info=True, dense_fallback_dim=dense_fallback_dim,
            strict=strict, refine=refine, v0=v0)
        return ret(evals, ham.to_flat(vecs), info)

    dim = ham.dim
    dtype = ham.dtype
    if krylov_budget_bytes is None:
        krylov_budget_bytes = default_krylov_budget(ham.device)
    twin = None if isinstance(refine, bool) else refine
    dense_ham = ham if twin is None else twin
    if dim <= max(64, num_states + 2):
        evals, vecs = _dense_solve(dense_ham, num_states)
        return ret(evals, vecs.to(dtype), SolveInfo(True, 0.0, 0, True))
    itemsize = dtype.itemsize
    if min(dim, max_steps) * dim * itemsize > krylov_budget_bytes:
        evals, vecs = lowest_states_plain(
            ham, num_states=num_states, seed=seed, max_steps=max_steps,
            v0=v0)
        if refine is not False:
            evals = _maybe_refine(ham, evals, vecs, twin)
        # the plain path has no stored basis to estimate a residual from
        return ret(evals, vecs, SolveInfo(True, float("nan"),
                                          min(dim, max_steps)))

    v0 = _start_vector(ham, v0, seed)
    steps = int(min(dim, max_steps))
    if dtype in LOW_PRECISION:
        tol = max(tol, 1e-6)
    if getattr(ham, "quantized", False):
        reorth = "full"
        tol = max(tol, 1e-3)
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
            evals, vecs = _dense_solve(dense_ham, num_states)
            return ret(evals, vecs.to(dtype),
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
    evals = evals[:k]
    if refine is not False:
        evals = _maybe_refine(ham, evals, vecs, twin)
    return ret(evals, vecs, SolveInfo(converged, resid / scale, steps))
