"""Finite-temperature and low-temperature Lanczos methods (FTLM, LTLM).

Counterpart of ``lanczosplusplus_tpu/engine/ftlm.py``:
``_ftlm_recurrence``, ``FTLMResult`` (``free_energy``, ``entropy``),
``ftlm``, ``ltlm``, ``_schedule_grid``, ``_schedule_ham``,
``ftlm_schedule`` and ``ltlm_schedule``.  The reference's thermal
pipeline (src/ed.cpp:22-59, src/Engine/ExactDiag.h:26-92;
src/thermal.cpp) needs the full spectrum of every sector.  FTLM
(Jaklic & Prelovsek, PRB 49, 5065 (1994)) estimates canonical traces
with R random vectors and M Lanczos steps each:

    Tr[e^{-bH} A] ~= (dim/R) sum_r sum_j e^{-b eps_j^r}
                     <r|psi_j^r><psi_j^r|A|r>

With |v_0> = |r>, <r|psi_j> is u_j[0] of the tridiagonal eigenvector and
<psi_j|A|r> = sum_i u_j[i] <v_i|A|r>, so the estimator needs only the
tridiagonals and the dots of every Krylov vector against y_r = A|r>: two
stored vectors a run.

The R vectors run as one batched recurrence over a batch-major (R, dim)
block on the Hamiltonian's device, every step one ``apply_block_t`` (the
batched kernels) plus row-wise dots and updates.  The JAX package runs it
as a ``lax.scan``; here it is a Python loop whose alphas, betas and dots
stay on the device until the loop ends, then come to the host in one
read.  The tridiagonal eigensolves and the Boltzmann sums run on the host
in float64, as in JAX.  The blocks are reckoned against the Krylov budget
(half of the card's free memory) before they are made: R vectors, or an
LTLM run's stored basis, that do not fit raise ``MemoryError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of
from lanczosplusplus_tpu_torch.core.sparse import apply_block_t
from lanczosplusplus_tpu_torch.solver import lanczos as lz

# rows of an operator's image LTLM makes at a time
LTLM_CHUNK_ROWS = 16


def _ftlm_recurrence(ham, V0: torch.Tensor, Yops: torch.Tensor,
                     steps: int):
    """Batched plain Lanczos over the rows of V0 (R, dim), on its device.

    Returns device tensors: per-step (alphas, betas) of shape (M, R) and
    the Krylov dots D[m, o, r] = <v_m | Yops[o, r, :]>, (M, O, R), needed
    for operator estimators.  Yops may be (0, R, dim) when only the
    H-moments are wanted.  A row whose beta is 0 carries zeros onward.
    Nothing is read to the host inside the loop.  On a row-sharded form
    (``parallel/``) V0 and Yops hold this rank's rows, and the dots sum
    over the ranks."""
    mesh = lz._mesh(ham)
    rows = V0.shape[0]
    rdt = real_dtype_of(V0.dtype)
    alphas = torch.empty((steps, rows), dtype=rdt, device=V0.device)
    betas = torch.empty((steps, rows), dtype=rdt, device=V0.device)
    dots = torch.empty((steps, Yops.shape[0], rows), dtype=V0.dtype,
                       device=V0.device)
    V, V_prev = V0, torch.zeros_like(V0)
    beta_prev = torch.zeros((rows, 1), dtype=rdt, device=V0.device)
    for j in range(steps):
        W = apply_block_t(ham, V)
        alpha = lz._allsum(torch.linalg.vecdot(V, W, dim=1),
                           mesh).real[:, None]
        W.addcmul_(V, alpha.to(W.dtype), value=-1)
        W.addcmul_(V_prev, beta_prev.to(W.dtype), value=-1)
        beta = lz._allnorm(W, mesh, dim=1, keepdim=True)
        alphas[j] = alpha[:, 0]
        betas[j] = beta[:, 0]
        dots[j] = lz._allsum(torch.einsum("rd,ord->or", V.conj(), Yops),
                             mesh)
        alive = beta > 0
        W.div_(torch.where(alive, beta, 1.0).to(W.dtype))
        W.mul_(alive.to(W.dtype))
        V_prev, V, beta_prev = V, W, beta
    return alphas, betas, dots


@dataclasses.dataclass
class FTLMResult:
    betas: np.ndarray                 # (T,) inverse temperatures
    energy: np.ndarray                # (T,) <H>
    energy2: np.ndarray               # (T,) <H^2>
    specific_heat: np.ndarray         # (T,) beta^2 (<H^2>-<H>^2)
    log_z: np.ndarray                 # (T,) ln Z (absolute, incl. dim/R)
    observables: Dict[str, np.ndarray]  # name -> (T,) <A>
    e0_estimate: float                # lowest Ritz value seen
    num_vectors: int
    steps: int

    @property
    def free_energy(self) -> np.ndarray:
        """F(T) = -ln Z / beta."""
        return -self.log_z / self.betas

    @property
    def entropy(self) -> np.ndarray:
        """S(T) = beta (<H> - F)  (k_B = 1)."""
        return self.betas * self.energy + self.log_z


def _apply_operator(op, X: torch.Tensor, name: str) -> torch.Tensor:
    """A sector-preserving operator on the batch-major block X (k, dim):
    a (dim,) diagonal (array or tensor), or an object with ``matmat_t``
    (batch-major) or ``matmat`` (columns).  Returns (k, dim)."""
    if hasattr(op, "matmat_t"):
        return op.matmat_t(X)
    if hasattr(op, "matmat"):
        return op.matmat(X.T).T
    diag = torch.as_tensor(op, device=X.device).to(X.dtype)
    if diag.ndim != 1 or diag.shape[0] != X.shape[1]:
        raise ValueError(f"operator {name!r}: expected (dim,) diagonal or "
                         ".matmat object")
    return diag * X


def _projected(op, Vm: torch.Tensor, chunk: int, name: str,
               mesh=None) -> np.ndarray:
    """G[i, j] = <v_i|A|v_j> over the rows of Vm (m, dim), on the host.
    The image of A is made `chunk` rows at a time, so it never holds more
    than `chunk` rows; each chunk's columns of G are (Y_c . Vm^H)^T, which
    reads the basis as its adjoint without a conjugated copy.  With a mesh
    Vm holds this rank's rows and G sums over the ranks."""
    m = Vm.shape[0]
    G = torch.empty((m, m), dtype=Vm.dtype, device=Vm.device)
    for i in range(0, m, chunk):
        Y = _apply_operator(op, Vm[i:i + chunk], name)
        G[:, i:i + chunk] = (Y @ Vm.mH).T
        del Y    # gone before the next chunk's image is made
    return lz._allsum(G, mesh).cpu().numpy()


def start_block(ham, start_vectors, num_vectors: int,
                seed: int) -> torch.Tensor:
    """The batch-major (R, dim) start block of the estimators on the
    Hamiltonian's device: the columns of `start_vectors` (dim, R), or R
    random unit vectors drawn there."""
    if start_vectors is not None:
        V0 = torch.as_tensor(start_vectors, device=ham.device)
        return V0.to(ham.dtype).T.contiguous()
    return lz.random_start_block(ham.dim, num_vectors, seed, ham.dtype,
                                 ham.device).T.contiguous()


def ftlm(ham, beta_grid, num_vectors: int = 32, steps: int = 80,
         operators: Optional[Dict[str, object]] = None,
         seed: int = 982451653,
         start_vectors=None, trace_dim: Optional[int] = None) -> FTLMResult:
    """FTLM thermal averages of H, H^2 and optional static operators.

    `operators` maps a name to either a 1-D diagonal (dim,) or an object
    with ``matmat_t`` / ``matmat`` acting within the same sector (for
    example a sector ``Hamiltonian``).  Operators that change the sector
    are out of scope, matching the reference's thermal pipeline, which
    also rotates sector-preserving matrices only (src/thermal.cpp:94-232).
    `start_vectors` (dim, R), in flat order, replaces the random block: a
    complete orthonormal set makes the estimator exact.
    """
    operators = operators or {}
    if hasattr(ham, "inner") and hasattr(ham, "perm") and all(
            not (hasattr(op, "matmat") or hasattr(op, "matmat_t"))
            for op in operators.values()):
        # PermutedHamiltonian: traces are basis-independent, so the
        # recurrence runs in the inner (block) order, with no whole-dim
        # gathers a step; diagonal operators are permuted (sign^2 = 1
        # cancels in the sandwich) and caller-provided start vectors,
        # given in flat order, converted
        perm = ham.perm
        operators = {k: torch.as_tensor(op, device=perm.device)[perm]
                     for k, op in operators.items()}
        if start_vectors is not None:
            start_vectors = ham.to_inner(torch.as_tensor(
                start_vectors, device=ham.device).to(ham.dtype).T).T
        ham = ham.inner

    dim = ham.dim
    steps = int(min(steps, dim))
    beta_grid = np.asarray(beta_grid, dtype=np.float64)
    names = list(operators.keys())
    rows = num_vectors if start_vectors is None else \
        int(np.shape(start_vectors)[1])
    # the block, the previous one, its image, two temporaries of the
    # apply and one image a operator
    lz.check_fits((5 + len(names)) * rows * dim * ham.dtype.itemsize,
                  f"ftlm: the blocks of {rows} vectors at dim {dim}",
                  ham.device)
    V0 = start_block(ham, start_vectors, num_vectors, seed)
    num_vectors = int(V0.shape[0])

    Yops = torch.stack([_apply_operator(operators[n], V0, n)
                        for n in names]) if names else \
        V0.new_zeros((0, *V0.shape))

    alphas, betas_l, dots = _ftlm_recurrence(ham, V0, Yops, steps)
    del V0, Yops
    alphas = alphas.cpu().numpy().astype(np.float64)   # (M, R)
    betas_l = betas_l.cpu().numpy().astype(np.float64)  # (M, R)
    dots = dots.cpu().numpy()                           # (M, O, R)

    # host: per-vector tridiagonal eigensolve + Boltzmann accumulation
    T = beta_grid.shape[0]
    nops = len(names)
    num_e = np.zeros(T)
    num_e2 = np.zeros(T)
    num_ops = np.zeros((nops, T))
    zsum = np.zeros(T)
    e0 = np.inf
    scale = max(np.abs(alphas).max(initial=0.0),
                np.abs(betas_l).max(initial=0.0), 1.0)
    ritz = []
    for r in range(num_vectors):
        m = steps
        for j in range(steps - 1):
            if betas_l[j, r] <= 1e-12 * scale:
                m = j + 1
                break
        evals, evecs = lz.tridiag_eigh(alphas[:m, r], betas_l[:m, r])
        ritz.append((evals, evecs[0, :].copy(),
                     evecs.T @ dots[:m, :, r] if nops else None))
        e0 = min(e0, evals[0])
    for evals, u0, projected in ritz:
        for t, b in enumerate(beta_grid):
            w = np.exp(-b * (evals - e0))
            zsum[t] += float((u0 * u0 * w).sum())
            num_e[t] += float((u0 * u0 * w * evals).sum())
            num_e2[t] += float((u0 * u0 * w * evals ** 2).sum())
            for o in range(nops):
                # <r|psi_j><psi_j|A|r> = u0_j * (U^T D)_j,o  (real tridiag)
                num_ops[o, t] += float(
                    np.real(u0 * projected[:, o]) @ w)
    energy = num_e / zsum
    energy2 = num_e2 / zsum
    cv = beta_grid ** 2 * (energy2 - energy ** 2)
    # trace_dim: the true Hilbert dimension when ham is padded (padded
    # rows are excluded by zeroed start vectors but must not inflate the
    # trace normalization)
    log_z = (np.log(zsum) + np.log((trace_dim or dim) / num_vectors)
             - beta_grid * e0)
    obs = {names[o]: num_ops[o] / zsum for o in range(nops)}
    return FTLMResult(betas=beta_grid, energy=energy, energy2=energy2,
                      specific_heat=cv, log_z=log_z, observables=obs,
                      e0_estimate=float(e0), num_vectors=num_vectors,
                      steps=steps)


def ltlm_bytes(dim: int, steps: int, rows: int, dtype: torch.dtype) -> int:
    """Device bytes ``ltlm`` reckons for `rows` start vectors and `steps`
    steps: a run's stored basis, the start block, one chunk of an
    operator's image and the run's four work vectors."""
    chunk = min(LTLM_CHUNK_ROWS, steps)
    return (steps + rows + chunk + 4) * dim * dtype.itemsize


def ltlm(ham, beta_grid, operators: Dict[str, object],
         num_vectors: int = 16, steps: int = 80,
         seed: int = 982451653, start_vectors=None,
         trace_dim: Optional[int] = None):
    """Low-temperature Lanczos method (Aichhorn, Daghofer, Evertz & von der
    Linden, PRB 67, 161103(R) (2003)): the symmetric estimator

        <A>(b) ~= sum_r sum_{j,l} e^{-b(eps_j+eps_l)/2}
                  <r|psi_j><psi_j|A|psi_l><psi_l|r>  /  Z

    which converges to <gs|A|gs> as beta -> inf for every start vector,
    where the FTLM observable estimator leaves O(1/sqrt(R)) noise.  One
    stored-V selective Lanczos run a vector on the Hamiltonian's device,
    plus one (m, dim) x (dim, m) product an operator, its image made
    ``LTLM_CHUNK_ROWS`` rows at a time.  A run's basis and blocks are
    reckoned against the Krylov budget first: a run that does not fit
    raises ``MemoryError`` before anything is made.  Operators: (dim,)
    diagonals or objects with ``matmat_t`` / ``matmat``, sector-preserving.
    Returns {name: (T,) array}, plus '_log_z' for the partition estimate
    and, beyond the JAX package's keys, '_e0' (the lowest Ritz value) and
    '_ritz_residual' (the largest over the runs of the lowest Ritz pair's
    residual norm |beta_m u_m|, which bounds the distance of that Ritz
    value from an eigenvalue)."""
    dim = ham.dim
    steps = int(min(steps, dim))
    beta_grid = np.asarray(beta_grid, dtype=np.float64)
    names = list(operators.keys())
    rows = num_vectors if start_vectors is None else \
        int(np.shape(start_vectors)[1])
    chunk = min(LTLM_CHUNK_ROWS, steps)
    lz.check_fits(ltlm_bytes(dim, steps, rows, ham.dtype),
                  f"ltlm: the basis of {steps} steps and the blocks of "
                  f"{rows} vectors at dim {dim}", ham.device)
    V0 = start_block(ham, start_vectors, num_vectors, seed)
    num_vectors = int(V0.shape[0])

    per_run = []
    e0 = np.inf
    residual = 0.0
    for r in range(num_vectors):
        res = lz.tridiagonalize(ham, V0[r], steps)
        evals, evecs = lz.tridiag_eigh(res.alphas, res.betas)
        e0 = min(e0, float(evals[0]))
        residual = max(residual, abs(res.betas[res.m - 1] * evecs[-1, 0]))
        Vm = res.V[:res.m]                      # (m, dim)
        ritz = {name: evecs.T @ _projected(operators[name], Vm, chunk, name,
                                           lz._mesh(ham))
                @ evecs for name in names}
        per_run.append((evals, evecs[0].copy(), ritz))
        del res, Vm
    T = beta_grid.shape[0]
    out = {name: np.zeros(T) for name in names}
    zs = np.zeros(T)
    for evals, u0, ritz in per_run:
        for t, b in enumerate(beta_grid):
            half = np.exp(-0.5 * b * (evals - e0)) * u0
            zs[t] += float((np.exp(-b * (evals - e0)) * u0 * u0).sum())
            for name in names:
                out[name][t] += float(half @ np.real(ritz[name]) @ half)
    for name in names:
        out[name] = out[name] / zs
    out["_log_z"] = (np.log(zs)
                     + np.log((trace_dim or dim) / num_vectors)
                     - beta_grid * e0)
    out["_e0"] = e0
    out["_ritz_residual"] = residual
    return out


def _schedule_grid(inp):
    """(tbs, beta_grid) from the reference's TemperatureOrBeta* labels
    (ExactDiag.h:31-39)."""
    what = inp.string("TemperatureOrBeta", default="temperature")
    if what not in ("temperature", "beta"):
        raise ValueError("TemperatureOrBeta= must be beta or temperature")
    start = inp.real("TemperatureOrBetaStart", default=0.0)
    total = inp.integer("TemperatureOrBetaTotal", default=0)
    step = inp.real("TemperatureOrBetaStep", default=0.0)
    tbs = [start + i * step for i in range(total)]
    tiny = 1e-12
    if what == "beta":
        beta_grid = np.asarray(tbs, dtype=np.float64)
    else:
        beta_grid = np.asarray(
            [1.0 / t if abs(t) > tiny else 1.0 / tiny for t in tbs])
    return tbs, beta_grid


def _schedule_ham(model, inp, device):
    """Sector Hamiltonian for the thermal schedule drivers on `device`:
    the factored form under SolverOptions=factored, else the flat form,
    its one-spin factors densified on CUDA (as the Engine builds it) so
    the batched recurrence runs them as ``factor_matmul`` GEMMs."""
    from lanczosplusplus_tpu_torch.config import resolve_device

    device = resolve_device(device)
    parts = model.default_parts(inp)
    basis = model.create_basis(parts)
    dtype = torch.complex128 if "useComplex" in inp.solver_options() \
        else torch.float64
    ham = None
    if "factored" in inp.solver_options():
        from lanczosplusplus_tpu_torch.models.factored import (
            factored_hamiltonian_or_none)
        ham = factored_hamiltonian_or_none(model, basis, parts, dtype,
                                           device=device)
    if ham is None:
        ham = model.hamiltonian(basis, dtype=dtype, device=device)
        if device.type == "cuda":
            ham = ham.densify_factors()
    return ham


def ftlm_schedule(model, inp, num_vectors: int = 32, steps: int = 80,
                  seed: int = 982451653, device="cuda"):
    """<E>(T or beta) on the reference's TemperatureOrBeta* schedule
    (ExactDiag.h:31-39 labels) estimated by FTLM instead of the full
    spectrum: the `ed` capability at Hilbert dimensions where dense
    diagonalization is impossible.  Returns (schedule, FTLMResult)."""
    tbs, beta_grid = _schedule_grid(inp)
    ham = _schedule_ham(model, inp, device)
    res = ftlm(ham, beta_grid, num_vectors=num_vectors, steps=steps,
               seed=seed)
    return [(tb, float(e)) for tb, e in zip(tbs, res.energy)], res


def ltlm_schedule(model, inp, num_vectors: int = 16, steps: int = 80,
                  seed: int = 982451653, device="cuda"):
    """<E>(T or beta) on the same schedule by the LTLM symmetric
    estimator (A = H): exact in the beta -> inf limit where the plain
    FTLM energy estimator decorrelates.  One stored-V Lanczos run a random
    vector plus one (M, dim) x (dim, M) product (the H projection).
    Returns (schedule, the ltlm dict)."""
    tbs, beta_grid = _schedule_grid(inp)
    ham = _schedule_ham(model, inp, device)
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # traces are basis-independent: the recurrence and the H
        # projection run in the block order (as ftlm and
        # GrandCanonicalFTLM do)
        ham = ham.inner
    res = ltlm(ham, beta_grid, {"energy": ham},
               num_vectors=num_vectors, steps=steps, seed=seed)
    return [(tb, float(e)) for tb, e in zip(tbs, res["energy"])], res
