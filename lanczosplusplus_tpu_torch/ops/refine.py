"""Energies of a solve below float64, refined to the float64 bar.

Counterpart of the refinement half of ``lanczosplusplus_tpu/ops/df64.py``:
``matvec_f64`` (JAX ``host_matvec_f64``), ``host_refined_energy``,
``rqi_refined_energy`` with its restarted GMRES correction solve, and
``refinement_flops``.  The reference is double precision throughout
(reference: src/Engine/LanczosDriver.h:29-33); a float32 (complex64)
Lanczos solve, or one whose matvec rounds the state to bfloat16 (a
``quantized`` form), reaches its energies to about 1e-6 relative, and
these functions lift them to 1e-12.

The JAX package has no float64 on its chip, so it applies H in float64 on
the host (or in double-float emulation on the chip).  The H100 has native
FP64, so here ``matvec_f64`` runs on the Hamiltonian's device through the
float64 and complex128 kernels, on the float64 twin of the form's stored
tables (``f64_twin``): each value table widened (float32 and bfloat16 to
float64, complex64 to complex128), the int32 index tables shared.  It
applies exactly what the JAX function applies: bf16 Kitaev factors as they
were rounded, the bf16cross amplitude tables at their full precision with
no state cast, and a flat form's one-spin part through its gather maps
(densified again in float64 where the form had dense factors, which equal
the maps).  A caller that has the float64 form a float32 one was cast from
(``narrowed``; the Engine builds every form in float64) refines against
that instead, so a coupling float32 cannot hold (0.3, 0.7) keeps its
float64 value.  The df64 error-free transforms and
``chip_rqi_refined_energy`` are not ported: FP64 is native here.

Mixed-precision Rayleigh-quotient iteration (``rqi_refined_energy``): the
residual r = H v - theta v in float64, the correction equation (H - theta)
t = r solved cheaply in the form's own precision through its own matvec
(restarted GMRES, ``restart=20, maxiter=3, tol=1e-4`` as the JAX package
calls ``jax.scipy.sparse.linalg.gmres``), v <- v - t in float64; both r
and t are kept orthogonal to v, along which H - theta is nearly singular.
Two steps bring the Rayleigh quotient to 1e-12..1e-14 relative.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of

_WIDER = {torch.float32: torch.float64, torch.bfloat16: torch.float64,
          torch.complex64: torch.complex128}
_NARROWER = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def _wide(t: torch.Tensor | None) -> torch.Tensor | None:
    """A value table in float64 or complex128 (None stays None)."""
    if t is None or t.dtype not in _WIDER:
        return t
    return t.to(_WIDER[t.dtype])


def _wide_type(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype.is_complex else torch.float64


def _narrow(t: torch.Tensor | None) -> torch.Tensor | None:
    """A float64 (complex128) value table in float32 (complex64); a
    bfloat16 one stays as it is."""
    if t is None or t.dtype not in _NARROWER:
        return t
    return t.to(_NARROWER[t.dtype])


def _map_tables(ham, fn, keep_cast: bool, keep_dense: bool):
    """The form `ham` with `fn` applied to every value table and its index
    tables shared.  `keep_cast` keeps the bf16cross state casts,
    `keep_dense` a flat form's dense factors (else they are dropped, the
    one-spin part in gather form)."""
    from lanczosplusplus_tpu_torch.core.blockkron import (
        BlockKronHamiltonian, PermutedHamiltonian)
    from lanczosplusplus_tpu_torch.core.sparse import (
        EllPart, Hamiltonian, SpinFactorizedPart)
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        FactoredKitaevHamiltonian)
    from lanczosplusplus_tpu_torch.symmetry.projected import (
        RotationProjectedHamiltonian)

    if isinstance(ham, RotationProjectedHamiltonian):
        # the inner form and the projector's weights change type together
        return RotationProjectedHamiltonian(
            _map_tables(ham.inner, fn, keep_cast, keep_dense),
            fn(ham.weights).tolist())
    if isinstance(ham, PermutedHamiltonian):
        return dataclasses.replace(
            ham, inner=_map_tables(ham.inner, fn, keep_cast, keep_dense),
            sign=fn(ham.sign))
    if isinstance(ham, BlockKronHamiltonian):
        each = lambda ts: tuple(fn(t) for t in ts)  # noqa: E731
        return dataclasses.replace(
            ham, diag=each(ham.diag), row_ops=each(ham.row_ops),
            col_ops=each(ham.col_ops),
            cross=tuple(dataclasses.replace(t, left=fn(t.left),
                                            right=fn(t.right))
                        for t in ham.cross),
            perm_cross=tuple(dataclasses.replace(
                t, row_amp=fn(t.row_amp), col_amp=fn(t.col_amp),
                state_cast=t.state_cast if keep_cast else None)
                for t in ham.perm_cross),
            diag_t=each(ham.diag_t), row_t=each(ham.row_t),
            col_t=each(ham.col_t))
    if isinstance(ham, FactoredKitaevHamiltonian):
        return FactoredKitaevHamiltonian(
            diag2d=fn(ham.diag2d), hl=fn(ham.hl), hr_t=fn(ham.hr_t),
            p=fn(ham.p), q=fn(ham.q))
    if isinstance(ham, Hamiltonian):
        f = ham.factorized
        fact = None
        if f is not None:
            fact = SpinFactorizedPart(
                up_cols=f.up_cols, up_vals=fn(f.up_vals),
                dn_cols=f.dn_cols, dn_vals=fn(f.dn_vals),
                up_dense=fn(f.up_dense) if keep_dense else None,
                dn_dense=fn(f.dn_dense) if keep_dense else None)
        return Hamiltonian(
            diag=fn(ham.diag),
            ell=None if ham.ell is None else EllPart(
                cols=ham.ell.cols, vals=fn(ham.ell.vals)),
            factorized=fact, spin_shape=ham.spin_shape)
    raise TypeError(f"no value tables known of a {type(ham).__name__}")


def f64_twin(ham):
    """The form `ham` with every stored value table in float64 (complex128
    for a complex table), its index tables shared, and no stage that
    rounds the state: the operator a refinement applies to a form handed
    in alone, as JAX ``host_matvec_f64`` does (a flat form's one-spin
    part from its gather maps, densified again in float64 where the form
    had dense factors).  Build it once a solve; the twin of a float64
    form without bf16 stages is the form itself."""
    if ham.dtype in (torch.float64, torch.complex128) \
            and not getattr(ham, "quantized", False):
        return ham
    twin = _map_tables(ham, _wide, keep_cast=False, keep_dense=False)
    f = getattr(ham, "factorized", None)
    if f is not None and (f.up_dense is not None or f.dn_dense is not None):
        twin = twin.densify_factors()
    return twin


def narrowed(ham):
    """The float32 (complex64) copy of a float64 (complex128) form, its
    index tables shared, its bf16 stages and dense factors kept: the
    Engine builds every form in float64 and solves this copy, so the
    refinement applies the model's own float64 coefficients."""
    return _map_tables(ham, _narrow, keep_cast=True, keep_dense=True)


def solve_pair(ham64, real_dtype: torch.dtype):
    """(the form a solve in `real_dtype` applies, the float64 form its
    energies are refined against) for a form built in float64 (complex128):
    `ham64` twice under float64, else its ``narrowed`` copy and `ham64`."""
    if real_dtype == torch.float64:
        return ham64, ham64
    return narrowed(ham64), ham64


def matvec_f64(ham, v: torch.Tensor, twin=None) -> torch.Tensor:
    """H v in float64 (complex128 for a complex form) on the Hamiltonian's
    device, through `twin` (``f64_twin(ham)``, made here when not
    given); v is a state of the form's type or wider."""
    twin = f64_twin(ham) if twin is None else twin
    x = torch.as_tensor(v, device=twin.device).to(_wide_type(twin.dtype))
    return twin.matvec(x.contiguous())


def _rayleigh(x: torch.Tensor, y: torch.Tensor) -> float:
    return (torch.vdot(x, y).real / torch.vdot(x, x).real).item()


def host_refined_energy(ham, v: torch.Tensor, twin=None) -> float:
    """<v|H|v> / <v|v> in float64: one float64 matvec (on the card; the
    name is the JAX package's).  It squares the vector's error: about
    1e-6 relative from a float32 Ritz vector."""
    y = matvec_f64(ham, v, twin)
    return _rayleigh(torch.as_tensor(v, device=y.device).to(y.dtype), y)


def _norm(x: torch.Tensor) -> float:
    return torch.linalg.vector_norm(x).item()


def _gram_schmidt(Q: torch.Tensor, q: torch.Tensor, qnorm: float):
    """(q orthogonalized against the rows of Q, the overlaps): classical
    Gram-Schmidt, a second pass when the overlaps are small against what
    is left of q (JAX ``_iterative_classical_gram_schmidt``,
    max_iterations=2)."""
    h = Q.conj() @ q
    q = q - h @ Q
    if _norm(h) < _norm(q) / np.sqrt(2.0):
        h2 = Q.conj() @ q
        q = q - h2 @ Q
        h = h + h2
    return q, h


def gmres(apply, b: torch.Tensor, restart: int = 20, maxiter: int = 3,
          tol: float = 1e-4) -> torch.Tensor:
    """Restarted GMRES for apply(x) = b from x = 0, in b's type on its
    device: each restart builds a Krylov basis of `restart` vectors by
    Arnoldi (classical Gram-Schmidt, twice where needed), solves the small
    least-squares problem on the host in float64 and updates x; restarts
    until |b - A x| <= tol |b| or `maxiter` restarts (JAX
    ``jax.scipy.sparse.linalg.gmres`` with ``solve_method="batched"``,
    atol 0).  A plain function on tensors, not a kernel."""
    n = b.shape[0]
    restart = min(restart, n)
    eps = torch.finfo(real_dtype_of(b.dtype)).eps
    htype = np.complex128 if b.is_complex() else np.float64
    atol = tol * _norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    r_norm = _norm(r)
    for _ in range(maxiter):
        if not r_norm > atol:
            break
        V = torch.zeros((restart + 1, n), dtype=b.dtype, device=b.device)
        if r_norm > eps:
            V[0] = r / r_norm
        # rows not reached before a breakdown stay the identity's, so the
        # least-squares problem keeps its shape
        H = np.eye(restart, restart + 1, dtype=htype)
        for k in range(restart):
            w = apply(V[k])
            w_norm0 = _norm(w)
            w, h = _gram_schmidt(V[:k + 1], w, w_norm0)
            w_norm1 = _norm(w)
            row = np.zeros(restart + 1, dtype=htype)
            row[:k + 1] = h.cpu().numpy()
            if w_norm1 > eps * w_norm0:
                V[k + 1] = w / w_norm1
                row[k + 1] = w_norm1
            H[k] = row
            if row[k + 1] == 0:
                break
        rhs = np.zeros(restart + 1, dtype=htype)
        rhs[0] = r_norm
        y = np.linalg.lstsq(H.T, rhs, rcond=None)[0]
        x = x + torch.as_tensor(y, device=b.device).to(b.dtype) @ V[:-1]
        r = b - apply(x)
        r_norm = _norm(r)
    return x


def rqi_refined_energy(ham, v: torch.Tensor, iters: int = 2,
                       restart: int = 20, maxiter: int = 3,
                       twin=None) -> float:
    """Rayleigh-quotient iteration with float64 residuals (through
    ``matvec_f64``) and correction solves in the form's own precision
    through its own matvec (``gmres``): iters + 1 float64 matvecs and
    `iters` correction solves of at most maxiter * (restart + 1) matvecs.
    A GMRES breakdown keeps the last finite iterate."""
    twin = f64_twin(ham) if twin is None else twin
    wide = _wide_type(ham.dtype)
    x = torch.as_tensor(v, device=ham.device).to(wide)
    x = x / torch.linalg.vector_norm(x)
    rdt = real_dtype_of(ham.dtype)
    for _ in range(iters):
        y = matvec_f64(ham, x, twin)
        theta = torch.vdot(x, y).real.item()
        r = y - theta * x
        r = r - torch.vdot(x, r) * x
        if _norm(r) <= 1e-13 * max(1.0, abs(theta)):
            return theta
        # theta as the form's type holds it (JAX casts it to the dtype)
        shift = torch.tensor(theta, dtype=rdt).item()

        def shifted(z):
            return ham.matvec(z.contiguous()) - shift * z
        t = gmres(shifted, r.to(ham.dtype), restart=restart,
                  maxiter=maxiter).to(wide)
        t = t - torch.vdot(x, t) * x
        xn = x - t
        nn = _norm(xn)
        if not np.isfinite(nn) or nn == 0.0:
            break  # GMRES breakdown: keep the last finite iterate
        x = xn / nn
    return _rayleigh(x, matvec_f64(ham, x, twin))


def refinement_flops(ham) -> float:
    """Rough flop count of one ``matvec_f64`` (JAX ``refinement_flops``):
    the JAX package caps its automatic refinement by it, because its
    float64 matvec runs on the host; the port's runs on the card and
    ``solver/lanczos._maybe_refine`` runs the full RQI for every form."""
    from lanczosplusplus_tpu_torch.core.blockkron import (
        BlockKronHamiltonian, PermutedHamiltonian)
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        FactoredKitaevHamiltonian)

    if isinstance(ham, PermutedHamiltonian):
        return refinement_flops(ham.inner)
    if isinstance(ham, BlockKronHamiltonian):
        n = 0.0
        for b, (r, c) in enumerate(ham.shapes):
            n += r * c
            if ham.row_ops[b] is not None:
                n += 2.0 * r * r * c
            if ham.col_ops[b] is not None:
                n += 2.0 * r * c * c
        for t in ham.cross:
            nb, rd, rs = t.left.shape
            cd, cs = t.right.shape[1:]
            n += 2.0 * nb * (rd * rs * cs + rd * cs * cd)
            if t.add_hc:
                n += 2.0 * nb * (rd * cd * cs + rd * rs * cs)
        for t in ham.perm_cross:
            n += 3.0 * t.row_src.shape[0] * t.row_src.shape[1] \
                * t.col_src.shape[1]
        return n
    if isinstance(ham, FactoredKitaevHamiltonian):
        dl, dr = ham.diag2d.shape
        k = int(ham.p.shape[0])
        return float(dl * dr + 2.0 * (1 + k) * dl * dr * (dl + dr))
    n = 2.0 * ham.dim
    f = ham.factorized
    if f is not None:
        szd, szu = ham.spin_shape
        if f.up_cols is not None:
            n += 2.0 * szd * f.up_cols.numel()
        if f.dn_cols is not None:
            n += 2.0 * szu * f.dn_cols.numel()
    if ham.ell is not None:
        n += 2.0 * ham.ell.cols.numel()
    return float(n)
