"""Momentum-projected Lanczos: translation sectors solved in the full space.

Counterpart of ``lanczosplusplus_tpu/symmetry/projected.py``:
``rotation_weights``, ``translation_sectors``,
``RotationProjectedHamiltonian`` and ``ProjectedTranslationSolver``.  The
orbit blocks (``symmetry/blocks.py``) assemble each k-block as an ELL with
random columns.  This module never assembles a block: Lanczos runs in the
FULL space on the factored matvec, restricted to momentum sector k by
composing every matvec with the projector

    P_k = (c_k / L) sum_g  cos(2 pi k g / L) T^g        (real form)

Since [H, T] = 0, P_k H equals P_k H P_k and is symmetric; its spectrum on
the sector is exactly the k-block's (for 0 < k < L/2 the real projector
spans the degenerate (k, -k) pair, whose spectra are equal for a real H).
Applying P_k every step also keeps round-off from leaking into other
sectors.

For bases where state index == bit word and translation is a cyclic BIT
rotation (the Kitaev chain's identity basis, BasisKitaev.h:28-34), T^g is
a reshape-transpose, ``v.view(1 << g, -1).t().reshape(-1)``: no gathers,
so P_k costs about L copies of the state.  Reference capability:
TranslationSymmetry.h:251-268 (the block split).
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import real_dtype_of
from lanczosplusplus_tpu_torch.ops.refine import f64_twin


def rotation_weights(nsite: int, k: int) -> np.ndarray:
    """Real momentum-projector weights over the translation group: the
    rank-preserving combination of e^{+ik} and e^{-ik} characters (a
    projector: P^2 = P), so all sectors 0..L//2 cover the space."""
    g = np.arange(nsite)
    scale = 1.0 / nsite if k in (0, nsite - k) else 2.0 / nsite
    return scale * np.cos(2.0 * np.pi * k * g / nsite)


class RotationProjectedHamiltonian:
    """H restricted to momentum sector k of a cyclic bit-rotation
    translation group: matvec(x) = P_k (H x), with P_k applied as weighted
    reshape-transposes on the state's device.  The weights are held in
    the inner form's real type (JAX casts them to float32 for a float32
    form), a host tensor that ``ops/refine`` narrows and widens with the
    inner form's tables."""

    def __init__(self, inner, weights):
        self.inner = inner               # the full-space Hamiltonian
        # (L,) real weights
        self.weights = torch.as_tensor(
            np.asarray(weights, dtype=np.float64)).to(
            real_dtype_of(inner.dtype))

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def project(self, v: torch.Tensor) -> torch.Tensor:
        w = self.weights.tolist()
        acc = v * w[0]
        for g in range(1, len(w)):
            acc.add_(v.view(1 << g, -1).t().reshape(-1), alpha=w[g])
        return acc

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(self.inner.matvec(x))


def translation_sectors(nsite: int):
    """The k values whose real projectors partition the space."""
    return list(range(nsite // 2 + 1))


class ProjectedTranslationSolver:
    """Per-momentum ground states of a translation-invariant H whose
    basis index is the bit word (Kitaev chain: full 2^L space).

    Duck-typed like the block symmetries where it matters to the Engine
    (`sectors()`, `transform()`), but solving happens in the full space:
    `solve_sector(k, ...)` returns (evals, vecs, info) with the vectors
    already in the site basis, on the Hamiltonian's device.  `purity(k,
    v)` = ||P_k v||^2 / ||v||^2: 1.0 for a clean sector vector (the
    honesty probe for the projected run).  `twin` is the float64 form
    `ham` was narrowed from (by default the form's ``f64_twin``: the
    form itself in float64), which a sector's energies are refined
    against."""

    def __init__(self, ham, nsite: int, twin=None):
        if ham.dim != (1 << nsite):
            raise ValueError(
                f"projected translation needs the full 2^L space "
                f"(dim {ham.dim} != 2^{nsite})")
        self.ham = ham
        self.twin = f64_twin(ham) if twin is None else twin
        self.nsite = nsite
        self._ks = translation_sectors(nsite)

    def sectors(self) -> int:
        return len(self._ks)

    def momentum(self, s: int) -> int:
        return self._ks[s]

    def projected(self, s: int, form=None) -> RotationProjectedHamiltonian:
        """Sector s's projection of `form` (default the solved form)."""
        return RotationProjectedHamiltonian(
            self.ham if form is None else form,
            rotation_weights(self.nsite, self._ks[s]))

    def start_vector(self, s: int, seed: int = 7239443) -> torch.Tensor:
        """The seeded random start (``random_start_vector``) projected
        onto sector s, unit norm."""
        from lanczosplusplus_tpu_torch.solver.lanczos import (
            random_start_vector)
        v = self.projected(s).project(random_start_vector(
            self.ham.dim, seed, self.ham.dtype, self.ham.device))
        n = torch.linalg.vector_norm(v).item()
        if n == 0.0:
            raise ValueError(f"momentum sector {self._ks[s]} start "
                             "vector vanished")
        return v / n

    def solve_sector(self, s: int, num_states: int = 1,
                     max_steps: int = 200, seed: int = 7239443, **kw):
        """(evals, vecs, info) for momentum sector s, no dense fallback.
        A sector's energies below float64 are refined against the
        sector's projection of the float64 form (``twin``); JAX refines
        them against the unprojected H: the vectors lie in the sector, so
        the Rayleigh quotients agree."""
        from lanczosplusplus_tpu_torch.solver import lanczos as lz
        return lz.lowest_states(
            self.projected(s), num_states=num_states, max_steps=max_steps,
            v0=self.start_vector(s, seed), return_info=True,
            refine=self.projected(s, self.twin), dense_fallback_dim=0, **kw)

    def purity(self, s: int, v: torch.Tensor) -> float:
        pv = self.projected(s).project(v)
        return (torch.vdot(v, pv).real / torch.vdot(v, v).real).item()

    def transform(self, vec, sector):
        return vec
