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
    reshape-transposes on the state's device."""

    def __init__(self, inner, weights: np.ndarray):
        self.inner = inner               # the full-space Hamiltonian
        self.weights = [float(w) for w in weights]   # (L,) real weights

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
        acc = v * self.weights[0]
        for g in range(1, len(self.weights)):
            acc.add_(v.view(1 << g, -1).t().reshape(-1),
                     alpha=self.weights[g])
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
    honesty probe for the projected run)."""

    def __init__(self, ham, nsite: int):
        if ham.dim != (1 << nsite):
            raise ValueError(
                f"projected translation needs the full 2^L space "
                f"(dim {ham.dim} != 2^{nsite})")
        if ham.dtype not in (torch.float64, torch.complex128):
            raise NotImplementedError(
                f"projected translation runs in float64 only; {ham.dtype} "
                f"waits for ROADMAP Queue 1 item 11b")
        self.ham = ham
        self.nsite = nsite
        self._ks = translation_sectors(nsite)

    def sectors(self) -> int:
        return len(self._ks)

    def momentum(self, s: int) -> int:
        return self._ks[s]

    def projected(self, s: int) -> RotationProjectedHamiltonian:
        return RotationProjectedHamiltonian(
            self.ham, rotation_weights(self.nsite, self._ks[s]))

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
        The JAX package then refines the energies of a state stored below
        float64; the port projects float64 and complex128 states only
        (ROADMAP Queue 1 item 11b), whose energies it keeps as they
        are."""
        from lanczosplusplus_tpu_torch.solver import lanczos as lz
        return lz.lowest_states(
            self.projected(s), num_states=num_states, max_steps=max_steps,
            v0=self.start_vector(s, seed), return_info=True,
            dense_fallback_dim=0, **kw)

    def purity(self, s: int, v: torch.Tensor) -> float:
        pv = self.projected(s).project(v)
        return (torch.vdot(v, pv).real / torch.vdot(v, v).real).item()

    def transform(self, vec, sector):
        return vec
