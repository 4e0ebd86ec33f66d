"""Engine: sector diagonalization on construction, energies and vectors.

Counterpart of the ground-state part of
``lanczosplusplus_tpu/engine/engine.py`` (``Engine.__init__``,
``hamiltonian``, ``_log_solve``, ``energies``, ``eigenvector`` and
``ground_energy``), itself a functional re-design of the reference Engine
(reference: src/Engine/Engine.h:84-98 ctor diagonalizes; 601-657
computeAllStatesBelow).  Symmetry sectors and factored forms are not
ported yet and raise.
"""

from __future__ import annotations

from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.utils.progress import ProgressIndicator


class Engine:
    """Diagonalizes the target sector on construction and serves the
    energies and eigenvectors.  `config` defaults to the input's solver
    labels on ``cuda``; `v0` is an optional start vector for the solve."""

    def __init__(self, model, inp, config: Config | None = None, v0=None):
        self.progress = ProgressIndicator("Engine")
        self.model = model
        self.inp = inp
        self.config = config or Config.from_input(inp)
        self.excited = inp.integer("Excited", default=0)
        if (inp.integer("UseTranslationSymmetry", default=0) or
                inp.integer("UseReflectionSymmetry", default=0)):
            raise NotImplementedError(
                "symmetry sectors are not ported yet (ROADMAP Queue 1 "
                "item 12)")
        if "factored" in inp.solver_options():
            raise NotImplementedError(
                "SolverOptions=factored is not ported yet (ROADMAP Queue 1 "
                "item 10)")
        self.parts = model.default_parts(inp)
        self.basis = model.create_basis(self.parts)
        self._flat_ham = None
        with self.progress.phase(
                f"diagonalization dim={self.basis.size}"):
            self._energies, self._vectors, info = lz.lowest_states(
                self.hamiltonian, num_states=self.excited + 1,
                seed=self.config.seed,
                max_steps=self.config.lanczos_steps,
                return_info=True, v0=v0)
            self._log_solve(info)

    def _log_solve(self, info):
        """Reference-style convergence report (Engine.h:624-639 prints
        'lanczos solver failed ... trying fullDiag')."""
        self.solve_info = info
        if info.used_dense_fallback and info.steps:
            self.progress(
                "Lanczos did not converge (relative residual "
                f"{info.residual:.3e} after {info.steps} steps); "
                "used dense fullDiag fallback")
        elif not info.converged:
            self.progress(
                "WARNING: Lanczos unconverged (relative residual "
                f"{info.residual:.3e} after {info.steps} steps) and "
                "sector too large for dense fallback")

    @property
    def hamiltonian(self):
        """Sector Hamiltonian on the configured device, built lazily.  On
        CUDA the Kronecker one-spin factors are densified, so every
        matvec runs as two ``factor_matmul`` GEMMs, or raises where a
        factor does not fit; the CPU keeps the gather form.  The form
        taken is logged."""
        if self._flat_ham is None:
            ham = self.model.hamiltonian(self.basis,
                                         dtype=self.config.scalar_dtype,
                                         device=self.config.device)
            if self.config.device.type == "cuda":
                ham = ham.densify_factors()
            f = ham.factorized
            if f is not None:
                dense = [tuple(d.shape) for d in (f.up_dense, f.dn_dense)
                         if d is not None]
                self.progress(
                    f"one-spin factors on {ham.device}: "
                    + (f"dense {dense} through factor_matmul" if dense
                       else "gather form (plain PyTorch)"))
            self._flat_ham = ham
        return self._flat_ham

    def energies(self, i: int = 0) -> float:
        return float(self._energies[i])

    def eigenvector(self, i: int = 0):
        """The i-th eigenvector, a tensor on the configured device."""
        return self._vectors[i]

    @property
    def ground_energy(self) -> float:
        return self.energies(0)
