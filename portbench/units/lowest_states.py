"""Units of ``lowest_states``: one ground-state solve of the sector,
``solver/lanczos.lowest_states`` from a start vector drawn for the unit."""

from __future__ import annotations

import torch

from portbench.reference import solvers
from portbench.units import draw_block, sample_rng


class Unit:
    """Every unit's E0 and whether it converged are kept, and the vectors
    of ``checked`` units, a sample drawn from the seed over all the units
    of the window (reservoir sampling into slots made at warm-up, so that
    which units are kept changes no allocation)."""

    def __init__(self, params: dict, ham, seed: int, refine=True):
        self.p = params
        self.ham = ham
        self.seed = seed
        self.refine = refine
        self.energies: list[float] = []
        self.steps: list[int] = []
        self.unconverged: list[int] = []
        self.kept = None
        self.kept_units: list[int] = []
        self.rng = sample_rng(seed)

    def _solve(self, index: int):
        from lanczosplusplus_tpu_torch.solver import lanczos as lz

        v0 = draw_block(self.seed, index, 1, self.ham.dim, self.ham.device)[0]
        evals, vecs, info = lz.lowest_states(
            self.ham, num_states=1, tol=self.p["tol"],
            max_steps=self.p["max_steps"], reorth=self.p["reorth"], v0=v0,
            return_info=True, refine=self.refine)
        return float(evals[0]), vecs[0], info

    def _make_slots(self) -> None:
        self.kept = torch.empty((self.p["checked"], self.ham.dim),
                                dtype=self.ham.dtype, device=self.ham.device)

    def warm_up(self) -> None:
        self._solve(-1)
        self._make_slots()

    def run(self, index: int) -> None:
        if self.kept is None:
            self._make_slots()
        energy, vector, info = self._solve(index)
        self.energies.append(energy)
        self.steps.append(int(info.steps))
        if not info.converged:
            self.unconverged.append(index)
        slots = self.kept.shape[0]
        slot = index if index < slots else int(self.rng.integers(index + 1))
        if slot < slots:
            self.kept[slot].copy_(vector)
            if slot < len(self.kept_units):
                self.kept_units[slot] = index
            else:
                self.kept_units.append(index)

    def counts(self) -> dict:
        return {"steps": sum(self.steps)}

    def release(self) -> None:
        self.ham = None

    def numbers(self, reference, limits: dict) -> tuple[dict, int, list]:
        """({"eigpair_gap": worst}, units failed, lines): each unit's E0
        against the reference's, and each kept unit's (E0, vector) pair by
        ``solvers.pair_gap``.  A unit whose solve did not converge
        (``SolveInfo.converged``) has failed, whatever its gap."""
        e0 = solvers.lowest_energy(reference)
        limit = limits["eigpair_gap"]
        gaps = [abs(e - e0) / abs(e0) for e in self.energies]
        for slot, unit in enumerate(self.kept_units):
            gaps[unit] = max(gaps[unit], solvers.pair_gap(
                reference, self.energies[unit], self.kept[slot], e0))
        unconverged = set(self.unconverged)
        lines = [f"reference E0 {e0!r}; units {len(gaps)}, vectors checked "
                 f"{sorted(self.kept_units)}; E0 of the units "
                 f"{min(self.energies)!r} .. {max(self.energies)!r}; "
                 f"worst pair gap {max(gaps):.3e}; units not converged "
                 f"{sorted(unconverged)}"]
        failed = sum(g > limit or i in unconverged
                     for i, g in enumerate(gaps))
        return {"eigpair_gap": max(gaps)}, failed, lines
