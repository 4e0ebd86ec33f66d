"""Units of ``ftlm``: one FTLM estimate, ``engine/ftlm.ftlm`` from a start
block drawn for the unit."""

from __future__ import annotations

import numpy as np

from portbench.reference import solvers
from portbench.units import draw_block, sample_rng


class Unit:
    """Every unit's energies and ln Z are kept, and ``checked`` of them,
    drawn from the seed, are held against the reference's estimate from
    the same start block."""

    def __init__(self, params: dict, ham, seed: int, refine=None):
        self.p = params
        self.ham = ham
        self.seed = seed
        self.answers: list[tuple] = []
        beta = params["betas"]
        step = (beta["last"] - beta["first"]) / (beta["count"] - 1)
        self.betas = [beta["first"] + i * step for i in range(beta["count"])]

    def _estimate(self, index: int, steps: int):
        from lanczosplusplus_tpu_torch.engine import ftlm as F

        block = draw_block(self.seed, index, self.p["vectors"],
                           self.ham.dim, self.ham.device)
        return F.ftlm(self.ham, self.betas, num_vectors=self.p["vectors"],
                      steps=steps, start_vectors=block.T)

    def warm_up(self) -> None:
        self._estimate(-1, self.p["warmup_steps"])

    def run(self, index: int) -> None:
        res = self._estimate(index, self.p["steps"])
        self.answers.append((res.energy.copy(), res.log_z.copy(),
                             res.steps))

    def counts(self) -> dict:
        return {"steps": sum(a[2] for a in self.answers)}

    def release(self) -> None:
        self.ham = None

    def numbers(self, reference, limits: dict) -> tuple[dict, int, list]:
        """({"energy_gap", "logz_gap"}: worst over the checked units, each
        max over beta of |program - reference| over max |reference|),
        units failed, lines."""
        n = len(self.answers)
        checked = sorted(int(i) for i in sample_rng(self.seed).choice(
            n, size=min(self.p["checked"], n), replace=False))
        worst = {"energy_gap": 0.0, "logz_gap": 0.0}
        failed = 0
        lines = []
        for unit in checked:
            energy, log_z, _ = self.answers[unit]
            block = draw_block(self.seed, unit, self.p["vectors"],
                               reference.dim, reference.diag.device)
            e_ref, lz_ref = solvers.ftlm(reference, block, self.betas,
                                         self.p["steps"])
            del block
            gaps = {"energy_gap": float(np.abs(energy - e_ref).max()
                                        / np.abs(e_ref).max()),
                    "logz_gap": float(np.abs(log_z - lz_ref).max()
                                      / np.abs(lz_ref).max())}
            failed += any(gaps[k] > limits[k] for k in gaps)
            worst = {k: max(worst[k], gaps[k]) for k in worst}
            lines.append(f"unit {unit}: gaps {gaps}; energies "
                         f"{energy.tolist()}; reference {e_ref.tolist()}")
        return worst, failed, lines
