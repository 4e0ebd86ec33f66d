"""Momentum-resolved dynamics drivers.

Counterpart of ``lanczosplusplus_tpu/engine/dynamics.py``:

1. ``dynamics1_spectral``: continued fraction of
   |phi> = sum_site e^{i k site} (c^dag_{a,up} c_{b,up})_site |gs>
   (reference: src/dynamics1.cpp:22-98; the reference applies a
   site-independent phase factor 2 pi m / L (dynamics1.cpp:43-44), which
   collapses to a global phase; here the phase is e^{i k site}, the
   k-resolved operator its own dynamicsFt.pl pipeline expects).

2. ``quasiparticle_weight_z``: Z(k) = |<gs_{N-1}| c_k |gs_N>|^2 with
   c_k = sum_site e^{2 pi i k site / L} c_site (reference:
   src/quasiparticleWeightZ.cpp:33-67, 139-204; the second sector's
   engine is built directly instead of rewriting the input text).

States, the operator scatters and the Lanczos runs are on the engine's
device; the sector Hamiltonians built here have their one-spin factors
densified on CUDA, as the Engine builds its own.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.engine.engine import apply_operator_map
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.spectral import ContinuedFraction
from lanczosplusplus_tpu_torch.solver import lanczos as lz


def _sector_hamiltonian(engine, basis, dtype: torch.dtype):
    """A sector's flat Hamiltonian on the engine's device, its one-spin
    factors densified on CUDA."""
    device = engine.config.device
    ham = engine.model.hamiltonian(basis, dtype=dtype, device=device)
    if device.type == "cuda":
        ham = ham.densify_factors()
    return ham


def dynamics1_spectral(engine, m_for_k: int, orbs=(0, 1),
                       max_steps: int = 200) -> ContinuedFraction:
    model = engine.model
    n = model.geometry.number_of_sites()
    gs = engine.eigenvector(0).to(torch.complex128)
    phi = torch.zeros(engine.basis.size, dtype=torch.complex128,
                      device=gs.device)
    op = LabeledOperator("cdagger_a_up_c_b_up")
    for site in range(n):
        arg = 2.0 * np.pi * m_for_k * site / n
        factor = np.cos(arg) + 1j * np.sin(arg)
        tgt, amp, dst = model.operator_map(op, site, 0, orbs,
                                           engine.basis, engine.basis)
        phi += apply_operator_map(tgt, amp, dst, gs, factor)
    weight = torch.vdot(phi, phi).real.item()
    if weight < 1e-20:
        return ContinuedFraction(np.zeros(0), np.zeros(0),
                                 engine.ground_energy, 0.0, 1)
    ham = _sector_hamiltonian(engine, engine.basis, torch.complex128)
    res = lz.tridiagonalize(ham, phi / np.sqrt(weight), max_steps)
    # bosonic, diagonal, type 0 (reference dynamics1.cpp:92-96)
    return ContinuedFraction(alphas=res.alphas, betas=res.betas,
                             e0=engine.ground_energy, weight=weight,
                             sigma=1, meta=f"k={m_for_k}")


def quasiparticle_weight_z(engine, spin: int = 0, ratio: bool = False):
    """Z(k) for all momenta; returns list of (k_index, value)."""
    model = engine.model
    n = model.geometry.number_of_sites()
    op_c = LabeledOperator("c")
    new_parts = model.has_new_parts(engine.parts, op_c, spin, 0)
    if new_parts is None:
        return []
    basis2 = model.create_basis(new_parts)
    ham2 = _sector_hamiltonian(engine, basis2, torch.float64)
    _, vecs2 = lz.lowest_states(ham2, num_states=1,
                                seed=engine.config.seed,
                                max_steps=engine.config.lanczos_steps)
    gs2 = vecs2[0].to(torch.complex128)
    gs1 = engine.eigenvector(0).to(torch.complex128)

    out = []
    # per-site maps computed once
    site_maps = [model.operator_map(op_c, site, spin, 0, engine.basis,
                                    basis2) for site in range(n)]
    for k in range(n):
        phi = torch.zeros(basis2.size, dtype=torch.complex128,
                          device=gs1.device)
        for site in range(n):
            arg = 2.0 * np.pi * k * site / n
            factor = np.cos(arg) + 1j * np.sin(arg)
            tgt, amp, dst = site_maps[site]
            phi += apply_operator_map(tgt, amp, dst, gs1, factor)
        norm2 = torch.vdot(phi, phi).real.item()
        z = abs(torch.vdot(gs2, phi).item()) ** 2
        if ratio and norm2 > 1e-20:
            z /= norm2
        out.append((k, z))
    return out
