"""The model-level choice of a factored (block-Kronecker) form.

Counterpart of ``factored_hamiltonian_or_none`` in
``lanczosplusplus_tpu/models/__init__.py``: the same dispatch by model
class, the same size cap for FeAs and the same `warn` behaviour.  A model
or input that no builder serves returns None with a logged reason, and
the caller keeps the flat form; that is the model's choice, never a
device's or a kernel's.
"""

from __future__ import annotations

import torch


def factored_hamiltonian_or_none(model, basis, parts, dtype: torch.dtype,
                                 device="cpu", warn=None, cross_dtype=None):
    """The block-factorized Hamiltonian for models that have one
    (arbitrary-S Heisenberg Sz sectors, Kitaev full space, Rashba total-N
    sectors under a half-cut, t-J spatial half-cut, FeAs spin-orbit
    (nup, ndown) union blocks, FeAs single block), on `device`, or None.
    `warn` is an optional callable(str), invoked with the reason whenever
    the factored form is unavailable.  `cross_dtype` (torch.bfloat16: the
    bf16 cross gathers) reaches the builders whose cross terms are
    gathers, Rashba and t-J, as in the JAX package."""
    name = type(model).__name__
    try:
        if name == "KitaevModel":
            from lanczosplusplus_tpu_torch.models.kitaev_factored import (
                build_factored_kitaev)
            return build_factored_kitaev(model, basis, dtype=dtype,
                                         device=device)
        if name == "HeisenbergModel":
            from lanczosplusplus_tpu_torch.models.heisenberg_factored import (
                FactoredHeisenbergChain)
            nsite = model.geometry.number_of_sites()
            fact = FactoredHeisenbergChain(model, nsite, parts[1],
                                           dtype=dtype, device=device)
            return fact.flat_ham(basis)
        if name == "RashbaSOCModel":
            # spatial half-cut: the within-half Rashba flips are GEMMs,
            # only the cut-crossing bonds are gathers
            from lanczosplusplus_tpu_torch.models.rashba_halfcut import (
                build_halfcut_rashba)
            return build_halfcut_rashba(model, basis, dtype=dtype,
                                        device=device,
                                        cross_dtype=cross_dtype)
        if name == "TjMultiOrbModel":
            from lanczosplusplus_tpu_torch.models.tj_factored import (
                build_factored_tj)
            return build_factored_tj(model, basis, dtype=dtype,
                                     device=device, cross_dtype=cross_dtype)
        if name == "FeAsSpinOrbitModel":
            from lanczosplusplus_tpu_torch.models.feas_spinorbit_factored \
                import build_factored_feas_spinorbit
            return build_factored_feas_spinorbit(model, basis, dtype=dtype,
                                                 device=device)
        if name == "FeBasedScModel":
            # single-block form: dense one-spin hop factors, exact
            # (dn x up) channels for the interaction remainder; the dense
            # factors cap the sector size, past the cap the flat form stays
            szu, szd = basis.up.size, basis.down.size
            if szu * szu + szd * szd > (1 << 26):
                raise NotImplementedError(
                    f"one-spin dims ({szu}, {szd}) too large for the "
                    "dense block-Kronecker factors")
            return model.block_kron_hamiltonian(basis, dtype=dtype,
                                                device=device)
    except NotImplementedError as e:
        if warn is not None:
            warn(f"SolverOptions=factored: no factored form for "
                 f"{name} on this input ({e}); falling back to the "
                 f"flat gather path")
        return None
    if warn is not None:
        warn(f"SolverOptions=factored: {name} has no factored "
             f"builder; falling back to the flat gather path")
    return None
