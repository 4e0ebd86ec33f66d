"""Model factory keyed by the input's Model= line.

Counterpart of ``lanczosplusplus_tpu/models/registry.py`` (reference:
src/Engine/ModelSelector.h:45-96): every reference model string builds.
"""

from __future__ import annotations

HUBBARD_FAMILY = ("HubbardOneBand", "HubbardOneBandExtended",
                  "SuperHubbardExtended", "KaneMeleHubbard")


def build_model(inp, geometry):
    name = inp.string("Model")
    if name in HUBBARD_FAMILY:
        from lanczosplusplus_tpu_torch.models.hubbard import HubbardModel
        return HubbardModel(inp, geometry)
    if name == "HubbardOneBandRashbaSOC":
        from lanczosplusplus_tpu_torch.models.rashba import RashbaSOCModel
        return RashbaSOCModel(inp, geometry)
    if name == "Heisenberg":
        from lanczosplusplus_tpu_torch.models.heisenberg import (
            HeisenbergModel)
        return HeisenbergModel(inp, geometry)
    if name == "Kitaev":
        from lanczosplusplus_tpu_torch.models.kitaev import KitaevModel
        return KitaevModel(inp, geometry)
    if name == "TjMultiOrb":
        from lanczosplusplus_tpu_torch.models.tj import TjMultiOrbModel
        return TjMultiOrbModel(inp, geometry)
    if name in ("FeAsBasedSc", "FeAsBasedScExtended"):
        # a 4x4 SpinOrbit matrix selects the spin-mixing basis variant
        # (reference: ModelSelector.h:45-96)
        if inp.has("SpinOrbit"):
            from lanczosplusplus_tpu_torch.models.feas_spinorbit import (
                FeAsSpinOrbitModel)
            return FeAsSpinOrbitModel(inp, geometry)
        from lanczosplusplus_tpu_torch.models.feas import FeBasedScModel
        return FeBasedScModel(inp, geometry)
    if name == "Immm":
        from lanczosplusplus_tpu_torch.models.immm import ImmmModel
        return ImmmModel(inp, geometry)
    raise ValueError(f"unknown Model= {name}")
