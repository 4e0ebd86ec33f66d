"""Model factory keyed by the input's Model= line.

Counterpart of ``lanczosplusplus_tpu/models/registry.py`` (reference:
src/Engine/ModelSelector.h:45-96).  Only the Hubbard family is ported; the
other reference models raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

HUBBARD_FAMILY = ("HubbardOneBand", "HubbardOneBandExtended",
                  "SuperHubbardExtended", "KaneMeleHubbard")

# Model= -> the ROADMAP Queue 1 item that ports it
_NOT_PORTED = {
    "HubbardOneBandRashbaSOC": "item 9 (flat models: rashba)",
    "Heisenberg": "item 9 (flat models: heisenberg)",
    "Kitaev": "item 9 (flat models: kitaev)",
    "TjMultiOrb": "item 9 (flat models: tj)",
    "FeAsBasedSc": "item 9 (flat models: feas, feas_spinorbit)",
    "FeAsBasedScExtended": "item 9 (flat models: feas, feas_spinorbit)",
    "Immm": "item 9 (flat models: immm)",
}


def build_model(inp, geometry):
    name = inp.string("Model")
    if name in HUBBARD_FAMILY:
        from lanczosplusplus_tpu_torch.models.hubbard import HubbardModel
        return HubbardModel(inp, geometry)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"Model={name} is not ported yet (ROADMAP Queue 1 "
            f"{_NOT_PORTED[name]}; factored forms are item 10)")
    raise ValueError(f"unknown Model= {name}")
