"""Labeled operator algebra (reference: src/Engine/LabeledOperator.h).

Counterpart of ``lanczosplusplus_tpu/engine/operators.py``, pure Python.

Operators: c, cdagger, n, sz, splus, sminus, nil, cdagger_a_up_c_b_up.
c/cdagger/splus/sminus map between symmetry sectors (needsNewBasis);
c/cdagger are fermionic (Green's functions carry Jordan-Wigner signs).
"""

from __future__ import annotations

import dataclasses

NIL = "nil"
C = "c"
CDAGGER = "cdagger"
N = "n"
SZ = "sz"
SPLUS = "splus"
SMINUS = "sminus"
CDAGGER_A_UP_C_B_UP = "cdagger_a_up_c_b_up"

_KNOWN = {NIL, C, CDAGGER, N, SZ, SPLUS, SMINUS, CDAGGER_A_UP_C_B_UP}

_TRANSPOSE = {C: CDAGGER, CDAGGER: C, SPLUS: SMINUS, SMINUS: SPLUS}


@dataclasses.dataclass(frozen=True)
class LabeledOperator:
    name: str

    def __post_init__(self):
        if self.name not in _KNOWN:
            raise ValueError(f"unsupported operator {self.name}")

    @property
    def needs_new_basis(self) -> bool:
        return self.name in (C, CDAGGER, SPLUS, SMINUS)

    @property
    def is_fermionic(self) -> bool:
        return self.name in (C, CDAGGER)

    def transpose_conjugate(self) -> "LabeledOperator":
        return LabeledOperator(_TRANSPOSE.get(self.name, self.name))

    @property
    def number_of_types(self) -> int:
        # the 4-term continued-fraction decomposition
        # (reference: LabeledOperator.h:78-81)
        return 4

    def __str__(self):
        return self.name
