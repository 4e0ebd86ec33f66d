"""The "Rahul method": apply a product of elementary one-bit operators
to a state over the whole Hilbert space.

reference: src/Engine/ModelBase.h:89-141 rahulMethod +
src/Engine/RahulOperator.h.  Elementary operators act on one
(site, spin) bit: identity, n, sz (+-0.5 with the reference's sign
convention: -0.5 when occupied), c (annihilate; transpose=create), with
fermionic parity: a c on the down word crosses all up electrons.

Vectorized: the per-state loop becomes whole-array word updates with an
alive-mask; the final perfectIndex is the basis pair-rank.

Operator-spec mini-language (reference: PsimagLite OneOperatorSpec +
GetBraOrKet, used at Engine.h:208-249):
  "bra|op[site];op[site];...|ket"
where op = name[?dof]['] (apostrophe = transpose) and bra/ket are
"gs" (level 0) or "P<n>" (excited level n).

Counterpart of ``lanczosplusplus_tpu/engine/rahul.py``, host numpy, for
the two-word product bases the port has (Hubbard family); the
combined-word bases come with their models.  The occupation test of the
``c`` operator is written as an exclusive or of boolean arrays: the
``~`` of a Python bool that the JAX package applies there is an integer
inversion, which current numpy refuses to cast back.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from lanczosplusplus_tpu_torch.core import bits
from lanczosplusplus_tpu_torch.core.bits import WORD


@dataclasses.dataclass(frozen=True)
class RahulOperator:
    label: str          # identity | n | sz | c
    dof: int            # spin: 0 up, 1 down
    transpose: bool = False

    @property
    def is_fermionic(self):
        return self.label == "c"


_OP_RE = re.compile(r"^([a-zA-Z]+)(\?(\d+))?(')?$")


def parse_op_token(token: str):
    """'c?1[3]' -> (RahulOperator, site)."""
    site = 0
    m = re.search(r"\[(\d+)\]", token)
    if m:
        site = int(m.group(1))
        token = token[:m.start()] + token[m.end():]
    m = _OP_RE.match(token)
    if not m:
        raise ValueError(f"bad operator token: {token}")
    label = m.group(1)
    dof = int(m.group(3)) if m.group(3) else 0
    transpose = m.group(4) == "'"
    return RahulOperator(label, dof, transpose), site


def parse_braket_level(s: str) -> int:
    """'gs' -> 0, 'P3' -> 3, '2' -> 2 (reference GetBraOrKet)."""
    s = s.strip().strip("<>|")
    if s in ("gs", ""):
        return 0
    if s.startswith("P"):
        return int(s[1:])
    return int(s)


def rahul_apply(basis, ops, sites, psi):
    """psiNew = (op_0 ... op_{n-1}) applied right-to-left to psi."""
    if not hasattr(basis, "words_up"):
        raise NotImplementedError("rahul method needs a two-word basis")
    idx = np.arange(basis.size)
    w1 = basis.words_up(idx).astype(WORD).copy()
    w2 = basis.words_down(idx).astype(WORD).copy()
    value = np.asarray(psi).copy().astype(np.complex128)
    alive = np.ones(basis.size, dtype=bool)

    for op, site in reversed(list(zip(ops, sites))):
        w = w1 if op.dof == 0 else w2
        bit = bits.get_bit(w, site).astype(bool)
        if op.label == "identity":
            res = np.ones(basis.size)
        elif op.label == "n":
            alive &= bit
            res = np.ones(basis.size)
        elif op.label == "sz":
            # reference convention: -0.5 when occupied
            # (RahulOperator.h:41-44)
            res = np.where(bit, -0.5, 0.5)
        elif op.label == "c":
            ok = bit ^ op.transpose   # c needs the bit set, c' empty
            alive &= ok
            res = np.ones(basis.size)
            neww = bits.flip_bit(w, site)
            if op.dof == 0:
                w1 = np.where(alive, neww, w1)
            else:
                w2 = np.where(alive, neww, w2)
        else:
            raise ValueError(f"RahulOperator: unknown label {op.label}")
        if op.is_fermionic:
            sgn = np.ones(basis.size)
            if op.dof == 1:
                sgn = np.where(bits.popcount(w1) & 1, -1.0, 1.0)
            word_now = w1 if op.dof == 0 else w2
            sgn = sgn * bits.parity_sign_below(word_now, site)
            res = res * sgn
        value = value * res

    # scatter back via pair rank
    psi_new = np.zeros(basis.size, dtype=value.dtype)
    tgt = basis.up.rank(w1) + basis.down.rank(w2) * basis.up.size
    np.add.at(psi_new, tgt[alive], value[alive])
    return psi_new
