"""Reduced density matrix / entanglement spectrum of a lattice bipartition.

Counterpart of ``lanczosplusplus_tpu/engine/rdm.py`` (reference:
src/Engine/ReducedDensityMatrix.h): rho_A(alpha, alpha') = sum_beta
conj(psi(alpha, beta)) psi(alpha', beta) for a split at site s (26-131),
with the two-spin-word index unpacking of the Hubbard family (78-123).

Instead of the reference's O(dim^2) double loop, psi is scattered into a
dense (dimA, dimB) matrix M on the state's device and rho = conj(M) . M^T
is one plain matrix product there; the host eigensolves rho for the
entanglement spectrum.
"""

from __future__ import annotations

import numpy as np
import torch


def _unpack_keys(basis, split: int):
    """(alpha, beta) integer keys per basis state + (dimA, dimB), for the
    two-spin-word product bases the port has."""
    if not hasattr(basis, "words_up"):
        raise ValueError("RDM: unsupported basis type")
    idx = np.arange(basis.size)
    up = basis.words_up(idx).astype(np.uint64)
    dn = basis.words_down(idx).astype(np.uint64)
    nabits = split
    nbbits = basis.nsite - split
    maska = np.uint64((1 << nabits) - 1)
    a_up = (up & maska).astype(np.int64)
    a_dn = (dn & maska).astype(np.int64)
    b_up = (up >> np.uint64(nabits)).astype(np.int64)
    b_dn = (dn >> np.uint64(nabits)).astype(np.int64)
    offa = 1 << nabits
    offb = 1 << nbbits
    return (a_up + a_dn * offa, b_up + b_dn * offb,
            offa * offa, offb * offb)


class ReducedDensityMatrix:
    """`psi` is a state over `basis`, a tensor (its device is used) or a
    host array."""

    def __init__(self, basis, psi, split: int):
        a, b, dima, dimb = _unpack_keys(basis, split)
        psi = torch.as_tensor(psi)
        m = torch.zeros((dima, dimb), dtype=psi.dtype, device=psi.device)
        m.index_put_((torch.as_tensor(a, device=psi.device),
                      torch.as_tensor(b, device=psi.device)), psi,
                     accumulate=True)
        self.rho = (m.conj() @ m.T).cpu().numpy()
        self.eigs, self.vectors = np.linalg.eigh(self.rho)

    def entanglement_entropy(self) -> float:
        p = np.clip(self.eigs, 1e-300, None)
        return float(-(p * np.log(p)).sum())

    def print_all(self, os):
        os.write("Reduced Density Matrix\n")
        os.write(str(self.rho) + "\n")
        os.write("Eigenvectors of Reduced Density Matrix\n")
        os.write(str(self.vectors) + "\n")
        os.write("Eigenvalues of Reduced Density Matrix\n")
        os.write(str(self.eigs) + "\n")
