"""Built-in post-processing: S(q, omega), N(i, omega), momentum
assembly.

Counterpart of ``lanczosplusplus_tpu/postproc.py``, its host code copied:
``site_resolved_gf``, ``sq_omega``, ``ni_omega``,
``assemble_from_comb_files``, ``extract_orbitals`` and ``dynamics_ft``.
The continued fractions come from the port's Engine (its batched
recurrences run on the Engine's device); their evaluation and the
momentum sums are numpy.  Replaces the reference's Perl pipeline
(scripts/sqomega.pl, scripts/niomega.pl, scripts/dynamicsFt.pl), which
shells out to the lanczos binary and PsimagLite's
continuedFractionCollection evaluator; here everything runs in-process
against an Engine.
"""

from __future__ import annotations

import numpy as np

from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFractionCollection)


def site_resolved_gf(engine, op_name: str, center: int, spin=0,
                     orbs=(0, 0)):
    """G(center, i, omega) continued fractions for every site i
    (the sqomega.pl TSPCenter loop, sqomega.pl:15-33)."""
    n = engine.geometry.number_of_sites()
    pairs = [(center, i) for i in range(n)]
    return [coll for coll, _ in
            engine.spectral_functions_batched(op_name, pairs, spin=spin,
                                              orbs=orbs)]


def sq_omega(engine, op_name: str, omegas, delta, spin=0, orbs=(0, 0),
             center=None):
    """S(q, omega): site-pair spectra Fourier transformed to momentum.

    The engine's off-diagonal collection is the symmetrized
    G_ci + G_ic (Engine 4-type decomposition), so off-center pairs get
    factor 0.5 and the center gets 1.0 — with this weighting the q=0
    channel of an Sz-conserving ground state vanishes exactly.
    (The reference script sqomega.pl:52 uses the inverse convention,
    0.5 at the center, which double counts the off-diagonal pairs
    against its own .comb contents.)  Returns the complex assembled
    G(q, omega); intensity convention -Im/pi is the caller's."""
    n = engine.geometry.number_of_sites()
    if center is None:
        center = n // 2 - 1
    colls = site_resolved_gf(engine, op_name, center, spin, orbs)
    vals = np.array([c.evaluate(omegas, delta) for c in colls])  # (n, nw)
    qs = 2.0 * np.pi * np.arange(n) / n
    out = np.zeros((n, len(omegas)), dtype=np.complex128)
    for m, q in enumerate(qs):
        for i in range(n):
            factor = 1.0 if i == center else 0.5
            out[m] += vals[i] * np.cos(q * (i - center)) * factor
    return qs, out


def ni_omega(engine, omegas, delta, spin=0, orb=0):
    """N(i, omega) = -Im G_c(i, i, omega)/pi for every site
    (reference: niomega.pl:17-53)."""
    n = engine.geometry.number_of_sites()
    pairs = [(i, i) for i in range(n)]
    outs = engine.spectral_functions_batched("c", pairs, spin=spin,
                                             orbs=(orb, orb))
    out = np.zeros((n, len(omegas)))
    for i, (coll, _) in enumerate(outs):
        out[i] = -coll.evaluate(omegas, delta).imag / np.pi
    return out


def assemble_from_comb_files(paths, omegas, delta, center, nsites):
    """File-based S(q, omega) assembly for .comb files written by the
    CLI (the exact sqomega.pl file pipeline)."""
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection

    vals = np.array([read_collection(p).evaluate(omegas, delta)
                     for p in paths])
    qs = 2.0 * np.pi * np.arange(nsites) / nsites
    out = np.zeros((nsites, len(omegas)), dtype=np.complex128)
    for m, q in enumerate(qs):
        for i in range(len(paths)):
            factor = 1.0 if i == center else 0.5
            out[m] += vals[i] * np.cos(q * (i - center)) * factor
    return qs, out


def extract_orbitals(path, orb1, orb2):
    """Slice the (orb1, orb2) block of CFs out of a .comb file using the
    per-CF meta key "spin,type,o1,o2" (the exact extractOrbitals.pl
    selection, extractOrbitals.pl:50-81: keep keys whose orbital pair
    matches in either order)."""
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection

    coll = read_collection(path)
    out = ContinuedFractionCollection()
    for cf in coll.items:
        fields = cf.meta.split(",")
        if len(fields) < 4:
            continue
        o1, o2 = int(fields[2]), int(fields[3])
        if (o1, o2) in ((orb1, orb2), (orb2, orb1)):
            out.push(cf)
    if not out.items:
        raise ValueError(
            f"extract_orbitals: no CF with orbital pair "
            f"({orb1},{orb2}) in {path}")
    return out


def dynamics_ft(paths, nsites, omegas, delta, center=None):
    """Momentum assembly of per-site .comb files (dynamicsFt.pl:79-135):
    for each momentum k_m = 2 pi m / nsites, scale each site file's CF
    weights by e^{i k (site - center)} and sum the evaluated spectra.
    Returns (ks, grid) with grid[m] = Re sum_i e^{ik(i-center)} G_i.
    `center` defaults to the TSPCenter= recorded in each file."""
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection

    colls = []
    centers = []
    for p in paths:
        colls.append(read_collection(p))
        c = center
        with open(p) as f:
            for ln in f:
                if ln.startswith("TSPCenter="):
                    c = int(ln.split("=", 1)[1])
                    break
        if c is None:
            raise ValueError(f"dynamics_ft: no TSPCenter in {p} and no "
                             "center given")
        centers.append(c)
    ks = 2.0 * np.pi * np.arange(nsites) / nsites
    grid = np.zeros((nsites, len(omegas)))
    for m, k in enumerate(ks):
        acc = np.zeros(len(omegas), dtype=np.complex128)
        for site, (coll, c) in enumerate(zip(colls, centers)):
            phase = np.exp(1j * k * (site - c))
            acc += phase * coll.evaluate(omegas, delta)
        grid[m] = acc.real
    return ks, grid
