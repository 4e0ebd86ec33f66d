"""The `lanczos` command line.

Counterpart of ``lanczosplusplus_tpu/cli/lanczos_main.py`` (reference:
src/lanczos.cpp:111-174 getopt loop, and the measurement loop mainLoop3
it calls):

  python -m lanczosplusplus_tpu_torch.cli.lanczos_main -f input.inp
         [-g op] [-c op] [-m spec] [-M spec] [-s "s1,s2"] [-r site]
         [-p precision] [--device cuda|cpu] [--dtype float64|float32]

It prints ``Energy=`` and one ``E[i]=`` line per computed state, runs the
printmatrix/dumpmatrix oracle, and then the measurements: ``-m`` brakets,
``-g`` spectral functions written as ``<input><counter>.comb`` continued
fractions (site pairs from ComputeDensityOfStates=, TSPSites, TSPCenter=,
DoAllPairs=), ``-c`` two-point correlators, ``-r`` the reduced density
matrix and ``-M`` many-point correlators.  The symmetry labels of the
input (UseTranslationSymmetry=1 or 2, UseReflectionSymmetry=1) solve
sector by sector, and every measurement runs on the eigenvector transformed
back to the site basis.  ``--kpm`` and ``--ftlm-dos BETA`` add, for every
diagonal pair of ``-g``, the local density of states by the kernel
polynomial method (``<input><counter>.kpmdos``) and by the FTLM
double-Krylov estimator at inverse temperature BETA
(``<input><counter>.ftlmdos``).  ``--dtype float32`` runs the ground
state, the symmetry sectors, ``-g``, ``-c``, ``--kpm`` and ``--ftlm-dos``
in float32 (complex64 with useComplex or in a momentum sector), the JAX
CLI's precision on its chip, where x64 is off; ``Energy=`` and the
fractions' ``#CFEnergy=`` print the energy refined to the float64 bar, as
the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from lanczosplusplus_tpu_torch import __version__
from lanczosplusplus_tpu_torch.cli import add_dtype_option, real_dtype
from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.rdm import ReducedDensityMatrix
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFractionCollection)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_check import validate_input
from lanczosplusplus_tpu_torch.io_.input_parser import read_input
from lanczosplusplus_tpu_torch.models import build_model

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lanczos++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-p", dest="precision", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda; no card "
                        "is an error, not a CPU run)")
    add_dtype_option(p)
    p.add_argument("-g", dest="gf", action="append", default=[],
                   help="spectral-function operator (c, sz, splus, ...)")
    p.add_argument("-c", dest="cicj", action="append", default=[],
                   help="two-point correlation operator")
    p.add_argument("-m", dest="measure", action="append", default=[],
                   help="bra|op[site];...|ket measurement spec")
    p.add_argument("-M", dest="extended_static", default="",
                   help="many-point spec op?site?spin[?orb];...")
    p.add_argument("-s", dest="spins", default="0,0")
    p.add_argument("-r", dest="split", type=int, default=-1,
                   help="reduced density matrix split site")
    p.add_argument("--ftlm-dos", dest="ftlm_beta", type=float,
                   default=None, metavar="BETA",
                   help="finite-temperature N_i(omega) at inverse "
                        "temperature BETA for diagonal -g spectra via "
                        "the FTLM double-Krylov estimator (labels "
                        "FTLMOmegaBegin/Step/Total, FTLMDelta, "
                        "FTLMVectors, FTLMSteps); writes "
                        "<input><counter>.ftlmdos")
    p.add_argument("--kpm", action="store_true",
                   help="also evaluate diagonal -g spectra by the "
                        "kernel polynomial method on an omega grid "
                        "(labels KPMOmegaBegin/Step/Total, KPMMoments); "
                        "writes <input><counter>.kpmdos")
    p.add_argument("-S", dest="threads", type=int, default=1,
                   help="the reference's thread count: accepted for "
                        "compatibility and ignored (the card sets the "
                        "parallelism)")
    p.add_argument("-V", "--version", action="version", version=__version__)
    return p


def max_orbitals(model, nsites) -> int:
    return max(model.orbitals(s) for s in range(nsites))


def _spectral_pairs(inp, n):
    """(site pairs, TSPCenter or None) the input asks spectral functions
    for (reference: mainLoop3's pair set-up)."""
    pairs = []
    if inp.integer("ComputeDensityOfStates", default=0) > 0:
        pairs += [(i, i) for i in range(n)]
    if inp.has("TSPSites"):
        sites = [int(x) for x in inp.vector("TSPSites")]
        if len(sites) == 1:
            sites.append(sites[0])
        pairs.append((sites[0], sites[1]))
    center = None
    if inp.has("TSPCenter"):
        center = inp.integer("TSPCenter")
        print(f"TSPCenter={center}")
        pairs += [(center, i) for i in range(n)]
    if inp.integer("DoAllPairs", default=0) > 0:
        if center is not None:
            raise SystemExit("cannot have both TSPCenter and DoAllPairs")
        pairs += [(i, j) for i in range(n) for j in range(n)]
    return pairs, center


def _write_local_dos(engine, inp, args, op_name, site, spin, out_base):
    """For a diagonal pair: the KPM density (``--kpm``) into
    ``<out_base>.kpmdos`` and the FTLM one (``--ftlm-dos BETA``) into
    ``<out_base>.ftlmdos``, on the grids of their input labels."""
    if args.kpm:
        begin = inp.real("KPMOmegaBegin", default=-12.0)
        step = inp.real("KPMOmegaStep", default=0.02)
        total = inp.integer("KPMOmegaTotal", default=1201)
        moments = inp.integer("KPMMoments", default=512)
        omegas = begin + step * np.arange(total)
        dos = engine.kpm_local_dos(op_name, site, omegas, spin=spin,
                                   num_moments=moments)
        kout = f"{out_base}.kpmdos"
        with open(kout, "w") as f:
            f.write(f"#KPM site={site} op={op_name} "
                    f"moments={moments}\n#omega N(omega)\n")
            for w, d in zip(omegas, dos):
                f.write(f"{w:.10g} {d:.10g}\n")
        print(f"lanczos_main: Written to {kout}", file=sys.stderr)
    if args.ftlm_beta is not None:
        begin = inp.real("FTLMOmegaBegin", default=-12.0)
        step = inp.real("FTLMOmegaStep", default=0.02)
        total = inp.integer("FTLMOmegaTotal", default=1201)
        delta = inp.real("FTLMDelta", default=0.1)
        omegas = begin + step * np.arange(total)
        dos = engine.ftlm_local_dos(
            op_name, site, args.ftlm_beta, omegas, delta=delta, spin=spin,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=100))
        fout = f"{out_base}.ftlmdos"
        with open(fout, "w") as f:
            f.write(f"#FTLM site={site} op={op_name} "
                    f"beta={args.ftlm_beta} delta={delta}\n"
                    "#omega N(omega)\n")
            for w, d in zip(omegas, dos):
                f.write(f"{w:.10g} {d:.10g}\n")
        print(f"lanczos_main: Written to {fout}", file=sys.stderr)


def _write_spectral(engine, gf_ops, pair_of_sites, center, spins, norb,
                    filename, batch_gf, local_dos):
    """Run every -g operator over the site pairs and write one
    ``<filename><counter>.comb`` per pair.  With more than one pair all
    (pair, type) Lanczos decompositions of one destination sector run as a
    single batched recurrence (``Engine.spectral_functions_batched``);
    SolverOptions=serialgf restores the reference's one run per pair
    (mainLoop3's loop over pairs).  ``local_dos(op_name, site, spin,
    out_base)`` runs after each diagonal pair's file."""
    for op_name in gf_ops:
        batched = {}
        if batch_gf and spins[0] == spins[1]:
            for orb1 in range(norb):
                for orb2 in range(orb1, norb):
                    batched[(orb1, orb2)] = engine.spectral_functions_batched(
                        op_name, pair_of_sites, spin=spins[0],
                        orbs=(orb1, orb2))
        for counter, (site0, site1) in enumerate(pair_of_sites):
            print(f"#gf(i={site0}, j={site1})")
            all_cf = ContinuedFractionCollection()
            labels = []
            for orb1 in range(norb):
                for orb2 in range(orb1, norb):
                    if spins[0] != spins[1]:
                        raise SystemExit(
                            "spectralFunction: off-diagonal spin "
                            "unsupported")
                    if (orb1, orb2) in batched:
                        coll, lab = batched[(orb1, orb2)][counter]
                    else:
                        coll, lab = engine.spectral_function(
                            op_name, site0, site1, spin=spins[0],
                            orbs=(orb1, orb2))
                    all_cf.items += coll.items
                    labels += lab
            out = f"{filename}{counter}.comb"
            with open(out, "w") as f:
                f.write(f"Site0={site0}\nSite1={site1}\n")
                if center is not None:
                    f.write(f"TSPCenter={center}\n")
                all_cf.write(f, index_to_cf=labels)
            print(f"lanczos_main: Written to {out}", file=sys.stderr)
            if site0 == site1:
                local_dos(op_name, site0, spins[0], f"{filename}{counter}")


def run(argv=None):
    """Parse, validate, diagonalize, measure and print; returns the
    Engine."""
    args = _parser().parse_args(argv)

    np.set_printoptions(precision=args.precision)
    inp = read_input(args.input)
    validate_input(inp)
    config = Config.from_input(inp, device=args.device,
                               real_dtype=real_dtype(args))
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    engine = Engine(model, inp, config=config)

    solver_opts = inp.solver_options()
    if {"printmatrix", "dumpmatrix"} & solver_opts:
        # debug oracle path (reference: DefaultSymmetry.h:61-94): print
        # the dense Hamiltonian, assert hermiticity, full-diagonalize
        ham = engine.hamiltonian
        if ham.dim <= 4900:
            dense = ham.to_dense()
            herm = np.abs(dense - dense.T.conj()).max()
            if herm > 1e-9:
                raise SystemExit(f"matrix is not hermitian: {herm}")
            if "printmatrix" in solver_opts and ham.dim <= 40:
                print(dense)
            evals = np.linalg.eigvalsh(dense)
            print("#FullSpectrum")
            for e in evals:
                print(e)
        else:
            print("printmatrix too big", file=sys.stderr)

    prec = args.precision
    print(f"Energy={engine.ground_energy:.{prec}g}")
    for i in range(len(engine._energies)):
        v = engine.eigenvector(i)
        norm = torch.vdot(v, v).real.item()
        print(f"E[{i}]={engine.energies(i):.{prec}g} norm={norm:.{prec}g}")

    spins = tuple(int(x) for x in args.spins.split(","))
    if len(spins) == 1:
        spins = (spins[0], spins[0])

    for spec in args.measure:
        for token in spec.split(","):
            val = engine.measure(token)
            parts = token.split("|")
            print(f"{parts[0]}|{parts[1]}|{parts[2]} = {val}")

    n = geometry.number_of_sites()
    gf_ops = list(args.gf)
    if inp.integer("ComputeDensityOfStates", default=0) > 0:
        gf_ops.append("c")
    pair_of_sites, center = _spectral_pairs(inp, n)
    if gf_ops and not pair_of_sites:
        print("lanczos_main: -g given but no TSPSites/TSPCenter/"
              "DoAllPairs in the input; no spectral pairs to run",
              file=sys.stderr)
    norb = max_orbitals(model, n)
    _write_spectral(engine, gf_ops, pair_of_sites, center, spins, norb,
                    os.path.basename(args.input),
                    len(pair_of_sites) > 1 and "serialgf" not in solver_opts,
                    lambda *job: _write_local_dos(engine, inp, args, *job))

    for op_name in args.cicj:
        for orb1 in range(norb):
            for orb2 in range(norb):
                mat = engine.two_point(op_name, spin=spins,
                                       orbs=(orb1, orb2))
                if mat is None:
                    continue
                print(np.array_str(np.real_if_close(mat)))

    if args.split >= 0:
        rdm = ReducedDensityMatrix(engine.basis, engine.eigenvector(0),
                                   args.split)
        rdm.print_all(sys.stdout)
        print(f"EntanglementEntropy={rdm.entanglement_entropy():.10g}")

    if args.extended_static:
        for spec in args.extended_static.split(","):
            tokens = spec.split(";")
            sites, spins_l, orbs, names = [], [], [], []
            for t in tokens:
                f = t.split("?")
                if len(f) < 3:
                    raise SystemExit("-M option malformed")
                names.append(f[0])
                sites.append(int(f[1]))
                spins_l.append(int(f[2]))
                orbs.append(int(f[3]) if len(f) == 4 else 0)
            val = engine.many_point(sites, names, spins_l, orbs)
            print(f"<gs|{spec}|gs>={val}")

    return engine


def main():
    run()


if __name__ == "__main__":
    main()
