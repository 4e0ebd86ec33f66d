#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lanczosplusplus_tpu_torch) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one line with its numbers:

1. environment: the card, its power limit, torch and CUDA versions;
2. build: the three hand-written CUDA kernels compiled from csrc/, with
   each kernel's registers, shared memory and spills (which must be 0, for
   the complex, float32 and bf16-source instantiations of ell_spmv and
   perm_gather and the float32 and bf16 factor_matmul too) and the counts
   of FP64 and warpgroup bf16 tensor-core instructions (DMMA, HGMMA) in
   the machine code;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (TF32 off): factor_matmul at 3432^3 (14 sites) and
   924^3 (12 sites) in float64, each also in its transposed accumulate
   form, at 3432^3 and 924^3 in float32 (both forms too), and a ragged
   300x257 . 123x257 whose odd pitch takes one-element copies; the
   batched forms of the spectral
   path, a block of 14 states of the 14-site N_up = 8 sector (3432 x 3003
   each) and a block of 23 of the 12-site N_up = 7 sector (924 x 792
   each, the TSPCenter fleet's): the up product with the batch folded
   into its rows and the dn product over the transposed views in one
   launch, and a ragged batch of 3; ell_spmv (through the sliced form
   of each matrix, made outside the timed region, its bytes and seconds
   printed and its plain version held against the padded one's) on the
   12-site SuperHubbardExtended J-ELL for one vector and for a block of
   14, on
   the N_up = 7 sector's J-ELL for the fleet's block of 23, and on a
   random ELL with dim 1 000 003, K 7, for one vector and a block of 14,
   and on a random one with K 17, just past the rows a thread keeps in
   registers; factor_matmul at the FeAs sector's 1820^3 in both forms,
   and a complex state (its real and imaginary planes through the real
   kernel) against torch.matmul on the complex tensors, at 1820^2 and at
   TestSuite input100's 220^2, with a real and with a complex factor.
   A batch of one must give the unbatched result bit for bit.  Each case
   is timed beside its bound (the least time the card could take:
   operations over 67 TFLOP/s or bytes over 3.35 TB/s; for ell_spmv the
   bytes of its nonzero entries and vectors, the padded form's bytes kept
   beside them) and beside one
   library call for the same function (in the turns library, kernel,
   kernel, library), which the port itself never calls: torch.matmul /
   addmm_ for factor_matmul, and for ell_spmv (and perm_gather, phase 10)
   the operator as a CSR matrix, diagonal folded in, applied by
   ``csr @ x`` (cuSPARSE), built outside the timed region.  The times are
   the card's
   alone: the host queues the work while the card still spins on an
   earlier kernel (median_ms); "from an idle card" is the same launch
   with the host's way to it included;
4-6. the main path through the port's own entry points, with the kernel
   launch counts set to 0 before and read after: input0 through the CLI
   (dense branch), the 14-site half-filled Hubbard chain (dim 11 778 624)
   at U=0 against the free-fermion energy and at U=4, and the 12-site
   SuperHubbardExtended chain (dim 853 776);
7. the U=4 and SuperHubbardExtended solves again with the plain versions
   from the same start vector, and the 14-site matvec timed both ways;
8. the spectral slice through the CLI, launch counts set to 0 before each
   run and read after: the local density of states of all 14 sites of the
   14-site chain (ComputeDensityOfStates=1: two batched recurrences of 14
   rows in the N_up = 8 and 6 sectors, dim 10 306 296), at U=0 against
   the one-particle levels of the hopping matrix (poles and weights) and
   at U=4 against the sum rules, against the same recurrences through the
   plain versions and against the serial spectral_function of site 0; a
   TSPCenter fleet of the 12-site SuperHubbardExtended chain, which takes
   the batched ell_spmv, its two recurrences of 23 rows again through the
   plain versions from the same start vectors; and two_point on the card
   against the CPU;
9. the flat models at full width, each through the Engine or the CLI on
   the card with the launch counts set to 0 before and read after, the
   host's build of the (dim, K) arrays timed apart from the solve, E0
   through the kernels against E0 through the plain versions from the
   same start vector, and ell_spmv held against its plain version on the
   model's own arrays (one vector and a block of 14): the 12-site
   Heisenberg ring at its Bethe-ansatz energy and the 24-site ring (dim
   2 704 156, K = 48); the 18-site t-J ring with 8 up and 8 down (dim
   1 969 110) and the 8-site ring's G_00(omega) through -g against
   benchmarks/goldens.json; TestSuite input10 and a 12-site Rashba ring
   with 12 electrons, U = 4 and a complex Rashba amplitude (dim
   2 704 156, K = 96, complex128); TestSuite input100 and input104 as
   they are (useComplex: both kernels in their complex forms) and the
   8-site two-orbital FeAs sector with 4 up and 4 down (dim 3 312 400,
   two 1820^2 factors plus the interaction ELL).
10. the factored forms and the one-spin gather apply at full width
   (``factored_phase``), each run with the launch counts set to 0 before
   and read after and held against the form's count a matvec: the 14-site
   U=4 sector with both one-spin factors in gather form (its E0 against
   phase 5's; a matvec timed in both forms; perm_gather in the up and dn
   forms at R = 1 and 14 against its plain version, bit for bit, and
   cuSPARSE; perm_gather carries P (b, r) pairs a thread, their sums in
   registers, and reads a column's tables once for all P), the
   20-site chain with 10 up and 2 down electrons (dim 35 103 640, the
   184 756^2 up factor in gather form beside the dense 190^2 dn one; U=0
   against free fermions, U=4 against the plain versions), and under
   SolverOptions=factored, each against its flat form's E0 (phase 9's
   where phase 9 solved it) with the factored build timed apart from the
   solve: the 18-site t-J ring through the CLI (its largest cross term
   through perm_gather, bit for bit, as every form's largest cross term
   below, its largest tier through factor_matmul with a
   factor per block), the 24-site Heisenberg ring (its eigenvector against
   phase 9's, its largest block's product), the 12-site complex Rashba
   ring (a complex128 cross term) and bench.py's 13-site real one (against
   the plain versions; a matvec in block order timed beside the flat-order
   wrap, which the solve does not take), the Kitaev ring at 16 sites against its flat form
   and at 24 (dim 16 777 216) against the plain versions (its 4096^3 half
   product), the 8-site FeAs sector's single block, a 7-site FeAs
   spin-orbit chain with 7 electrons (dim 1 184 040) and the 8-site t-J
   ring's G_00(omega) through -g against goldens.json and phase 9's.
11. the symmetry sectors (``symmetry_phase``), each symmetric run through
   the CLI on the card with the launch counts set to 0 before and read
   after, its symmetry set-up, block builds and block solves timed apart
   from the Engine's log, one line a block (dim, type, ELL K against the
   mean entries a row, build s, Lanczos steps, solve s), and every block
   matvec one ell_spmv launch: the 12-site half-filled U=4 chain with
   UseTranslationSymmetry=1 (12 momentum blocks, most of them complex128)
   against its E0 without symmetry, its transformed eigenvector's
   residual on that Hamiltonian (phase 15 runs the 14-site chain's 14
   blocks, in float32); the 14-site open (4, 4) chain with
   UseReflectionSymmetry=1 (two float64 parity blocks) and the 12-site
   (3, 3) 2-leg ladder with UseTranslationSymmetry=2 against their E0s
   without symmetry; the 22-site Kitaev ring with UseTranslationSymmetry=1,
   which takes the projected path on the card (12 momentum sectors of the
   full 2^22 space, factor_matmul on the 2048^2 halves), each k's E0 and
   bench.py's sym_* fields, against the factored solve's E0 with its
   purity; then ell_spmv on the larger parity block at R = 1 and 14
   (phase 15 times the 14-site chain's largest complex128 momentum block),
   and factor_matmul on the 22-site Kitaev half, each against its plain
   version and beside cuSPARSE or cuBLAS.
12. the estimators and their command lines (``estimator_phase``), each
   case through its CLI's run() on the card with the launch counts set to
   0 before and read after: ed --ftlm on the 14-site half-filled U=4 chain
   (R = 16, 80 steps, 8 betas from 0.1 to 20), its e0_estimate against
   phase 5's E0 and its energies against the same card-drawn block
   through the plain versions; ed --ltlm on the same sector (R = 4), at
   beta 500 within its Ritz residual's bound of phase 5's E0; lanczos -g
   c --kpm on the same sector (512 moments in the two destination sectors
   of dim 10 306 296), the moments against those of -g's Lanczos
   tridiagonal of the same start vector and against the plain versions;
   ed --ftlm under SolverOptions=factored on the 18-site t-J ring (the
   inner-order branch, perm_gather at R = 16) against the flat form from
   the same block, with its idle share; lanczos -g c --ftlm-dos 2.0 on the
   12-site SuperHubbardExtended chain (R = 8, 100 steps) against the plain
   versions, and at beta 40 against -g's continued fraction (the exact
   sum rule of its poles); thermal
   (full spectra and --ftlm), sqomega, dynamics1, qpz and lorentzian at
   small sizes against the port's own CPU runs; then factor_matmul's
   batched forms, ell_spmv and perm_gather at the estimators' R = 16.
13. the last command lines and input forms and the native host runtime
   (``cli_phase``), each run with the launch counts set to 0 before and
   read after: consistency --tinf on phase 5's 14-site chain and phase
   9's 24-site Heisenberg ring (E0 against those phases', the T=inf
   energy against its closed form) and on the 16-site ring in the dense
   branch on the card; spin_orbital_main 6 1 and 4 against their CPU
   runs; the Ainur form of phase 5's input through lanczos -f; the
   6-site Hubbard chain's sector files written on the card and on the
   CPU; the native host runtime (native/lanczos_native.cpp, built with
   g++ at first use; the script fails without it) against the numpy
   paths on phase 10's 20-site sector and C(24, 12), bit for bit and
   timed; and phase 12b's LTLM with its peak device memory beside its
   reckoning, against the plain versions.  ell_spmv is held against its
   plain version on the 16-site ring's and the 7-site spin-orbital
   chain's ELLs.
14. float32 and complex64 solves with their float64 refinement, the bf16
   forms and the low-precision, resumable Krylov basis
   (``lowprec_phase``), each solve with the launch counts, by kernel and
   by form, set to 0 before and read after: lanczos -f --dtype float32
   on phase 5's chain and phase 6's SuperHubbardExtended chain in float32
   (refined E0 against theirs, 1e-10); SolverOptions=factored,bf16cross
   on bench.py's 13-site Rashba ring at float64 and float32 (bf16-source
   perm_gather, full reorthogonalization, 1e-8 absolute against phase
   10); phase 10's 18-site t-J form in float32 and 12-site complex Rashba
   form in complex64 (1e-10); phase 11's 22-site Kitaev ring with bf16
   factors from build_factored_kitaev(factor_dtype=torch.bfloat16) (the
   matvec within 2e-2 of the float32 form's, its refined E0 beside the
   float64 one); a bf16 Krylov basis (Ritz value within 2e-3) and a
   checkpointed run stopped after two chunks and resumed (bit-equal);
   phase 5's chain with bf16 dense factors from
   densify_factors(factor_dtype=torch.bfloat16) under a float32 and a
   float64 state (the matvec within 1e-2 of the unquantized form's, the
   refined E0 against phase 5's, 1e-10); the float32 chain's unrefined
   E0 and first Lanczos coefficients are printed, and the bf16 runs
   (14e, 14h) must repack no operand for TMA; then each new kernel form
   alone against its plain version and one library call: the bf16
   factor_matmul at 3432^3 into float32 and float64, 4096^3 and the
   Kitaev half (bound at 989 TFLOP/s dense bf16), the float32 t-J
   form's largest tier, the float32 J-ELL,
   perm_gather in float32 and complex64 (the 14-site one-spin up form,
   the 8-site FeAs term, the path's cross terms) and from a bf16 source
   into float32 and float64 sums.
15. float32 and complex64 on the paths the JAX package runs below float64
   on its chip (``float32_paths_phase``), each run with the launch counts,
   by form, set to 0 before and read after, its wall time and peak device
   memory beside its float64 counterpart's: lanczos --dtype float32 -g c
   on phase 8's 14-site DOS fleet at U=4 (#CFEnergy= the refined E0 to
   1e-10) and at U=0 (the one-particle levels); phase 8's 12-site
   TSPCenter fleet in float32 (ell_spmv f32 at R = 23); both U=4 fleets'
   densities printed against phase 8's and against the float64 recurrence
   from the run's own start rows beside the 2e-3 bar, their first 5
   coefficients against that recurrence's beside the 1e-5 bar; --kpm on
   the 14-site chain against phase 12c's moments, --ftlm-dos 2.0 at R =
   16 against the same block in float64, the batched FTLM recurrence on
   the 14-site form at R = 16 in both types, sqomega against phase 12f's;
   the 14-site chain's 14 momentum blocks in float32 (12 complex64, each
   refined against its float64 block) against phase 5's E0 and
   Hamiltonian, the 14-site open chain's parity blocks and the 22-site
   Kitaev ring by projection against phase 11's E0s, each k's; then the
   float32 batched factor_matmul at pitch 3003 (R = 14) and 3432 (R = 16),
   ell_spmv f32 at R = 23, c128 and c64 on the largest momentum block and
   f32 on the larger parity block at R = 1 and 14, and the f32 factor_matmul on
   the Kitaev half, each against its plain version, its bound and one
   library call.

16. distribution (``distributed_phase``, ``parallel/``), each run with the
   launch counts, by form, set to 0 before and read after: 16a world 1 on
   NCCL in this process (a one-rank group from a file store): the dry run
   of every path (``parallel.dryrun``), phase 5's 14-site U=4 sector
   solved in the Kronecker and halo-Kronecker forms against phase 5's E0
   (1e-12; bit-equal or not is printed), distributed_ftlm at R = 16 and 80
   steps against the single-process ftlm from the same block (1e-8), and
   ell_spmv with a longer source (the gathered state) on the 12-site
   SuperHubbardExtended flat form's row shards, one rank's of one and of
   4, against its plain version, its bound and cuSPARSE; 16b 4 gloo ranks
   spawned on the one card (their CUDA tensors passed to gloo as they
   are), which check that gloo's all_gather and all_to_all_single return
   every type of state exactly at the 12-site sector's size, run the dry
   run and, on DIST_SECTORS (phase 6's sector, an 11-site
   sector with 5 up and 3 down whose flat dimension and size_down pad, a
   14-site t-J ring in factored form), every form's matvec (1e-12 of max
   |y|) and solve (E0 1e-10) against this process's, the estimators
   against this process's from the same blocks, and a scatter plan; their
   times are of 4 processes sharing one card, not a speed.  The
   single-device references a run is held against (the dry run's among
   them) and the timing of a kernel alone go uncounted
   (``kernels.uncounted``).

Every check raises on failure, so the exit code is non-zero.  Without a
card, or without the package beside this script, it exits non-zero and
prints no result.  The last lines are a JSON object with the native host
runtime's numbers, a JSON object with the kernels' numbers (one entry for
each kernel and form of a path, with the launches that path counted:
ground state, spectral, the flat models' forms of phase 9, the factored
forms' and gather apply's of phase 10, the symmetry blocks' and projected
translation's of phase 11, the estimators' of phase 12, phase 13's and,
by form, phase 14's, phase 15's and phase 16's),
the card's name and power limit, and the result object.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SEED = 7239443
TOL_F64 = 1e-12       # factor_matmul float64, relative to max|y|
TOL_F32 = 1e-5        # float32 kernels, relative to max|y|
TOL_ELL_F64 = 1e-13   # ell_spmv float64, relative to max|y|
TOL_E0 = 1e-10        # relative energy agreement
PEAK_FLOPS = 67e12    # H100 SXM data sheet: FP64 tensor cores, and float32
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet: dense bf16 tensor cores
# bf16 factor_matmul: exact products, float32 sums in another order than
# the plain version's, relative to max|y| at k up to 4096
TOL_BF16 = 1e-4
PEAK_BYTES = 3.35e12  # H100 SXM data sheet: device memory bytes per second
SPIN_CYCLES = 2_000_000  # about 1.1 ms at the H100's 1.75 GHz
E0_INPUT0 = -4.472135954999581  # benchmarks/goldens.json e0_input0
E0_INPUT10 = -12.94427190999916    # e0_input10
E0_INPUT100 = -3.0994640142192615  # e0_input100 (dim 48 400)
E0_INPUT104 = 4.20553470700647     # e0_input104
E0_HEISENBERG12 = -5.387390917445208  # 12-site S = 1/2 ring (Bethe ansatz
#                                       to its 8 printed digits: -5.3873909)
# the FeAs spin-orbit sector of phase 10: sites, up, down (the sector is
# the total count, 7 electrons on 7 sites, dim 1 184 040); its flat form
# is built beside it
FEAS_SO_SECTOR = (7, 4, 3)

INPUT0 = """
TotalNumberOfSites=4
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 4 0 0 0 0
potentialV 8 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=0
"""


def hubbard_chain_text(nsite: int, u: float, nup: int | None = None,
                       ndown: int | None = None, periodic: int = 1,
                       ladder: bool = False, extra: str = "") -> str:
    """One-band Hubbard chain (or 2-leg ladder), t = -1, uniform U, no
    potential, periodic unless `periodic` is 0, half filled unless `nup`
    and `ndown` say otherwise; `extra` is appended.  Translation (when
    periodic) and reflection both commute with it."""
    nup = nsite // 2 if nup is None else nup
    ndown = nsite // 2 if ndown is None else ndown
    geometry = ("GeometryKind=ladder\nLadderLeg=2\n"
                "GeometryOptions=ConstantValues\nConnectors 2 -1.0 -1.0"
                if ladder else "GeometryKind=chain\n"
                "GeometryOptions=ConstantValues\nConnectors 1 -1.0")
    return f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
{geometry}
Model=HubbardOneBand
hubbardU {nsite} {" ".join([str(u)] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nup}
TargetElectronsDown={ndown}
IsPeriodicX={periodic}
{extra}"""


def super_hubbard_text(nsite: int) -> str:
    """Half-filled periodic SuperHubbardExtended chain with hopping,
    n_i n_j and J terms."""
    term = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 {}\n")
    pot = [0.1, -0.2, 0.3] + [0.0] * (2 * nsite - 3)
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + term.format(-1.0) + term.format(0.7) + term.format(1.3)
            + f"Model=SuperHubbardExtended\n"
              f"hubbardU {nsite} {' '.join(['2'] * nsite)}\n"
              f"potentialV {2 * nsite} {' '.join(map(str, pot))}\n"
              f"SolverOptions=none\nTargetElectronsUp={nsite // 2}\n"
              f"TargetElectronsDown={nsite // 2}\nIsPeriodicX=1\n")


def _term(value) -> str:
    return ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            f"GeometryOptions=ConstantValues\nConnectors 1 {value}\n")


def heisenberg_ring_text(nsite: int) -> str:
    """S = 1/2 Heisenberg ring, J_pm = J_zz = 1, Sz = 0."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + _term(1.0) + _term(1.0)
            + f"Model=Heisenberg\nHeisenbergTwiceS=1\nSolverOptions=none\n"
              f"TargetSzPlusConst={nsite // 2}\nIsPeriodicX=1\n")


def tj_ring_text(nsite: int, nup: int, ndown: int) -> str:
    """t-J ring, t = -1, J_pm = J_zz = 0.3, no n_i n_j term."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + _term(-1.0) + _term(0.3) + _term(0.3) + _term(0.0)
            + f"Model=TjMultiOrb\nOrbitals=1\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndown}\n"
              "IsPeriodicX=1\n")


def rashba_ring_text(nsite: int, ne: int, amplitude: str = "(0.3,0.4)",
                     options: str = "useComplex") -> str:
    """Hubbard ring with Rashba spin-orbit coupling, t = -1, U = 4, by
    default a complex Rashba amplitude 0.3 + 0.4i (modulus 0.5) in
    complex128; bench.py's ring has the real amplitude 0.5."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + _term(-1.0) + _term(amplitude)
            + "Model=HubbardOneBandRashbaSOC\n"
              f"hubbardU {nsite} {' '.join(['4'] * nsite)}\n"
              f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
              f"SolverOptions={options}\nTargetElectronsTotal={ne}\n"
              "IsPeriodicX=1\n")


def feas_ring_text(nsite: int, nup: int, ndown: int) -> str:
    """Two-orbital FeAs ring, INT_PAPER33 interactions."""
    return (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedSc\n"
            "FeAsMode=INT_PAPER33\nNumberOfTerms=1\nDegreesOfFreedom=2\n"
            "Orbitals=2\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nSolverOptions=none\n"
            "hubbardU 4 4.0 3.0 -0.8 -0.4\nConnectors 2 2\n-1.0 0.0\n"
            f"0.0 -1.0\npotentialV {4 * nsite} "
            f"{' '.join(['0'] * 4 * nsite)}\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndown}\nIsPeriodicX=1\n")


def kitaev_ring_text(nsite: int) -> str:
    """Kitaev ring of bench.py: J_x, J_y, J_z = 1.1, 0.7, 0.9."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + _term(1.1) + _term(0.7) + _term(0.9)
            + "Model=Kitaev\nSolverOptions=none\nIsPeriodicX=1\n")


FEAS_SO = [0.3, 0.1, 0.1, -0.3, 0.2, 0.05, 0.07, -0.2,
           0.2, 0.07, 0.05, -0.2, -0.3, 0.1, 0.1, 0.3]


def feas_spinorbit_chain_text(nsite: int, nup: int, ndown: int) -> str:
    """Open two-orbital FeAs chain (INT_PAPER33) with a 4 x 4 spin-orbit
    matrix, the shape of the port's spin-orbit tests: complex128, the
    sector is the total electron count."""
    n2 = 4 * nsite
    so = "\n".join(" ".join(map(str, FEAS_SO[4 * r:4 * r + 4]))
                   for r in range(4))
    return (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedSc\n"
            "FeAsMode=INT_PAPER33\nNumberOfTerms=1\nDegreesOfFreedom=2\n"
            "Orbitals=2\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nSolverOptions=none\n"
            "hubbardU 4 1.0 0.5 -0.2 -0.1\nConnectors 2 2\n-1.0 0.2\n"
            f"0.2 -0.7\npotentialV {n2}\n{' '.join(['0'] * n2)}\n"
            f"SpinOrbit 4 4\n{so}\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndown}\nIsPeriodicX=0\n")


def factored(text: str) -> str:
    """The same input under SolverOptions=factored."""
    return text.replace("SolverOptions=none", "SolverOptions=factored") \
        .replace("SolverOptions=useComplex",
                 "SolverOptions=useComplex,factored")


INPUT10 = (
    "TotalNumberOfSites=4\nNumberOfTerms=2\n" + _term(-1) + _term(7.0)
    + "Model=HubbardOneBandRashbaSOC\nhubbardU 4 0 0 0 0\n"
      "potentialV 8 0 0 0 0 0 0 0 0\nSolverOptions=useComplex\n"
      "TargetElectronsTotal=1\nIsPeriodicX=0\n")

INPUT100 = """
TotalNumberOfSites=6
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom=2
Orbitals=2
GeometryKind=chain
GeometryOptions=ConstantValues
SolverOptions=useComplex
hubbardU 4 4.0 3.0 -0.8 -0.4
Connectors 2 2
-1.0 0.0
0.0 -1.0
potentialV 24
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
TargetElectronsUp=3
TargetElectronsDown=3
"""

INPUT104 = INPUT100.replace("TargetElectronsDown=3\n",
                            "TargetElectronsDown=3\nAnisotropyD=7\n")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, ahead: bool = True) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events,
    after one warm-up run.  With `ahead`, the card is first given about a
    millisecond of spinning, so the host has queued all of fn()'s work
    before the card reaches the first event and the time between the
    events is the card's alone.  Without it the card starts idle, and the
    time includes the host's way from the first event to the launch.
    The spin is ``torch.cuda._sleep``, a private function of PyTorch that
    its own tests use; there is no public one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        if ahead:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    abs_err = (got - ref).abs().max().item()
    return abs_err, abs_err / ref.abs().max().item()


@contextlib.contextmanager
def plain_kernels():
    """Within this block every kernel wrapper of ``ops/kernels`` is its
    plain PyTorch version, on any device: the reference a factored form's
    kernel path is held against on the card (the forms call the wrappers
    through the module).  No kernel launches in it."""
    from lanczosplusplus_tpu_torch.ops import kernels as K
    saved = K.factor_matmul, K.ell_spmv, K.perm_gather

    def factor_matmul(x, a, out=None, accumulate=False):
        y = K.factor_matmul_ref(x, a)
        if out is None:
            return y
        if accumulate:
            out += y
        else:
            out.copy_(y)
        return out

    def ell_spmv(diag, cols, vals, x, sliced=None, src=None):
        return K.ell_spmv_ref(diag, cols, vals, x, src)
    K.factor_matmul, K.ell_spmv, K.perm_gather = (
        factor_matmul, ell_spmv, K.perm_gather_ref)
    try:
        yield
    finally:
        K.factor_matmul, K.ell_spmv, K.perm_gather = saved


class PlainForm:
    """Any of the port's operators (a sector Hamiltonian in either
    one-spin form, a block-Kronecker form, the factored Kitaev form)
    applied with the plain versions of the kernels."""

    def __init__(self, ham):
        self.ham = ham
        self.dim, self.dtype, self.device = ham.dim, ham.dtype, ham.device

    def matmat_t(self, xk):
        with plain_kernels():
            return self.ham.matmat_t(xk)

    matvec = matmat_t


class CheckedOperator(PlainForm):
    """Applies through the kernels and, to the same block, through the
    plain versions, keeps the worst difference (of max |y|) and hands on
    the kernels' result: every apply of a recurrence is held at the very
    inputs the recurrence gives the kernels."""

    worst = 0.0

    def matmat_t(self, xk):
        y = self.ham.matmat_t(xk)
        self.worst = max(self.worst,
                         rel_err(y, PlainForm.matmat_t(self, xk))[1])
        return y


def spectral_density(coll, omegas, delta):
    """-Im G(omega + i delta) / pi of a continued-fraction collection."""
    return -coll.evaluate(omegas, delta).imag / np.pi


def recurrence_both_ways(lz, K, ham, v0s, steps):
    """tridiagonalize_plain_batched from the rows of `v0s`, in the turns
    plain and kernel, and then 20 steps with every apply done
    both ways on the same block: (results through the kernels, results
    through the plain versions, wall seconds by path, worst difference of
    one apply of max |y|).  A plain turn must launch no kernel, a kernel
    turn one batched launch a step of each factor_matmul form and, where
    the operator has an ELL part, of ell_spmv."""
    results, walls = {}, {"kernel": [], "plain": []}
    both = CheckedOperator(ham)
    for label in ("plain", "kernel", "both"):
        op = {"kernel": ham, "plain": PlainForm(ham), "both": both}[label]
        count = steps if label != "both" else min(steps, 20)
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[label] = lz.tridiagonalize_plain_batched(op, v0s, count)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append(time.perf_counter() - t)
        went = {n: K.LAUNCHES[n] - before[n] for n in before}
        expect = {"factor_matmul": 2 * count,
                  "ell_spmv": count if ham.ell is not None else 0,
                  "perm_gather": 0}
        check(went == (dict.fromkeys(went, 0) if label == "plain" else expect),
              f"a {label} recurrence of {count} steps launched {went}")
    return results["kernel"], results["plain"], walls, both.worst


def fractions_differ(triples, omegas, lead, cli_lead):
    """Over (kernel result, plain result, the CLI's fraction of that
    row) triples: (max difference of the first `lead` alphas and betas
    between the two results, of their maximum; max difference of
    -Im G(omega + i delta) / pi of its maximum, by delta, for delta 1 and
    0.1; max absolute difference of the CLI's first `cli_lead` coefficients
    from the kernel result's)."""
    from lanczosplusplus_tpu_torch.engine.spectral import (
        ContinuedFraction, ContinuedFractionCollection)
    coef_err = cli_err = 0.0
    fn_err = {1.0: 0.0, 0.1: 0.0}
    for rk, rp, cf in triples:
        check(rk.m == rp.m == len(cf.alphas),
              f"{cf.meta}: steps kept {rk.m}, {rp.m}, {len(cf.alphas)}")
        for a, b in ((rk.alphas, rp.alphas), (rk.betas, rp.betas)):
            coef_err = max(coef_err, np.abs(a[:lead] - b[:lead]).max()
                           / np.abs(b[:lead]).max())
        for a, b in ((cf.alphas, rk.alphas), (cf.betas, rk.betas)):
            cli_err = max(cli_err, np.abs(a[:cli_lead] - b[:cli_lead]).max())
        colls = []
        for r in (rk, rp):
            colls.append(ContinuedFractionCollection())
            colls[-1].push(ContinuedFraction(
                alphas=r.alphas, betas=r.betas, e0=cf.e0, weight=cf.weight,
                sigma=cf.sigma))
        for delta in fn_err:
            got, ref = (spectral_density(c, omegas, delta) for c in colls)
            fn_err[delta] = max(fn_err[delta], np.abs(got - ref).max()
                                / np.abs(ref).max())
    return coef_err, fn_err, cli_err


def run_cli(lanczos_main, text, args=()):
    """The port's CLI on an input text, on the card, in a directory of its
    own: (engine, stdout, stderr, the .comb collections it wrote in pair
    order, wall seconds)."""
    engine, out, err, files, wall = run_tool(lanczos_main, text,
                                             ["-p", "17", *args], "cuda")
    combs = []
    while f"input.inp{len(combs)}.comb" in files:
        combs.append(files[f"input.inp{len(combs)}.comb"])
    return engine, out, err, combs, wall


def run_tool(module, text, args, dev):
    """One of the port's command lines (`module`, its ``run``) on an input
    text, on `dev`, in a directory of its own: (what run() returns,
    stdout, stderr, {name: text} of the files it wrote (.comb files as
    read collections), wall seconds)."""
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "input.inp")
        with open(path, "w") as f:
            f.write(text)
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                got = module.run(["-f", path, "--device", str(dev), *args])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            files = {name: (read_collection(name) if name.endswith(".comb")
                            else open(name).read())
                     for name in sorted(os.listdir(tmp))
                     if name != "input.inp"}
        finally:
            os.chdir(cwd)
    return got, out.getvalue(), err.getvalue(), files, wall


@contextlib.contextmanager
def timed_calls(owner, attr, seconds: list):
    """Appends the seconds of every call of owner.attr made inside the
    block to `seconds`, the card synchronized at both ends."""
    fn = getattr(owner, attr)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        made = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return made
    setattr(owner, attr, timed)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def phase_seconds(stderr_text, label):
    """Seconds of the Engine's timed phases whose line holds `label`."""
    return [float(x) for x in re.findall(
        rf"{re.escape(label)}.* done in ([0-9.]+)s", stderr_text)]


# perm_gather's instantiations by the template arguments in their mangled
# names: the sums' type and the source block's
DTYPE_TAGS = {torch.float64: "f64", torch.float32: "f32",
              torch.complex128: "c128", torch.complex64: "c64"}
GATHER_TAGS = {"dd": "f64", "ff": "f32", "NS_4CplxIdEES2_": "c128",
               "NS_4CplxIfEES2_": "c64", "dNS_4Bf16E": "bf16->f64",
               "fNS_4Bf16E": "bf16->f32"}


def record(results, kernel, case, got, ref, tol, times, bound_ms, bound_by,
           padded_bound_ms=None, **extra):
    """Hold a kernel's result against its plain version's, time the kernel,
    its plain version and (where there is one) the library call in the
    turns library, kernel, kernel, library, print one line and append the
    case to results[kernel].  `times`: kernel, plain and (or None) library
    callables.  `padded_bound_ms`, where given, is the bytes bound of a
    sparse matrix's padded form, kept beside `bound_ms`, the bound over its
    nonzero entries alone (which the record also carries as
    ``nonzero_bound_ms``); `extra` items join the record."""
    abs_err, rel = rel_err(got, ref)
    check(rel <= tol, f"{kernel} {case}: rel err {rel:.3e} > {tol:g}")
    run, plain, library = times
    reps = 5 if bound_ms > 5 else 20 if bound_ms > 0.2 else 100
    turns = {"kernel": [], "library": []}
    for name in ("library", "kernel", "kernel", "library"):
        fn = run if name == "kernel" else library
        if fn is not None:
            turns[name].append(median_ms(fn, reps))
    ms = float(np.mean(turns["kernel"]))
    library_ms = (float(np.mean(turns["library"])) if library is not None
                  else None)
    plain_ms = median_ms(plain, reps)
    # what a caller sees on an idle card: the host's way to the launch
    # is in it (the method of this script's first version)
    from_idle_ms = median_ms(run, reps, ahead=False)
    say(f"  {kernel} {case}: max rel err {rel:.3e} (tol {tol:g}), max "
        f"abs err {abs_err:.3e}, kernel {ms:.4f} ms (turns "
        f"{turns['kernel'][0]:.4f}, {turns['kernel'][1]:.4f}), bound "
        f"{bound_ms:.4f} ms by {bound_by} (share {bound_ms / ms:.3f})"
        + ("" if padded_bound_ms is None else
           f" over the nonzero entries, {padded_bound_ms:.4f} ms over the "
           f"padded form (share {padded_bound_ms / ms:.3f})")
        + ", library "
        + ("none" if library_ms is None else
           f"{library_ms:.4f} ms (turns {turns['library'][0]:.4f}, "
           f"{turns['library'][1]:.4f})")
        + f", plain {plain_ms:.4f} ms, kernel from an idle card "
          f"{from_idle_ms:.4f} ms")
    results[kernel].append(dict(
        case=case, max_abs_err=abs_err, max_rel_err=rel, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, library_ms=library_ms,
        from_idle_ms=from_idle_ms, **extra))
    if padded_bound_ms is not None:
        results[kernel][-1].update(
            nonzero_bound_ms=bound_ms, share_of_nonzero_bound=bound_ms / ms,
            padded_bound_ms=padded_bound_ms,
            share_of_padded_bound=padded_bound_ms / ms)


def batched_factor_cases(results, gen, dev, sms, rows, szd, szu,
                         dtype=torch.float64):
    """factor_matmul's batched forms on random blocks of `rows` states of
    a (szd, szu) sector, float64 or float32, against the plain version and
    the library: the up product with the batch folded into its rows and
    the dn product over the transposed views, one launch each (a szu that
    is not a multiple of 16 bytes takes the one-element copies).  A
    batch's dn product must equal its members' one by one bit for bit."""
    from lanczosplusplus_tpu_torch.ops import kernels as K
    size = torch.empty(0, dtype=dtype).element_size()
    wide = szu * size % 16 == 0
    tag, tol = DTYPE_TAGS[dtype], TOL_F64 if size == 8 else TOL_F32
    copies = "16-byte copies" if wide else \
        f"{size}-byte copies: pitch {szu}"
    xb = torch.randn(rows, szd, szu, generator=gen, device=dev, dtype=dtype)
    yb = torch.randn(rows, szd, szu, generator=gen, device=dev, dtype=dtype)
    a_up = torch.randn(szu, szu, generator=gen, device=dev, dtype=dtype)
    a_dn = torch.randn(szd, szd, generator=gen, device=dev, dtype=dtype)
    xf, yf = xb.view(rows * szd, szu), yb.view(rows * szd, szu)
    plan = K.factor_matmul_plan(
        xf.data_ptr(), xf.stride(), a_up.data_ptr(), a_up.stride(),
        yf.data_ptr(), yf.stride(), rows * szd, szu, sms, elem_size=size)
    check(plan.tile == 128 and plan.x_vec16 == plan.a_vec16 == wide,
          f"up form of the batch: plan {plan}")
    got = K.factor_matmul(xf, a_up)
    ref = K.factor_matmul_ref(xf, a_up)
    torch.cuda.synchronize()
    out = torch.empty_like(xf)
    record(results, "factor_matmul",
           f"{tag} batched up form ({rows}*{szd})x{szu}.{szu}x{szu}^T, "
           f"batch folded into the rows (128-tile, {copies})",
           got, ref, tol,
           (lambda: K.factor_matmul(xf, a_up, out=out),
            lambda: K.factor_matmul_ref(xf, a_up),
            lambda: torch.matmul(xf, a_up.T, out=out)),
           1e3 * 2 * rows * szd * szu * szu / PEAK_FLOPS, "operations")
    del got, ref, out
    xt, yt = xb.transpose(1, 2), yb.transpose(1, 2)
    plan = K.factor_matmul_plan(
        xt.data_ptr(), xt.stride(), a_dn.data_ptr(), a_dn.stride(),
        yt.data_ptr(), yt.stride(), szu, szd, sms, rows, elem_size=size)
    check(plan.tile == 128 and not plan.x_kmajor
          and plan.x_vec16 == wide and plan.a_vec16,
          f"dn form of the batch: plan {plan}")
    got = yb.clone()
    K.factor_matmul(xt, a_dn, out=got.transpose(1, 2), accumulate=True)
    ref = yb + torch.matmul(a_dn, xb)
    for b in ((0, rows - 1) if size == 4 else ()):
        one = yb[b].clone()
        K.factor_matmul(xt[b], a_dn, out=one.T, accumulate=True)
        check(torch.equal(one, got[b]),
              f"{tag} batched dn form: member {b} differs from its own call")
    torch.cuda.synchronize()
    y1 = yb.clone()
    record(results, "factor_matmul",
           f"{tag} batched dn form R={rows}: Y[b]+=A.X[b], {szd}^2 factor "
           f"on ({szu}x{szd})^T views, one launch (128-tile, X {copies})",
           got, ref, tol,
           (lambda: K.factor_matmul(xt, a_dn, out=y1.transpose(1, 2),
                                    accumulate=True),
            lambda: y1.transpose(1, 2).add_(
                K.factor_matmul_ref(xt, a_dn)),
            lambda: y1.baddbmm_(a_dn.expand(rows, szd, szd), xb)),
           1e3 * 2 * rows * szd * szd * szu / PEAK_FLOPS, "operations")
    del got, ref, y1, xb, yb, xf, yf, xt, yt, a_up, a_dn


def form_launches(form) -> dict:
    """The kernel launches predicted for one single-state matvec of a
    factored form, read off its structure, by form (the names
    ``launches_by_site`` measures them under): a block-Kronecker form's
    within-block products and CrossTerm
    products ('within'), its tiers' stacked products ('tier') and its
    PermCrossTerms ('cross term', one perm_gather each); the Kitaev form's
    half-chain and cut products ('kitaev').  A complex state goes through
    factor_matmul as its two planes (ops/kernels.py): one launch for a
    shared real factor, two for real factors one per batch member, and two
    more for a complex factor."""
    def gemm(a):
        if not form.dtype.is_complex:
            return 1
        return (1 if a.dim() == 2 else 2) + 2 * a.is_complex()
    if not hasattr(form, "shapes"):
        return {"kitaev": gemm(form.hr_t) + gemm(form.hl) + (
            gemm(form.p) + gemm(form.q_cat) if form.p.shape[0] else 0)}
    in_tier = {b for idxs, _, _ in form.tiers or () for b in idxs}
    within = sum(gemm(op) for b in range(len(form.shapes)) if b not in in_tier
                 for op in (form.row_ops[b], form.col_ops[b])
                 if op is not None)
    within += sum(gemm(t.right) + gemm(t.left_cat) + (
        gemm(t.right_h) + gemm(t.left_h_cat) if t.add_hc else 0)
        for t in form.cross)
    tier = sum(gemm(op) for op in (*form.row_t, *form.col_t)
               if op is not None)
    return {"within": within, "tier": tier,
            "cross term": len(form.perm_cross)}


@contextlib.contextmanager
def launches_by_site():
    """Counts, while the block runs, every kernel launch by the call site
    it comes from, and every apply of a form apart from the launch
    counters.  The launches of each outermost wrapper call are read off
    ``LAUNCHES`` around it and go to the apply innermost on the stack: a
    block-Kronecker apply's own products, within-block and CrossTerm
    ('within'), and its perm_gathers, the PermCrossTerms ('cross term');
    a tier's products ('tier'); a Kitaev apply's products ('kitaev'); a
    one-spin apply's gathers ('one-spin up', the rows the identity, or
    'one-spin dn') and dense factors ('one-spin dense'); any other
    ('elsewhere').  Yields (launches by form, outermost calls by apply:
    'blockkron', 'tier', 'kitaev', 'one-spin')."""
    from lanczosplusplus_tpu_torch.core import blockkron, sparse
    from lanczosplusplus_tpu_torch.models import kitaev_factored
    from lanczosplusplus_tpu_torch.ops import kernels as K
    forms, applies, stack = {}, {}, []
    label = {("blockkron", "factor_matmul"): "within",
             ("blockkron", "perm_gather"): "cross term",
             ("tier", "factor_matmul"): "tier",
             ("kitaev", "factor_matmul"): "kitaev",
             ("one-spin", "factor_matmul"): "one-spin dense"}

    def apply(fn, site):
        def wrapped(*args, **kwargs):
            if site not in stack:
                applies[site] = applies.get(site, 0) + 1
            stack.append(site)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return wrapped

    def kernel(fn, name):
        def wrapped(*args, **kwargs):
            if stack and stack[-1] == "kernel":   # the planes wrapper's calls
                return fn(*args, **kwargs)
            where = stack[-1] if stack else None
            before = K.LAUNCHES[name]
            stack.append("kernel")
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
                form = label.get((where, name), "elsewhere")
                if (where, name) == ("one-spin", "perm_gather"):
                    form = ("one-spin up" if kwargs.get("rs") is None
                            else "one-spin dn")
                forms[form] = forms.get(form, 0) + K.LAUNCHES[name] - before
        return wrapped
    patches = ((blockkron.BlockKronHamiltonian, "matmat_t", apply,
                "blockkron"),
               (blockkron.BlockKronHamiltonian, "_apply_tier", apply, "tier"),
               (kitaev_factored.FactoredKitaevHamiltonian, "matmat_t", apply,
                "kitaev"),
               (sparse.SpinFactorizedPart, "apply_", apply, "one-spin"),
               (K, "factor_matmul", kernel, "factor_matmul"),
               (K, "perm_gather", kernel, "perm_gather"))
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _, _ in patches]
    for owner, attr, wrap, arg in patches:
        setattr(owner, attr, wrap(getattr(owner, attr), arg))
    try:
        yield forms, applies
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def coo_to_csr(dst, src, val, shape):
    """A CSR matrix on the entries' device from COO triples: zero entries
    dropped, duplicates summed."""
    keep = val != 0
    with warnings.catch_warnings():   # sparse CSR is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([dst[keep], src[keep]]), val[keep], shape,
            check_invariants=False).coalesce().to_sparse_csr()


def ell_csr(diag, cols, vals):
    """ell_spmv's operator, diag * x + sum_k vals[:, k] x[cols[:, k]], as
    one CSR matrix with the diagonal folded in: the form in which one
    library call (``csr @ x``, cuSPARSE's SpMV, or its SpMM for a block)
    computes the same function."""
    dim, k = cols.shape
    rows = torch.arange(dim, device=cols.device)
    return coo_to_csr(torch.cat([rows, rows.repeat_interleave(k)]),
                      torch.cat([rows, cols.reshape(-1).long()]),
                      torch.cat([diag.to(vals.dtype), vals.reshape(-1)]),
                      (dim, dim))


def perm_csr(tables, src_shape, dst_shape, dtype, device):
    """perm_gather's operator, Y[r, c] += sum_n a[n, r] beta[n, c]
    X[rs[n, r], cs[n, c]], as one (Y elements, X elements) CSR matrix: the
    library's form of the same function.  A missing table is the
    identity, amplitude 1."""
    rs, a, cs, beta = (tables.get(k) for k in ("rs", "a", "cs", "beta"))
    rows, cols = dst_shape
    nb = next(t.shape[0] for t in (rs, a, cs, beta) if t is not None)
    r = torch.arange(rows, device=device)
    c = torch.arange(cols, device=device)
    sr = r.expand(nb, rows) if rs is None else rs.long()
    sc = c.expand(nb, cols) if cs is None else cs.long()
    va = torch.ones(nb, rows, dtype=dtype, device=device) if a is None else a
    vb = (torch.ones(nb, cols, dtype=dtype, device=device) if beta is None
          else beta)
    src = (sr[:, :, None] * src_shape[1] + sc[:, None, :]).reshape(-1)
    dst = (r[:, None] * cols + c[None, :]).expand(nb, rows, cols).reshape(-1)
    return coo_to_csr(dst, src, (va[:, :, None] * vb[:, None, :]).reshape(-1),
                      (rows * cols, src_shape[0] * src_shape[1]))


def perm_gather_case(results, case, x, y0, tables):
    """perm_gather against its plain version on one block x (or a batch)
    added into y0, bit for bit (each element adds its channels in the
    plain version's order and rounding), timed beside its bytes bound (Y
    read and written, X and the tables read once) and beside ``csr @ x``
    on the same operator as a CSR matrix, built outside the timed region
    (the library writes a fresh output where the kernel adds into Y; a
    bf16 source block meets it widened to Y's type, also outside)."""
    from lanczosplusplus_tpu_torch.ops import kernels as K
    got = y0.clone()
    K.perm_gather(x, got, **tables)
    ref = K.perm_gather_ref(x, y0.clone(), **tables)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"perm_gather {case}: not bit-equal to "
                                 f"its plain version")
    csr = perm_csr(tables, x.shape[-2:], y0.shape[-2:], y0.dtype, x.device)
    xw = x.to(y0.dtype)
    xl = xw.reshape(-1) if x.dim() == 2 else \
        xw.reshape(x.shape[0], -1).T.contiguous()
    lib = csr @ xl
    lib = lib.view(y0.shape) if x.dim() == 2 else lib.T.reshape(y0.shape)
    lib_err = rel_err(lib, ref - y0)[1]
    wide = y0.dtype in (torch.float64, torch.complex128)
    check(lib_err <= (1e-12 if wide else TOL_F32),
          f"perm_gather {case}: the CSR form differs by {lib_err:.3e}")
    y1 = y0.clone()
    nbytes = 2 * y0.numel() * y0.element_size() + \
        x.numel() * x.element_size() + sum(
            t.numel() * t.element_size() for t in tables.values())
    record(results, "perm_gather", case, got, ref, 0.0,
           (lambda: K.perm_gather(x, y1, **tables),
            lambda: K.perm_gather_ref(x, y1, **tables),
            lambda: csr @ xl),
           1e3 * nbytes / PEAK_BYTES, "bytes")


def one_spin_gather_cases(gen, form, label):
    """perm_gather's cases on a float64 sector's one-spin factors in
    gather form (`form`: a Hamiltonian after
    ``densify_factors(max_bytes=0)``; `label`: its size, as "14-site"),
    up form (rows the identity) and dn form (columns the identity), on
    random states, one (R = 1) and a block of 14 (R = 14): yields (case
    label, x, y0, tables), made one at a time."""
    f = form.factorized
    szd, szu = form.spin_shape
    dev = f.up_gather[0].device
    for side in ("up", "dn"):
        idx, amp = f.up_gather if side == "up" else f.dn_gather
        tables = ({"cs": idx, "beta": amp} if side == "up"
                  else {"rs": idx, "a": amp})
        for rows in (1, 14):
            shape = (szd, szu) if rows == 1 else (rows, szd, szu)
            yield (f"f64 {label} one-spin {side} gather form, R={rows} "
                   f"({idx.shape[0]} channels)",
                   torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float64),
                   torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float64),
                   tables)


def largest_cross_term(form, name):
    """The largest PermCrossTerm of a block-Kronecker form (channels
    times destination block): its case label, source and destination
    block shapes, and perm_gather's tables."""
    term = max(form.perm_cross, key=lambda t: t.row_src.numel()
               * t.col_src.shape[1])
    src, dst = form.shapes[term.src], form.shapes[term.dst]
    case = (f"{DTYPE_TAGS[form.dtype]} {name} "
            f"largest PermCrossTerm ({term.row_src.shape[0]} channels, "
            f"block {term.src} {src} -> {term.dst} {dst})")
    return case, src, dst, {"rs": term.row_src, "a": term.row_amp,
                            "cs": term.col_src, "beta": term.col_amp}


def factored_phase(dev, gen, results, refs):
    """Phase 10: the factored forms (SolverOptions=factored) and the
    one-spin gather apply at full width, each run with the launch counts
    set to 0 before and read after.  `refs` holds what the earlier phases
    computed: the 14-site U=4 E0 and start vector, the flat models' E0s,
    the 24-site Heisenberg flat eigenvector and the flat 8-site t-J
    G_00(omega) on goldens.json's points.  Returns ({run label: {"counts":
    launches, "forms": launches by form, "applies": applies of the form}},
    {perm_gather case of a PermCrossTerm: the run label of its form}), the
    launches by form and the applies measured by ``launches_by_site``."""
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.cli import lanczos_main
    from lanczosplusplus_tpu_torch.engine import Engine
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models import factored as fmod
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    runs, cross_cases = {}, {}
    f64 = torch.float64

    def run_record(label, counts, forms, applies, want_forms):
        """Keeps a run's launches, by kernel and by form, and holds the
        forms' launches against `want_forms` (None: not predicted) and
        their sum against the kernels' counts (no ell_spmv in phase
        10)."""
        forms = {k: n for k, n in forms.items() if n}
        runs[label] = {"counts": counts, "forms": forms, "applies": applies}
        say(f"  {label}: launches by form, counted at their call sites, "
            f"{forms}; applies {applies}")
        check(sum(forms.values()) == counts["factor_matmul"]
              + counts["perm_gather"] and "elsewhere" not in forms
              and counts["ell_spmv"] == 0,
              f"{label}: launches {counts}, by form {forms}")
        if want_forms is not None:
            want = {k: n for k, n in want_forms.items() if n}
            check(forms == want, f"{label}: launches by form {forms}, "
                                 f"predicted {want}")

    def agree(label, got, want):
        err = abs(got - want) / abs(want)
        say(f"  {label}: E0 {got!r} against {want!r}, rel err {err:.3e}")
        check(err <= TOL_E0, f"{label}: rel err {err:.3e}")

    def plain_solve(label, form, seed, max_steps, e0, v0=None):
        """The same solve with the plain versions of the kernels from the
        same start vector; no kernel may launch."""
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        evals, _ = lz.lowest_states(PlainForm(form), seed=seed,
                                    max_steps=max_steps, v0=v0)
        torch.cuda.synchronize()
        agree(f"{label}, kernel path against plain versions "
              f"({time.perf_counter() - t:.3f} s)", e0, float(evals[0]))
        check(dict(K.LAUNCHES) == before,
              f"{label}: the plain solve launched a kernel")

    def step_ms(label, forms, x):
        """ms of one matvec of each (name, form), in the turns a, b, b, a."""
        names = [n for n, _ in forms]
        turns = {n: [] for n in names}
        for n in names + names[::-1]:
            form = dict(forms)[n]
            turns[n].append(median_ms(lambda: form.matvec(x), 10))
        say(f"  {label}: ms a matvec " + ", ".join(
            f"{n} {np.mean(t):.4f} (turns {t[0]:.4f}, {t[1]:.4f})"
            for n, t in turns.items()))
        return {n: float(np.mean(t)) for n, t in turns.items()}

    # -- the one-spin gather apply: 14 sites, both factors gathered ------
    inp = parse_input(hubbard_chain_text(14, 4))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    ham = model.hamiltonian(basis, dtype=f64, device=dev)
    gform, dform = ham.densify_factors(max_bytes=0), ham.densify_factors()
    f = gform.factorized
    check(f.up_dense is None and f.dn_dense is None
          and dform.factorized.up_dense is not None, "14-site forms")
    for case in one_spin_gather_cases(gen, gform, "14-site"):
        perm_gather_case(results, *case)
    K.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with launches_by_site() as (forms, applies):
        evals, vecs, info = lz.lowest_states(
            gform, seed=SEED, v0=refs["v0_u4"], return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(K.LAUNCHES)
    matvecs = applies.get("one-spin", 0)
    say(f"phase 10 14-site U=4, both one-spin factors in gather form "
        f"(densify_factors(max_bytes=0)): dim {gform.dim}, steps "
        f"{info.steps}, matvecs {matvecs}, solve {wall:.3f} s, launches "
        f"{counts}")
    run_record("14-site gather form", counts, forms, applies,
               {"one-spin up": matvecs, "one-spin dn": matvecs})
    check(matvecs > 0 and info.converged, "14-site gather form: no apply "
                                          "or unconverged")
    agree("14-site gather form against phase 5's dense form",
          float(evals[0]), refs["e0_u4"])
    step_ms("14-site, dense factors against gather form",
            (("dense", dform), ("gather", gform)), vecs[0].contiguous())
    del ham, gform, dform, f, vecs
    torch.cuda.empty_cache()

    # -- 20 sites: an up factor too large to densify ---------------------
    nsite, nup, ndn = 20, 10, 2
    levels = np.sort(-2.0 * np.cos(2.0 * np.pi * np.arange(nsite) / nsite))
    e_free = levels[:nup].sum() + levels[:ndn].sum()
    for u in (0, 4):
        inp = parse_input(hubbard_chain_text(nsite, u, nup, ndn))
        model = build_model(inp, Geometry(inp))
        config = Config.from_input(inp, device=dev)
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with launches_by_site() as (forms, applies):
            eng = Engine(model, inp, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        fz = eng.hamiltonian.factorized
        matvecs = applies.get("one-spin", 0)
        say(f"phase 10 20-site U={u}, N_up {nup}, N_dn {ndn}: dim "
            f"{eng.basis.size}, up factor {(fz.up_cols.shape[0],) * 2} in "
            f"gather form, dn "
            f"factor {tuple(fz.dn_dense.shape)} dense, steps "
            f"{eng.solve_info.steps}, matvecs {matvecs}, E0 "
            f"{eng.ground_energy!r}, time to E0 {wall:.3f} s, launches "
            f"{counts}, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        check(eng.basis.size == 35_103_640 and fz.up_dense is None
              and fz.dn_dense is not None, "20-site forms")
        run_record(f"20-site U={u}", counts, forms, applies,
                   {"one-spin up": matvecs, "one-spin dense": matvecs})
        check(matvecs > 0, "20-site: no apply")
        if u == 0:
            agree("20-site U=0 against free fermions", eng.ground_energy,
                  e_free)
        else:
            plain_solve("20-site U=4", eng.hamiltonian, config.seed,
                        config.lanczos_steps, eng.ground_energy)
        del eng, fz
        torch.cuda.empty_cache()

    # -- the factored forms ----------------------------------------------
    def solve_factored(label, text, want=None, plain=False, cli=False):
        """One input under SolverOptions=factored on the card, through the
        Engine or the CLI: the factored build timed apart from the solve,
        launches held against the form's count a matvec, E0 against
        `want` and (with `plain`) against the plain versions."""
        inp = parse_input(factored(text))
        builds = []
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with timed_calls(fmod, "factored_hamiltonian_or_none", builds), \
                launches_by_site() as (forms, applies):
            if cli:
                eng, out, _, _, wall = run_cli(lanczos_main, factored(text))
                energy = float(re.search(r"^Energy=(\S+)$", out,
                                         re.M).group(1))
                check(energy == eng.ground_energy, f"{label}: printed "
                      f"{energy!r}, engine {eng.ground_energy!r}")
            else:
                model = build_model(inp, Geometry(inp))
                eng = Engine(model, inp,
                             config=Config.from_input(inp, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        check(eng._factored, f"{label}: flat fallback "
                             f"({eng.factored_fallback_reason})")
        ham = eng._cached_hamiltonian(eng.parts)
        form = getattr(ham, "inner", ham)
        per = form_launches(form)
        matvecs = applies.get("blockkron" if hasattr(form, "shapes")
                              else "kitaev", 0)
        info = eng.solve_info
        shape = (f"{len(form.shapes)} blocks (largest "
                 f"{max(form.shapes, key=lambda s: s[0] * s[1])}), "
                 f"{len(form.tiers or ())} tiers, {len(form.cross)} "
                 f"CrossTerms, {len(form.perm_cross)} PermCrossTerms"
                 if hasattr(form, "shapes") else
                 f"halves {tuple(form.diag2d.shape)}, {form.p.shape[0]} "
                 f"cut terms")
        solve_s = wall - sum(builds)
        say(f"phase 10 {label}, factored{' via CLI' if cli else ''}: dim "
            f"{ham.dim}, {ham.dtype}, {type(ham).__name__}: {shape}; "
            f"launches a matvec predicted {per}; steps {info.steps}, "
            f"matvecs (applies counted apart from the launches) "
            f"{matvecs}, E0 {eng.ground_energy!r}, time to E0 {wall:.3f} s "
            f"= factored build {sum(builds):.3f} s + basis and solve "
            f"{solve_s:.3f} s ({1e3 * solve_s / max(matvecs, 1):.3f} ms a "
            f"matvec), launches {counts}, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        check(info.converged, f"{label} unconverged")
        run_record(label, counts, forms, applies,
                   {k: n * matvecs for k, n in per.items()})
        check(matvecs > 0, f"{label}: no apply")
        vec = eng.eigenvector(0)
        check(vec.device.type == "cuda" and vec.shape == (ham.dim,),
              f"{label}: eigenvector {tuple(vec.shape)}")
        refs[f"factored {label}"] = eng.ground_energy
        if want is not None:
            agree(f"{label} against the flat form", eng.ground_energy, want)
        if plain:
            plain_solve(label, form, eng.config.seed,
                        eng.config.lanczos_steps, eng.ground_energy)
        return eng, form

    def cross_case(name, run, form):
        """perm_gather on the largest PermCrossTerm of a form, its own
        tables on random blocks."""
        case, src, dst, tables = largest_cross_term(form, name)
        perm_gather_case(
            results, case,
            torch.randn(src, generator=gen, device=dev, dtype=form.dtype),
            torch.randn(dst, generator=gen, device=dev, dtype=form.dtype),
            tables)
        cross_cases[case] = run

    # t-J: 18 sites through the CLI; its largest cross term and tier
    label = "18-site t-J ring, 8 up 8 down"
    eng, form = solve_factored(label, tj_ring_text(18, 8, 8),
                               want=refs[label], cli=True)
    cross_case("18-site t-J", label, form)
    t_big = max(range(len(form.tiers)), key=lambda i: form.col_t[i].numel())
    a3 = form.col_t[t_big]
    nblk, rt = form.diag_t[t_big].shape[:2]
    x3 = torch.randn(nblk, rt, a3.shape[1], generator=gen, device=dev,
                     dtype=f64)
    y0 = torch.randn_like(x3)
    got = y0.clone()
    K.factor_matmul(x3, a3, out=got, accumulate=True)
    ref = y0 + torch.matmul(x3, a3.transpose(1, 2))
    torch.cuda.synchronize()
    y1 = y0.clone()
    record(results, "factor_matmul",
           f"f64 18-site t-J tier: {nblk} blocks of {rt}x{a3.shape[1]} . "
           f"their own {a3.shape[1]}^2 factors, one launch (A batch "
           f"stride)", got, ref, TOL_F64,
           (lambda: K.factor_matmul(x3, a3, out=y1, accumulate=True),
            lambda: y1.add_(K.factor_matmul_ref(x3, a3)),
            lambda: y1.baddbmm_(x3, a3.transpose(1, 2))),
           1e3 * 2 * x3.numel() * a3.shape[1] / PEAK_FLOPS, "operations")
    del eng, form, x3, y0, y1, got, ref, a3

    # Heisenberg: 24 sites; its eigenvector against the flat one, and its
    # largest block's row product
    eng, form = solve_factored("24-site Heisenberg ring",
                               heisenberg_ring_text(24),
                               want=refs["24-site Heisenberg ring"])
    overlap = abs(torch.vdot(eng.eigenvector(0),
                             refs["heisenberg24 vector"]).item())
    say(f"  24-site Heisenberg: |<flat|factored>| of the ground states in "
        f"flat order {overlap!r}")
    check(abs(overlap - 1.0) <= 1e-8, f"eigenvector overlap {overlap!r}")
    b = max((b for b in range(len(form.shapes))
             if form.row_ops[b] is not None),
            key=lambda b: form.shapes[b][0] * form.shapes[b][1])
    r, c = form.shapes[b]
    a2 = form.row_ops[b]
    x2 = torch.randn(r, c, generator=gen, device=dev, dtype=f64)
    y0 = torch.randn(r, c, generator=gen, device=dev, dtype=f64)
    got = y0.clone()
    K.factor_matmul(x2.T, a2, out=got.T, accumulate=True)
    ref = y0 + a2 @ x2
    torch.cuda.synchronize()
    y1 = y0.clone()
    record(results, "factor_matmul",
           f"f64 24-site Heisenberg largest block: Y+=row_op.X, {r}^2 "
           f"factor on a {r}x{c} block (transposed views)", got, ref, TOL_F64,
           (lambda: K.factor_matmul(x2.T, a2, out=y1.T, accumulate=True),
            lambda: y1.T.add_(K.factor_matmul_ref(x2.T, a2)),
            lambda: y1.addmm_(a2, x2)),
           1e3 * 2 * r * r * c / PEAK_FLOPS, "operations")
    del eng, form, a2, x2, y0, y1, got, ref

    # Rashba half-cut: the 12-site complex ring, then bench.py's 13 sites
    label = "12-site Rashba ring, 12 electrons"
    eng, form = solve_factored(label, rashba_ring_text(12, 12),
                               want=refs[label])
    cross_case("12-site Rashba half-cut", label, form)
    del eng, form
    torch.cuda.empty_cache()
    label = "13-site Rashba ring, 13 electrons"
    eng, form = solve_factored(label, rashba_ring_text(
        13, 13, amplitude="0.5", options="none"), plain=True)
    cross_case("13-site Rashba half-cut", label, form)
    # the solve runs in block order; the flat-order wrap (a signed gather
    # before and after each matvec) is timed once beside it
    step_ms("13-site Rashba half-cut, block order against the flat-order "
            "wrap", (("factored", form),
                     ("wrapped", eng._cached_hamiltonian(eng.parts))),
            eng.eigenvector(0).to(form.dtype))
    del eng, form
    torch.cuda.empty_cache()

    # Kitaev: 16 sites against the flat form, 24 sites for time
    inp = parse_input(kitaev_ring_text(16))
    flat16 = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device=dev))
    solve_factored("16-site Kitaev ring", kitaev_ring_text(16),
                   want=flat16.ground_energy)
    del flat16
    eng, form = solve_factored("24-site Kitaev ring", kitaev_ring_text(24),
                               plain=True)
    half = form.hl.shape[0]
    x2 = torch.randn(half, half, generator=gen, device=dev, dtype=f64)
    y0 = torch.randn(half, half, generator=gen, device=dev, dtype=f64)
    got = y0.clone()
    K.factor_matmul(x2.T, form.hl, out=got.T, accumulate=True)
    ref = y0 + form.hl @ x2
    torch.cuda.synchronize()
    y1 = y0.clone()
    hl = form.hl
    record(results, "factor_matmul",
           f"f64 24-site Kitaev left half: Y+=H_L.X, {half}^3 (transposed "
           f"views)", got, ref, TOL_F64,
           (lambda: K.factor_matmul(x2.T, hl, out=y1.T, accumulate=True),
            lambda: y1.T.add_(K.factor_matmul_ref(x2.T, hl)),
            lambda: y1.addmm_(hl, x2)),
           1e3 * 2 * half ** 3 / PEAK_FLOPS, "operations")
    del eng, form, hl, x2, y0, y1, got, ref
    torch.cuda.empty_cache()

    # FeAs: the 8-site sector's single block, and the spin-orbit union
    label = "8-site two-orbital FeAs sector, 4 up 4 down"
    eng, form = solve_factored(label, feas_ring_text(8, 4, 4),
                               want=refs[label])
    cross_case("8-site FeAs interaction", label, form)
    refs["feas cross term"] = largest_cross_term(form, "8-site FeAs")
    del eng, form
    torch.cuda.empty_cache()
    so_text = feas_spinorbit_chain_text(*FEAS_SO_SECTOR)
    inp = parse_input(so_text)
    model = build_model(inp, Geometry(inp))
    torch.cuda.synchronize()
    t = time.perf_counter()
    flat_so = Engine(model, inp, config=Config.from_input(inp, device=dev))
    torch.cuda.synchronize()
    say(f"phase 10 FeAs spin-orbit flat form, {FEAS_SO_SECTOR[0]} sites, "
        f"{sum(FEAS_SO_SECTOR[1:])} electrons: dim {flat_so.basis.size}, "
        f"time to E0 {time.perf_counter() - t:.3f} s")
    label = f"{FEAS_SO_SECTOR[0]}-site FeAs spin-orbit chain"
    eng, form = solve_factored(label, so_text, want=flat_so.ground_energy)
    cross_case(f"{FEAS_SO_SECTOR[0]}-site FeAs spin-orbit", label, form)
    del flat_so, eng, form

    # t-J 8 sites, -g c under SolverOptions=factored
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "goldens.json")) as fh:
        goldens = json.load(fh)
    K.reset_launches()
    with launches_by_site() as (forms, applies):
        eng, _, _, combs, wall = run_cli(
            lanczos_main,
            factored(tj_ring_text(8, 3, 3)) + "TSPSites 2 0 0\n", ["-g", "c"])
    counts = dict(K.LAUNCHES)
    run_record("8-site t-J -g", counts, forms, applies, None)
    got = combs[0].evaluate(np.asarray(goldens["gf_tj_omegas"]),
                            goldens["gf_tj_delta"])
    want = np.asarray(goldens["gf_tj_re"]) + 1j * np.asarray(
        goldens["gf_tj_im"])
    gf_err = np.abs(got - want).max() / np.abs(want).max()
    flat_err = np.abs(got - refs["gf_tj"]).max() / np.abs(
        refs["gf_tj"]).max()
    say(f"phase 10 8-site t-J ring via CLI -g c, SolverOptions=factored: "
        f"G_00(omega + 0.25i) against goldens.json max rel err {gf_err:.3e} "
        f"(tolerance 1e-9), against the flat -g {flat_err:.3e} (tolerance "
        f"1e-12), wall {wall:.3f} s, launches {counts}")
    check(eng._factored and gf_err <= 1e-9 and flat_err <= 1e-12,
          f"factored -g: golden {gf_err:.3e}, flat {flat_err:.3e}")
    check(counts["perm_gather"] > 0 and counts["factor_matmul"] > 0,
          f"factored -g launches {counts}")
    return runs, cross_cases


@contextlib.contextmanager
def counted_applies(owner, attr, batched=False):
    """Counts, while the block runs, the calls of owner.attr whose first
    argument lies on the card (with `batched`, a 2-D block of states
    there): yields a dict whose "applies" is that count.  A batched apply
    of a form with dense one-spin factors is one launch of each
    factor_matmul form, of one with an ELL part one ell_spmv launch."""
    fn = getattr(owner, attr)
    seen = {"applies": 0}

    def wrapped(self, x, *args, **kwargs):
        if x.is_cuda and (x.dim() == 2 or not batched):
            seen["applies"] += 1
        return fn(self, x, *args, **kwargs)
    setattr(owner, attr, wrapped)
    try:
        yield seen
    finally:
        setattr(owner, attr, fn)


SECTOR_LINE = re.compile(
    r"symmetry sector (\d+): dim (\d+), torch\.(\w+), ELL K (\d+) against "
    r"([0-9.]+) entries a row, steps (\d+), E0 (\S+)")


def eigenvector_residual(ham, v, e0) -> float:
    """||H v - e0 v|| in the form's precision for a real form `ham` and a
    real or complex state `v` (a complex one applied as its two real
    planes)."""
    v = v.to(torch.complex128 if v.is_complex() else ham.dtype)
    parts = (v,) if not v.is_complex() else (v.real.contiguous(),
                                             v.imag.contiguous())
    hv = [ham.matvec(p) for p in parts]
    hv = hv[0] if len(hv) == 1 else torch.complex(*hv)
    return torch.linalg.vector_norm(hv - e0 * v).item()


def symmetry_phase(dev, gen, results, refs, ell_case):
    """Phase 11: the symmetry sectors on the card, each run through the
    port's CLI with the launch counts set to 0 before and read after:
    the 12-site half-filled U=4 chain's 12 momentum blocks against its E0
    and Hamiltonian without symmetry, the 14-site open (4, 4) chain's two
    parity blocks and the 12-site (3, 3) ladder's momentum blocks of both
    directions against their flat E0s, the 22-site Kitaev ring by
    projection against its factored E0; then ell_spmv on the larger
    parity block (`ell_case`, phase 3's) and factor_matmul on the Kitaev
    half.  Each symmetric run's E0, wall, peak memory and
    blocks (or sectors) go to `refs` under "phase 11 <label>", what phase
    15 holds its float32 runs against.  Returns {run label: (kind,
    launches)}, kind "flat", "translation blocks", "reflection blocks" or
    "projected"."""
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.cli import lanczos_main
    from lanczosplusplus_tpu_torch.core import sparse
    from lanczosplusplus_tpu_torch.engine import Engine
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.symmetry import projected
    runs = {}

    def flat_e0(label, text):
        """E0 of the sector without symmetry, through the Engine on the
        card (its launches kept apart)."""
        inp = parse_input(text)
        K.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = Engine(build_model(inp, Geometry(inp)), inp,
                     config=Config.from_input(inp, device=dev))
        torch.cuda.synchronize()
        runs[f"{label}, without symmetry"] = ("flat", dict(K.LAUNCHES))
        say(f"phase 11 {label} without symmetry: dim {eng.basis.size}, E0 "
            f"{eng.ground_energy!r}, time to E0 "
            f"{time.perf_counter() - t:.3f} s, launches {dict(K.LAUNCHES)}")
        check(eng.solve_info.converged, f"{label} flat solve unconverged")
        return eng

    def blocks_run(label, kind, text, want):
        """The symmetric input through the CLI on the card: one line a
        block (dim, type, K against the mean entries a row, build s,
        steps, solve s, ms a matvec), E0 against `want`, every block
        matvec one ell_spmv launch.  Returns the engine and its blocks,
        [(sector, block)]."""
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with counted_applies(sparse.Hamiltonian, "matmat_t") as seen:
            eng, _, err, _, wall = run_cli(lanczos_main, text)
        counts = dict(K.LAUNCHES)
        runs[label] = (kind, counts)
        setup, = phase_seconds(err, "symmetry setup")
        builds = dict((int(a), float(b)) for a, b in re.findall(
            r"symmetry sector (\d+) block build done in ([0-9.]+)s", err))
        solves = dict((int(a), float(b)) for a, b in re.findall(
            r"symmetry sector (\d+) solve done in ([0-9.]+)s", err))
        blocks = [(int(m[0]), int(m[1]), m[2], int(m[3]), float(m[4]),
                   int(m[5]), float(m[6])) for m in SECTOR_LINE.findall(err)]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        # what phase 15 holds its float32 run against
        refs[f"phase 11 {label}"] = dict(e0=eng.ground_energy, wall=wall,
                                         peak=peak, blocks=blocks)
        say(f"phase 11 {label} via CLI on cuda: dim {eng.basis.size}, "
            f"{len(blocks)} blocks, min sector {eng.solve_sector}, E0 "
            f"{eng.ground_energy!r}, time to E0 {wall:.3f} s = symmetry "
            f"setup {setup:.3f} + block builds {sum(builds.values()):.3f} + "
            f"block solves {sum(solves.values()):.3f} s + the rest, "
            f"{seen['applies']} block matvecs, launches {counts}, peak "
            f"device memory {peak:.2f} GB")
        for s, dim, dtype, width, mean, steps, e0 in blocks:
            say(f"  sector {s}: dim {dim}, {dtype}, ELL K {width} against "
                f"{mean:.2f} entries a row (padding share "
                f"{1 - mean / width:.3f}), build {builds[s]:.3f} s, steps "
                f"{steps}, solve {solves[s]:.3f} s"
                + (f" ({1e3 * solves[s] / steps:.3f} ms a step)" if steps
                   else "") + f", E0 {e0!r}")
        err_e0 = abs(eng.ground_energy - want) / abs(want)
        say(f"  E0 against {want!r}: rel err {err_e0:.3e}")
        check(err_e0 <= TOL_E0, f"{label}: E0 off by {err_e0:.3e}")
        check(counts == {"factor_matmul": 0, "ell_spmv": seen["applies"],
                         "perm_gather": 0} and seen["applies"] > 0,
              f"{label}: launches {counts}, block matvecs {seen['applies']}")
        check(eng.eigenvector(0).device.type == "cuda",
              f"{label}: eigenvector not on the card")
        sym = eng.symmetry
        made = [(s, sym.block_hamiltonian(s)) for s in range(sym.sectors())]
        return eng, [(s, b) for s, b in made if b is not None]

    # a. the 12-site half-filled U=4 chain: 12 momentum blocks (phase 15
    # holds the 14-site chain's 14 blocks, in float32)
    label = "12-site U=4 chain, translation"
    text = hubbard_chain_text(12, 4)
    flat = flat_e0(label, text)
    eng, kept = blocks_run(label, "translation blocks",
                           text + "UseTranslationSymmetry=1\n",
                           flat.ground_energy)
    check(len(kept) == 12, f"{label}: {len(kept)} blocks")
    v = eng.eigenvector(0)
    resid = eigenvector_residual(flat.hamiltonian, v, eng.ground_energy)
    say(f"  the transformed eigenvector ({v.dtype}, norm "
        f"{torch.linalg.vector_norm(v).item():.15f}) on the flat "
        f"Hamiltonian: ||Hv - E0 v|| = {resid:.3e}")
    check(resid <= 1e-8, f"{label}: residual {resid:.3e}")
    del eng, v, kept, flat
    torch.cuda.empty_cache()

    # b. the 14-site open (4, 4) chain: two parity blocks
    label = "14-site open (4, 4) chain, reflection"
    text = hubbard_chain_text(14, 4, 4, 4, periodic=0)
    flat = flat_e0(label, text)
    check(flat.basis.size == 1_002_001
          and tuple(flat.hamiltonian.factorized.up_dense.shape)
          == (1001, 1001), f"{label}: dim {flat.basis.size}")
    eng, kept = blocks_run(label, "reflection blocks",
                           text + "UseReflectionSymmetry=1\n",
                           flat.ground_energy)
    check(len(kept) == 2 and all(b.dtype == torch.float64 for _, b in kept),
          f"{label}: blocks {[(b.dim, b.dtype) for _, b in kept]}")
    parity = max(kept, key=lambda sb: sb[1].dim)
    parity_entries = eng.symmetry.block_entries[parity[0]]
    del flat, eng, kept

    # c. the 12-site (3, 3) ladder, both translation directions
    label = "12-site (3, 3) 2-leg ladder, translation in both directions"
    text = hubbard_chain_text(12, 4, 3, 3, ladder=True)
    flat = flat_e0(label, text)
    check(flat.basis.size == 48_400, f"{label}: dim {flat.basis.size}")
    eng, kept = blocks_run(label, "translation blocks",
                           text + "UseTranslationSymmetry=2\n",
                           flat.ground_energy)
    check(len(kept) == 12, f"{label}: {len(kept)} blocks")
    del flat, eng, kept
    torch.cuda.empty_cache()

    # d. the 22-site Kitaev ring: projected translation on the card
    label = "22-site Kitaev ring, projected translation"
    text = kitaev_ring_text(22)
    ref = flat_e0("22-site Kitaev ring, factored", factored(text))
    form = ref._cached_hamiltonian(ref.parts)
    # phase 14 builds it again with bf16 factors
    # phase 15 times the float32 product on this half
    refs["22-site Kitaev half"] = form.hl
    refs["22-site Kitaev ring"] = (ref.ground_energy, form, ref.model,
                                   ref.basis)
    K.reset_launches()
    with counted_applies(projected.RotationProjectedHamiltonian,
                         "matvec") as seen:
        eng, _, err, _, wall = run_cli(lanczos_main,
                                       text + "UseTranslationSymmetry=1\n")
    counts = dict(K.LAUNCHES)
    runs[label] = ("projected", counts)
    build_s, = phase_seconds(err, "projected translation build")
    solves = [float(x) for x in re.findall(
        r"momentum sector k=\d+ solve done in ([0-9.]+)s", err)]
    per_k = [(int(k), int(steps), float(e0)) for k, steps, e0 in re.findall(
        r"momentum sector k=(\d+): steps (\d+), E0 (\S+)", err)]
    err_e0 = abs(eng.ground_energy - ref.ground_energy) / abs(
        ref.ground_energy)
    sym = {"sym_model": "kitaev22_translation_projected",
           "sym_dim": eng.basis.size, "sym_sectors": len(per_k),
           "sym_build_s": build_s,
           "sym_k_iters_per_s": seen["applies"] / sum(solves),
           "sym_min_k": eng.solve_sector,
           "sym_min_k_e0_rel_err": err_e0,
           "sym_winner_purity": eng.projected_purity}
    say(f"phase 11 {label} via CLI on cuda: dim {eng.basis.size}, "
        f"{len(per_k)} sectors, time to E0 {wall:.3f} s = build "
        f"{build_s:.3f} + sector solves {sum(solves):.3f} s + the rest, "
        f"{seen['applies']} projected matvecs "
        f"({1e3 * sum(solves) / seen['applies']:.3f} ms each, solve "
        f"included), launches {counts}; {json.dumps(sym)}")
    for (k, steps, e0), sec in zip(per_k, solves):
        say(f"  k={k}: steps {steps}, solve {sec:.3f} s, E0 {e0!r}")
    refs[f"phase 11 {label}"] = dict(e0=eng.ground_energy, wall=wall,
                                     per_k=per_k, solves=solves,
                                     build=build_s)
    say(f"  min-k E0 {eng.ground_energy!r} against the factored solve's "
        f"{ref.ground_energy!r}: rel err {err_e0:.3e}")
    check(len(per_k) == 12 and eng.basis.size == 1 << 22,
          f"{label}: {len(per_k)} sectors, dim {eng.basis.size}")
    check(err_e0 <= TOL_E0, f"{label}: E0 off by {err_e0:.3e}")
    check(eng.projected_purity >= 1 - 1e-8,
          f"{label}: purity {eng.projected_purity!r}")
    check(counts == {"factor_matmul": 4 * seen["applies"], "ell_spmv": 0,
                     "perm_gather": 0} and seen["applies"] > 0,
          f"{label}: launches {counts}, projected matvecs "
          f"{seen['applies']} (4 products each)")
    half = form.hl.shape[0]
    x2 = torch.randn(half, half, generator=gen, device=dev,
                     dtype=torch.float64)
    y0 = torch.randn(half, half, generator=gen, device=dev,
                     dtype=torch.float64)
    got = y0.clone()
    K.factor_matmul(x2.T, form.hl, out=got.T, accumulate=True)
    want = y0 + form.hl @ x2
    torch.cuda.synchronize()
    y1 = y0.clone()
    hl = form.hl
    record(results, "factor_matmul",
           f"f64 22-site Kitaev left half: Y+=H_L.X, {half}^3 (transposed "
           f"views)", got, want, TOL_F64,
           (lambda: K.factor_matmul(x2.T, hl, out=y1.T, accumulate=True),
            lambda: y1.T.add_(K.factor_matmul_ref(x2.T, hl)),
            lambda: y1.addmm_(hl, x2)),
           1e3 * 2 * half ** 3 / PEAK_FLOPS, "operations")
    del eng, ref, form, hl, x2, y0, y1, got, want
    torch.cuda.empty_cache()

    # e. ell_spmv on the larger parity block
    _, blk = parity
    width = blk.ell.cols.shape[1]
    for rows in (1, 14):
        ell_case(f"f64 14-site parity block R={rows}, dim {blk.dim}, K "
                 f"{width} against {parity_entries / blk.dim:.2f} entries "
                 f"a row", blk.diag, blk.ell.cols, blk.ell.vals,
                 (blk.dim,) if rows == 1 else (rows, blk.dim), TOL_ELL_F64,
                 entries=parity_entries)
    say(f"symmetry paths' kernel launches: {runs}")
    return runs


def beta_schedule(betas) -> str:
    """TemperatureOrBeta labels of a linear beta grid (first, last,
    count)."""
    first, last, total = betas
    return ("TemperatureOrBeta=beta\n"
            f"TemperatureOrBetaStart={first!r}\n"
            f"TemperatureOrBetaTotal={total}\n"
            f"TemperatureOrBetaStep={(last - first) / (total - 1)!r}\n")


def tridiagonal_moments(cf, a, b, count):
    """Chebyshev moments w e1^T T_k((T - b)/a) e1, k < count, of a
    continued fraction's Lanczos tridiagonal T (weight w = |phi|^2): the
    moments of its start vector phi for k < 2 m in exact arithmetic."""
    m = len(cf.alphas)
    t = (np.diag(cf.alphas) + np.diag(cf.betas[:m - 1], 1)
         + np.diag(cf.betas[:m - 1], -1) - b * np.eye(m)) / a
    prev, cur = np.eye(m)[0], t[:, 0].copy()
    mu = [prev[0], cur[0]]
    for _ in range(count - 2):
        prev, cur = cur, 2.0 * t @ cur - prev
        mu.append(cur[0])
    return cf.weight * np.asarray(mu[:count])


def estimator_phase(dev, gen, results, refs, ell_case):
    """Phase 12: the estimators (FTLM, LTLM, KPM, FTLM dynamics, the
    thermal sweeps) and their command lines on the card, each case run
    through its CLI's run() with the launch counts set to 0 before and
    read after: 12a ed --ftlm on the 14-site half-filled U=4 chain (R =
    16, 80 steps, 8 betas from 0.1 to 20) against phase 5's E0 (`refs`)
    and against the same run through the plain versions from the same
    card-drawn block; 12b ed --ltlm on the same sector within the Ritz
    residual's bound of that E0; 12c lanczos -g c --kpm on the same
    sector, its moments against those of the same start vector's Lanczos
    tridiagonal from -g and against the plain versions; 12d ed --ftlm
    under SolverOptions=factored on the 18-site t-J ring (the inner-order
    branch through perm_gather) against the flat form from the same
    block, with its idle share; 12e lanczos -g c --ftlm-dos 2.0 on the
    12-site SuperHubbardExtended chain against the plain versions, and at
    beta 40 against -g's continued fraction (the exact sum rule of its
    poles); 12f thermal (full
    spectra and --ftlm), sqomega, dynamics1, qpz and lorentzian at small
    sizes against the port's own CPU runs; then the batched kernels at
    the estimators' R = 16 (factor_matmul on the 14-site sector, ell_spmv
    on the 18-site t-J ELL, perm_gather on its largest cross term).
    Returns {case: launches}."""
    from lanczosplusplus_tpu_torch.cli import (
        dynamics1_main, ed_main, lanczos_main, lorentzian_main, qpz_main,
        sqomega_main, thermal_main)
    from lanczosplusplus_tpu_torch.engine import ftlm as F
    from lanczosplusplus_tpu_torch.engine import kpm as KPM
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    import profile_step

    f64 = torch.float64
    e0 = refs["e0_u4"]
    runs = {}
    ftlm_seed = 982451653          # ftlm_schedule's and ltlm_schedule's

    def sector_of(text):
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        return inp, model

    def counted(label):
        runs[label] = dict(K.LAUNCHES)
        return runs[label]

    # -- 12a: ed --ftlm, 14 sites, R = 16 ------------------------------------
    rows, steps = 16, 80
    text_a = (hubbard_chain_text(14, 4) + beta_schedule((0.1, 20.0, 8))
              + f"FTLMVectors={rows}\nFTLMSteps={steps}\n")
    build_s, rec_s, ftlm_s = [], [], []
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with timed_calls(F, "_schedule_ham", build_s), \
            timed_calls(F, "_ftlm_recurrence", rec_s), \
            timed_calls(F, "ftlm", ftlm_s):
        res, out, _, _, wall = run_tool(ed_main, text_a, ["--ftlm"], dev)
    counts = counted("12a ed --ftlm 14-site")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(counts == {"factor_matmul": 2 * steps, "ell_spmv": 0,
                     "perm_gather": 0},
          f"12a launches {counts}, predicted factor_matmul {2 * steps}")
    check(res.num_vectors == rows and res.steps == steps
          and f"method=FTLM R={rows} M={steps}" in out,
          f"12a ran R={res.num_vectors}, M={res.steps}")
    host_share = 1.0 - rec_s[0] / ftlm_s[0]
    say(f"phase 12a 14-site U=4 ed --ftlm via CLI on {dev}: R {rows}, "
        f"{steps} steps, {len(res.betas)} betas {float(res.betas[0])!r} .. "
        f"{float(res.betas[-1])!r}; wall {wall:.3f} s = host build "
        f"{build_s[0]:.3f} + ftlm {ftlm_s[0]:.3f} s, of which the batched "
        f"recurrence {rec_s[0]:.3f} s ({1e3 * rec_s[0] / steps:.3f} ms a "
        f"step at R = {rows}) and the host (block draw, tridiagonal "
        f"eigensolves, Boltzmann sums) a share {host_share:.4f}; launches "
        f"{counts}, peak device memory {peak:.2f} GB")
    say(f"  energies {[float(e) for e in res.energy]}")
    gap = (res.e0_estimate - e0) / abs(e0)
    say(f"  e0_estimate {res.e0_estimate!r} against phase 5's E0 {e0!r} "
        f"(rel {gap:.3e}, must be >= -1e-9)")
    check(res.e0_estimate >= e0 - 1e-9 * abs(e0),
          f"12a e0_estimate {res.e0_estimate!r} below E0 {e0!r}")
    inp_a, model_a = sector_of(text_a)
    ham_a = F._schedule_ham(model_a, inp_a, dev)
    block = lz.random_start_block(ham_a.dim, rows, ftlm_seed, f64, dev)
    before = dict(K.LAUNCHES)
    t = time.perf_counter()
    with plain_kernels():
        res_p = F.ftlm(ham_a, res.betas, steps=steps, start_vectors=block)
    plain_s = time.perf_counter() - t
    check(dict(K.LAUNCHES) == before, "12a: the plain run launched a kernel")
    diff = np.abs(res.energy - res_p.energy).max() / np.abs(
        res_p.energy).max()
    say(f"  the same block through the plain versions: energies max rel "
        f"diff {diff:.3e} (tolerance 1e-8), ftlm {plain_s:.3f} s")
    check(diff <= 1e-8, f"12a kernel vs plain energies {diff:.3e}")
    del ham_a, block, res_p
    torch.cuda.empty_cache()

    # -- 12b: ed --ltlm, the same sector, R = 4 ------------------------------
    text_b = (hubbard_chain_text(14, 4) + beta_schedule((0.5, 500.0, 4))
              + "FTLMVectors=4\nFTLMSteps=150\n")
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out_b, _, _, _, wall = run_tool(ed_main, text_b, ["--ltlm"], dev)
    counts = counted("12b ed --ltlm 14-site")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    e_cold, bound = float(out_b["energy"][-1]), out_b["_ritz_residual"]
    say(f"phase 12b 14-site U=4 ed --ltlm via CLI on {dev}: R 4, 150 "
        f"steps, wall {wall:.3f} s, launches {counts}, peak device memory "
        f"{peak:.2f} GB; energy at beta 500 {e_cold!r}, E0 - energy "
        f"{e0 - e_cold:.3e}, lowest Ritz value {out_b['_e0']!r}; bound: E0 "
        f"- 1e-9|E0| <= energy <= E0 + r + 1e-9|E0| with r = {bound:.3e}, "
        f"the largest residual |beta_m u_m| of a run's lowest Ritz pair "
        f"(its distance from an eigenvalue; at beta 500 the excited levels "
        f"weigh nothing)")
    check(e0 - 1e-9 * abs(e0) <= e_cold <= e0 + bound + 1e-9 * abs(e0),
          f"12b LTLM energy {e_cold!r} outside [E0, E0 + {bound:.3e}]")
    check(counts["factor_matmul"] > 0, f"12b launches {counts}")

    # -- 12c: lanczos -g c --kpm, 14 sites, 512 moments ----------------------
    moments = 512
    text_c = hubbard_chain_text(14, 4) + ("TSPSites 2 0 0\n"
                                          f"KPMMoments={moments}\n")
    K.reset_launches()
    eng, _, err, files, wall = run_tool(
        lanczos_main, text_c, ["-g", "c", "--kpm", "-p", "17"], dev)
    counts = counted("12c lanczos -g c --kpm 14-site")
    maps_s = phase_seconds(err, "kpm start vector")
    loop_s = phase_seconds(err, "kpm moments")
    say(f"phase 12c 14-site U=4 lanczos -g c --kpm via CLI on {dev}: wall "
        f"{wall:.3f} s, host operator maps and scatters {maps_s} s, moment "
        f"loops (bounds, {moments // 2} applies, host read) {loop_s} s, "
        f"launches {counts}")
    check(len(maps_s) == len(loop_s) == 2 and counts["factor_matmul"] > 0,
          f"12c: {len(loop_s)} moment loops, launches {counts}")
    kpmdos = np.loadtxt(files["input.inp0.kpmdos"].splitlines())
    coll = files["input.inp0.comb"]
    grid = kpmdos[:, 0]
    gs = eng.eigenvector(0)
    dens = np.zeros_like(grid)
    # what phase 15 holds its float32 run against
    refs["kpm"] = dict(dos=kpmdos, wall=wall, loops=loop_s, moments=[])
    op_c = LabeledOperator("c")
    for type_, cf in enumerate(coll.items):
        op = op_c if type_ else op_c.transpose_conjugate()
        parts, basis = eng._get_needed_basis(eng.parts, op, 0, 0)
        phi = torch.zeros(basis.size, dtype=f64, device=dev)
        eng.acc_modified_state(phi, op, basis, gs, eng.basis, 0, 0, 0, 1.0)
        ham = eng._cached_hamiltonian(parts)
        bounds = KPM.spectral_bounds(ham)
        t = time.perf_counter()
        got = KPM.chebyshev_moments(ham, phi, moments, bounds)
        kernel_s = time.perf_counter() - t
        t = time.perf_counter()
        with plain_kernels():
            ref = KPM.chebyshev_moments(ham, phi, moments, bounds)
        plain_s = time.perf_counter() - t
        mu0 = got.moments[0]
        k_plain = np.abs(got.moments - ref.moments).max() / mu0
        upto = min(2 * len(cf.alphas), moments)
        lanczos = tridiagonal_moments(cf, got.a, got.b, upto)
        k_lanczos = np.abs(got.moments[:upto] - lanczos).max() / mu0
        say(f"  type {type_} sector {parts} (dim {basis.size}): mu_0 "
            f"{mu0:.15f} (-g weight {cf.weight:.15f}); against the plain "
            f"versions max |dmu_k| / mu_0 {k_plain:.3e} (tolerance 1e-10); "
            f"against the moments of -g's {len(cf.alphas)}-step Lanczos "
            f"tridiagonal, k < {upto}, {k_lanczos:.3e} (tolerance 1e-8); "
            f"moment loop kernel {kernel_s:.3f} s, plain {plain_s:.3f} s")
        check(basis.size == 10_306_296, f"12c sector dim {basis.size}")
        check(k_plain <= 1e-10, f"12c kernel vs plain moments {k_plain:.3e}")
        check(k_lanczos <= 1e-8, f"12c moments vs Lanczos {k_lanczos:.3e}")
        dens += got.density((grid if type_ == 0 else -grid)
                            + eng.ground_energy)
        refs["kpm"]["moments"].append((got.a, got.b, got.moments))
    dos_err = np.abs(kpmdos[:, 1] - dens).max() / np.abs(dens).max()
    say(f"  .kpmdos against the density of these moments: max rel diff "
        f"{dos_err:.3e} (tolerance 1e-8, the file's 10 digits)")
    check(dos_err <= 1e-8, f"12c .kpmdos differs by {dos_err:.3e}")
    del eng, gs, phi, ham, coll
    torch.cuda.empty_cache()

    # -- 12d: ed --ftlm, SolverOptions=factored, 18-site t-J -----------------
    text_d = (factored(tj_ring_text(18, 8, 8)) + beta_schedule((0.1, 20.0, 8))
              + f"FTLMVectors={rows}\nFTLMSteps={steps}\n")
    K.reset_launches()
    res_d, _, _, _, wall = run_tool(ed_main, text_d, ["--ftlm"], dev)
    counts = counted("12d ed --ftlm factored 18-site t-J")
    inp_d, model_d = sector_of(text_d)
    form = F._schedule_ham(model_d, inp_d, dev)
    check(type(form).__name__ == "PermutedHamiltonian",
          f"12d form {type(form).__name__}")
    block = lz.random_start_block(form.dim, rows, ftlm_seed, f64, dev)
    empty = block.new_zeros((0, rows, form.dim))
    with tempfile.TemporaryDirectory() as tmp:
        trace = profile_step.profile_turn(
            lambda n: F._ftlm_recurrence(form.inner, block.T.contiguous(),
                                         empty, n), 5, 2,
            os.path.join(tmp, "ftlm_tj18.json"))
    parts_d = model_d.default_parts(inp_d)
    t = time.perf_counter()
    flat = model_d.hamiltonian(model_d.create_basis(parts_d), dtype=f64,
                               device=dev)
    flat_build_s = time.perf_counter() - t
    before = dict(K.LAUNCHES)
    res_f = F.ftlm(flat, res_d.betas, steps=steps,
                   start_vectors=form.to_flat(block.T).T)
    flat_counts = {n: K.LAUNCHES[n] - before[n] for n in before}
    runs["12d the flat form's FTLM"] = flat_counts
    diff = np.abs(res_d.energy - res_f.energy).max() / np.abs(
        res_f.energy).max()
    say(f"phase 12d 18-site t-J ring ed --ftlm, SolverOptions=factored, via "
        f"CLI on {dev}: dim {form.dim}, {type(form).__name__}, R {rows}, "
        f"{steps} steps, wall {wall:.3f} s, launches {counts} = "
        f"{ {n: c / steps for n, c in counts.items()} } a step; "
        f"{trace['steps']} traced steps {trace['ms_per_step']:.3f} ms a "
        f"step, idle share {trace['idle_share']:.4f}; energies against the "
        f"flat form {parts_d} (build {flat_build_s:.3f} s, launches "
        f"{flat_counts}) from the same block: max rel diff {diff:.3e} "
        f"(tolerance 1e-8)")
    check(counts["perm_gather"] > 0 and counts["factor_matmul"] > 0,
          f"12d launches {counts}")
    check(flat_counts["ell_spmv"] > 0, f"12d flat launches {flat_counts}")
    check(diff <= 1e-8, f"12d factored vs flat energies {diff:.3e}")
    # the batched kernels at R = 16 on this path's own operands
    ell_case(f"f64 18-site t-J ELL, R={rows}", flat.diag, flat.ell.cols,
             flat.ell.vals, (rows, flat.dim), TOL_ELL_F64)
    case, src, dst, tables = largest_cross_term(form.inner, "18-site t-J")
    perm_gather_case(
        results, case.replace("PermCrossTerm", f"PermCrossTerm, R={rows},"),
        torch.randn((rows, *src), generator=gen, device=dev, dtype=f64),
        torch.randn((rows, *dst), generator=gen, device=dev, dtype=f64),
        tables)
    del form, block, empty, flat, res_f, tables
    torch.cuda.empty_cache()

    # -- 12e: lanczos -g c --ftlm-dos 2.0, 12-site SuperHubbardExtended -------
    vectors_e, steps_e, beta_e, delta = 8, 100, 2.0, 0.1
    text_e = super_hubbard_text(12) + (
        f"TSPSites 2 0 0\nFTLMVectors={vectors_e}\nFTLMSteps={steps_e}\n")
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    eng, _, err, files, wall = run_tool(
        lanczos_main, text_e, ["-g", "c", "--ftlm-dos", str(beta_e), "-p",
                               "17"], dev)
    counts = counted("12e lanczos -g c --ftlm-dos 12-site")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ftlmdos = np.loadtxt(files["input.inp0.ftlmdos"].splitlines())
    grid = ftlmdos[:, 0]
    maps_s = phase_seconds(err, "ftlm operator maps")
    src_s = phase_seconds(err, "ftlm source runs")
    dst_s = phase_seconds(err, "ftlm destination runs")
    say(f"phase 12e 12-site SuperHubbardExtended lanczos -g c --ftlm-dos "
        f"{beta_e} via CLI on {dev}: dim {eng.basis.size}, R {vectors_e}, "
        f"{steps_e} steps, wall {wall:.3f} s: host operator maps {maps_s} s, "
        f"source runs {src_s} s, destination runs and operator rows on the "
        f"card {dst_s} s; launches {counts}, peak device memory {peak:.2f} "
        f"GB")
    check(counts["ell_spmv"] > 0 and counts["factor_matmul"] > 0,
          f"12e launches {counts}")
    check(len(maps_s) == len(dst_s) == 2 and len(src_s) == 1,
          f"12e phases {maps_s}, {src_s}, {dst_s}")
    block = lz.random_start_block(eng.basis.size, vectors_e, 152917, f64, dev)
    before = dict(K.LAUNCHES)
    with plain_kernels():
        plain = eng.ftlm_local_dos("c", 0, beta_e, grid, delta=delta,
                                   steps=steps_e, start_vectors=block)
    check(dict(K.LAUNCHES) == before, "12e: the plain run launched a kernel")
    diff = np.abs(ftlmdos[:, 1] - plain).max() / np.abs(plain).max()
    say(f"  .ftlmdos against the plain versions from the same block: max "
        f"rel diff {diff:.3e} (tolerance 1e-8)")
    check(diff <= 1e-8, f"12e kernel vs plain {diff:.3e}")
    # the same estimator rebuilt from its pole data (the pieces
    # ftlm_local_dos joins): its grid at beta 2 is the file's, and at
    # beta 40 its poles hold the exact sum rule of the continued fraction
    from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import (
        ftlm_dynamic, ftlm_source_runs)
    shared = ftlm_source_runs(eng.hamiltonian, block, steps_e)
    warm, cold, total, spread = (np.zeros_like(grid), np.zeros_like(grid),
                                 0.0, 0.0)
    for type_, op in enumerate((op_c.transpose_conjugate(), op_c)):
        parts, basis = eng._get_needed_basis(eng.parts, op, 0, 0)
        dyn = ftlm_dynamic(eng.hamiltonian, eng._cached_hamiltonian(parts),
                           eng._operator_rows(op, {0: 1.0}, 0, 0, basis),
                           steps=steps_e, start_vectors=block,
                           source_runs=shared)
        side = grid if type_ == 0 else -grid
        warm += dyn.evaluate(beta_e, side, delta)
        cold += dyn.evaluate(40.0, side, delta)
        weights = dyn.poles(40.0)[1]
        total += weights.sum()
        spread += np.abs(weights).sum()
    del shared
    diff = np.abs(ftlmdos[:, 1] - warm).max() / np.abs(warm).max()
    coll = files["input.inp0.comb"]
    cf_total = sum(cf.weight for cf in coll.items)
    cf = spectral_density(coll, grid, delta)
    l1 = np.trapezoid(np.abs(cold - cf), grid) / np.trapezoid(cf, grid)
    say(f"  rebuilt from its poles: at beta {beta_e} against the .ftlmdos "
        f"max rel diff {diff:.3e} (tolerance 1e-9, the file's 10 digits); "
        f"at beta 40 against -g's continued fraction (T = 0): total pole "
        f"weight {float(total)!r} against the fraction's {cf_total!r} (both "
        f"<c c^+> + <c^+ c> = 1 exactly; tolerance 1e-10), sum of |weight| "
        f"{spread:.3f}; the curves at delta {delta} differ by an L1 "
        f"distance {l1:.3f} of the fraction's weight, not held to a "
        f"tolerance: the estimator's O(1/sqrt(R)) noise as T -> 0 (0.67-1.24 "
        f"at R = 8 on the 8-site chain on the CPU)")
    check(diff <= 1e-9, f"12e rebuilt curve against the file {diff:.3e}")
    check(abs(total - 1.0) <= 1e-10 and abs(cf_total - 1.0) <= 1e-10,
          f"12e sum rules {total!r}, {cf_total!r}")
    del eng, block, plain, warm, cold
    torch.cuda.empty_cache()

    # -- 12f: the small command lines, card against CPU ----------------------
    cpu = torch.device("cpu")
    draw = lz.random_start_block

    def card_draws(dim, num, seed, dtype, device):
        """The CPU runs take the card's draws (the card's generator is
        not the CPU's)."""
        return draw(dim, num, seed, dtype, dev).to(device)

    def both(label, module, text, args, kernels):
        K.reset_launches()
        card = run_tool(module, text, args, dev)
        counts = counted(f"12f {label}")
        check(all(counts[k] > 0 for k in kernels),
              f"12f {label}: launches {counts}")
        lz.random_start_block = card_draws
        try:
            host = run_tool(module, text, args, cpu)
        finally:
            lz.random_start_block = draw
        return card, host, counts

    def agree(label, got, want, tol):
        err = np.abs(np.asarray(got) - np.asarray(want)).max() / max(
            np.abs(np.asarray(want)).max(), 1e-300)
        say(f"phase 12f {label}: card against CPU max rel diff {err:.3e} "
            f"(tolerance {tol:g})")
        check(err <= tol, f"12f {label}: {err:.3e}")

    hub6 = hubbard_chain_text(6, 4, periodic=0).replace(
        "potentialV 12 0 0", "potentialV 12 0.1 -0.2")
    therm = ["-b", "1.3", "-m", "0.4", "-c", "c", "-s", "0,1"]
    (gc, _, _, _, _), (gc_cpu, _, _, _, _), counts = both(
        "thermal full spectra 6 sites", thermal_main, hub6, therm, ())
    poles, total = gc.correlation_poles("c", (0, 1), 0, 1.3, 0.4)
    poles_cpu, total_cpu = gc_cpu.correlation_poles("c", (0, 1), 0, 1.3, 0.4)
    agree("thermal full spectra 6 sites (Z, density, energy, pole sum)",
          [gc.partition(1.3, 0.4), gc.density(1.3, 0.4),
           gc.energy(1.3, 0.4), total],
          [gc_cpu.partition(1.3, 0.4), gc_cpu.density(1.3, 0.4),
           gc_cpu.energy(1.3, 0.4), total_cpu], 1e-10)
    (gf, _, _, _, _), (gf_cpu, _, _, _, _), counts = both(
        "thermal --ftlm 6 sites", thermal_main,
        hub6 + "FTLMVectors=8\nFTLMSteps=30\n", ["-b", "1.3", "--ftlm"],
        ("factor_matmul",))
    agree("thermal --ftlm 6 sites (ln Z, density, energy, Cv)",
          [gf.log_partition(1.3, 0.0), gf.density(1.3, 0.0),
           gf.energy(1.3, 0.0), gf.specific_heat(1.3, 0.0)],
          [gf_cpu.log_partition(1.3, 0.0), gf_cpu.density(1.3, 0.0),
           gf_cpu.energy(1.3, 0.0), gf_cpu.specific_heat(1.3, 0.0)], 1e-8)
    (sq, _, _, _, _), (sq_cpu, _, _, _, _), counts = both(
        "sqomega 10-site Heisenberg ring", sqomega_main,
        heisenberg_ring_text(10), ["-b", "-1", "-e", "5", "-s", "0.05",
                                   "-d", "0.1"], ("ell_spmv",))
    agree("sqomega 10-site Heisenberg ring S(q, omega)", sq[1], sq_cpu[1],
          1e-8)
    refs["sqomega"] = sq[1]
    feas = feas_ring_text(4, 2, 2)
    (cf1, _, _, _, _), (cf1_cpu, _, _, _, _), counts = both(
        "dynamics1 4-site FeAs", dynamics1_main, feas, ["-r", "1"],
        ("factor_matmul", "ell_spmv"))
    omegas = np.linspace(-2.0, 8.0, 201)
    agree("dynamics1 4-site FeAs G(omega + 0.1i)",
          cf1.evaluate(omegas, 0.1), cf1_cpu.evaluate(omegas, 0.1), 1e-8)
    (qz, _, _, _, _), (qz_cpu, _, _, _, _), counts = both(
        "qpz 6-site chain", qpz_main, hub6, ["--ratio"], ("factor_matmul",))
    # both ground states are Lanczos vectors converged to a 1e-10 residual
    agree("qpz 6-site chain Z(k)", [z for _, z in qz],
          [z for _, z in qz_cpu], 1e-8)
    # lorentzian is host code: its printed grid against broadening's
    from lanczosplusplus_tpu_torch.engine.broadening import lorentzian_grid
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poles.txt")
        np.savetxt(path, np.asarray(poles))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lorentzian_main.run(["-f", path, "-t", "200", "-m", "real",
                                 "-e", "0.1"])
    printed = np.loadtxt(out.getvalue().splitlines())
    om, g = lorentzian_grid(*np.asarray(poles).T, 200, eps=0.1)
    agree("lorentzian of the card's thermal poles (printed against "
          "broadening.lorentzian_grid)", printed,
          np.stack([om, g.real, g.imag], axis=1), 1e-10)

    # -- the batched factor_matmul forms at the estimators' R = 16 ------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    batched_factor_cases(results, gen, dev, sms, rows, 3432, 3432)
    say(f"estimator path kernel launches: "
        f"{ {label: c for label, c in runs.items()} }")
    return runs


def ainur_text(nsite: int, u: float) -> str:
    """``hubbard_chain_text(nsite, u)`` (half filled, periodic) in the
    Ainur form: the same labels, with geometry labels per term."""
    return (f'##Ainur1.0\nTotalNumberOfSites={nsite};\nNumberOfTerms=1;\n'
            'gt0:DegreesOfFreedom=1;\ngt0:GeometryKind="chain";\n'
            'gt0:GeometryOptions="ConstantValues";\n'
            'gt0:dir0:Connectors=[-1.0];\nModel="HubbardOneBand";\n'
            f'vector hubbardU=[{", ".join([str(u)] * nsite)}];\n'
            f'vector potentialV=[{", ".join(["0"] * 2 * nsite)}];\n'
            'SolverOptions="none";\n'
            f'TargetElectronsUp={nsite // 2};\n'
            f'TargetElectronsDown={nsite // 2};\nIsPeriodicX=1;\n')


@contextlib.contextmanager
def numpy_host_paths():
    """Within this block the native host runtime is absent: enumeration,
    ranking and the one-spin hop maps take their numpy paths."""
    from lanczosplusplus_tpu_torch import native
    load = native.load
    native.load = lambda: None
    try:
        yield
    finally:
        native.load = load


def host_paths(calls) -> str:
    """Which path built a run's bases and hop maps, from native_calls'
    counts."""
    return f"the native runtime {calls}" if calls else "numpy"


@contextlib.contextmanager
def native_calls():
    """Counts the calls into the native host runtime made inside the
    block, by entry point: which path built each basis and hop map."""
    from lanczosplusplus_tpu_torch import native
    counts = {}
    saved = {}
    for name in ("enumerate_combinations", "one_spin_hop_ell",
                 "rank_combinations"):
        fn = saved[name] = getattr(native, name)

        def counted(*args, _fn=fn, _name=name):
            made = _fn(*args)
            if made is not None:
                counts[_name] = counts.get(_name, 0) + 1
            return made
        setattr(native, name, counted)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def cli_phase(dev, refs, ell_case):
    """Phase 13: the last command lines and input forms and the native
    host runtime on the card, each run with the launch counts set to 0
    before and read after: 13a consistency --tinf on phase 5's 14-site U=4
    chain (E0 against phase 5's, the T=inf energy against U N_up N_dn / L)
    and 13b on phase 9's 24-site Heisenberg ring (E0 against phase 9's,
    T=inf against L (M^2 - L) / (4 L (L - 1)) with M = N_up - N_dn), both
    past the dense branch; 13c the 16-site ring in the dense branch on the
    card (Lanczos against the dense eigenvalue, the dense mean against its
    closed form) and ell_spmv on its ELL; 13d spin_orbital_main 6 1 and 4
    on the card against their --device cpu runs, and ell_spmv on the
    7-site chain's ELL; 13e the Ainur form of phase 5's input through
    lanczos -f (its parsed labels against the legacy form's, E0 against
    phase 5's); 13f the sector files of the 6-site Hubbard chain written
    on the card and on the CPU and read back (eigenvalues, operator
    matrices, Z against GrandCanonical.partition); 13g phase 10's 20-site
    sector's basis and up-form hop map built through the native host
    runtime and through the numpy paths (bit-equal words, ranks and ELL
    arrays, both times, the binding's share of the sector's set-up) and
    the C(24, 12) enumeration both ways; 13h phase 12b's LTLM (14 sites, R
    = 4, 150 steps) on the card with its peak device memory beside its
    reckoning, against the same block through the plain versions.
    Returns ({case: launches}, the native runtime's numbers)."""
    from lanczosplusplus_tpu_torch import native
    from lanczosplusplus_tpu_torch.cli import (
        consistency_main, lanczos_main, spin_orbital_main)
    from lanczosplusplus_tpu_torch.core import combinatorics as C
    from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis
    from lanczosplusplus_tpu_torch.core.sparse import one_spin_ell
    from lanczosplusplus_tpu_torch.engine import ftlm as F
    from lanczosplusplus_tpu_torch.engine.thermal import GrandCanonical
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_ import sector_files
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.hubbard import directed_bonds
    from lanczosplusplus_tpu_torch.models.spin_orbital import (
        build_spin_orbital)
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    runs = {}
    cpu = torch.device("cpu")
    check(native.available(), "the native host runtime did not build")
    say(f"phase 13 native host runtime: {native.build().name}, built from "
        f"{os.path.relpath(native.SOURCE)} with g++ {' '.join(native.CXX_FLAGS)}")

    def sector_of(text):
        inp = parse_input(text)
        return inp, build_model(inp, Geometry(inp))

    def consistency(label, text, kernel):
        """consistency --tinf through its run() on the card: the printed
        values by label, the wall seconds and the native calls."""
        K.reset_launches()
        with native_calls() as calls:
            e0, out, _, _, wall = run_tool(consistency_main, text,
                                           ["--tinf"], dev)
        runs[label] = dict(K.LAUNCHES)
        got = {key: float(value) for key, value in
               re.findall(r"^(.+?)= (\S+)$", out, re.M)}
        check(got["Lanczos: lowest eigenvalue"] == float(e0),
              f"{label}: printed {got}, returned {e0!r}")
        check(runs[label][kernel] > 0, f"{label}: launches {runs[label]}")
        return got, wall, calls

    def rel(got, want):
        return abs(got - want) / abs(want)

    # -- 13a, 13b: consistency --tinf past the dense branch ----------------
    for label, text, e0, tinf, kernel in (
            ("13a consistency --tinf 14-site U=4", hubbard_chain_text(14, 4),
             refs["e0_u4"], 4.0 * 7 * 7 / 14, "factor_matmul"),
            ("13b consistency --tinf 24-site Heisenberg",
             heisenberg_ring_text(24), refs["24-site Heisenberg ring"],
             24 * (0 - 24) / (4.0 * 24 * 23), "ell_spmv")):
        got, wall, calls = consistency(label, text, kernel)
        e_err = rel(got["Lanczos: lowest eigenvalue"], e0)
        t_err = rel(got["T=infinity energy"], tinf)
        say(f"phase {label} via CLI on {dev}: Lanczos E0 "
            f"{got['Lanczos: lowest eigenvalue']!r} against the earlier "
            f"phase's {e0!r} (rel {e_err:.3e}, tolerance 1e-10); T=inf "
            f"energy (the diagonal's mean) {got['T=infinity energy']!r} "
            f"against the closed form {tinf!r} (rel {t_err:.3e}, tolerance "
            f"1e-12); wall {wall:.3f} s, launches {runs[label]}, basis and "
            f"maps built by {host_paths(calls)}")
        check("Lapack: lowest eigenvalue" not in got,
              f"{label}: took the dense branch")
        check(e_err <= 1e-10, f"{label}: E0 rel err {e_err:.3e}")
        check(t_err <= 1e-12, f"{label}: T=inf rel err {t_err:.3e}")

    # -- 13c: the dense branch on the card -----------------------------------
    label = "13c consistency --tinf 16-site Heisenberg"
    text16 = heisenberg_ring_text(16)
    got, wall, _ = consistency(label, text16, "ell_spmv")
    tinf = 16 * (0 - 16) / (4.0 * 16 * 15)
    t_err = rel(got["T=infinity energy"], tinf)
    say(f"phase {label} via CLI on {dev} (dim 12870, the dense branch): "
        f"Lanczos {got['Lanczos: lowest eigenvalue']!r}, dense "
        f"{got['Lapack: lowest eigenvalue']!r}, |difference| "
        f"{got['|difference|']:.3e} (tolerance 1e-10); T=inf energy (the "
        f"dense mean) {got['T=infinity energy']!r} against {tinf!r} (rel "
        f"{t_err:.3e}, tolerance 1e-10); wall {wall:.3f} s, launches "
        f"{runs[label]}")
    check(got["|difference|"] <= 1e-10, f"13c |difference| {got}")
    check(t_err <= 1e-10, f"13c T=inf rel err {t_err:.3e}")
    inp16, model16 = sector_of(text16)
    ham = model16.hamiltonian(model16.create_basis(
        model16.default_parts(inp16)), device=dev)
    ell_case("f64 16-site Heisenberg ELL (consistency), R=1", ham.diag,
             ham.ell.cols, ham.ell.vals, (ham.dim,), TOL_ELL_F64)
    del ham

    # -- 13d: spin_orbital_main, card against CPU ----------------------------
    def spin_orbital(args, device):
        out = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            energies = spin_orbital_main.run([*args, "--device", str(device)])
        torch.cuda.synchronize()
        check(re.fullmatch(r"Lanczos energy=\S+\nLAPACK energy=\S+\n",
                           out.getvalue()) is not None,
              f"spin_orbital {args}: printed {out.getvalue()!r}")
        return energies, time.perf_counter() - t

    # 6 sites, not 7, against the CPU: the 7-site chain's --device cpu run
    # (a dense eigvalsh at dim 16 384 on the host) took 50-70 s, and with it
    # the whole run came to 1232 s of its 1200 s limit on a loaded host;
    # the card's ELL case below keeps the 7-site chain
    for args, dim in ((["6", "1"], 4096), (["4"], 6561)):
        label = f"13d spin_orbital {' '.join(args)}"
        K.reset_launches()
        card, wall = spin_orbital(args, dev)
        runs[label] = dict(K.LAUNCHES)
        host, host_wall = spin_orbital(args, cpu)
        lz_err = rel(card[0], card[1])
        cpu_err = max(rel(c, h) for c, h in zip(card, host))
        say(f"phase {label} on {dev} (dim {dim}): Lanczos {card[0]!r}, "
            f"dense {card[1]!r} (rel {lz_err:.3e}, tolerance 1e-9); against "
            f"the --device cpu run {host} max rel {cpu_err:.3e} (tolerance "
            f"1e-10); wall {wall:.3f} s on the card, {host_wall:.3f} s on "
            f"the CPU; launches {runs[label]}")
        check(lz_err <= 1e-9, f"{label}: Lanczos against dense {lz_err:.3e}")
        check(cpu_err <= 1e-10, f"{label}: card against CPU {cpu_err:.3e}")
        check(runs[label]["ell_spmv"] > 0, f"{label}: launches {runs[label]}")
    ham = build_spin_orbital(7, 1, device=dev)
    ell_case("f64 7-site spin-orbital ELL, R=1", ham.diag, ham.ell.cols,
             ham.ell.vals, (ham.dim,), TOL_ELL_F64)
    del ham

    # -- 13e: Ainur input through lanczos -f ---------------------------------
    label = "13e lanczos -f Ainur 14-site U=4"
    ainur = ainur_text(14, 4)
    same = parse_input(ainur).entries == parse_input(
        hubbard_chain_text(14, 4)).entries
    K.reset_launches()
    eng, out, _, _, wall = run_cli(lanczos_main, ainur)
    runs[label] = dict(K.LAUNCHES)
    e_err = rel(eng.ground_energy, refs["e0_u4"])
    say(f"phase {label} via CLI on {dev}: parsed labels equal the legacy "
        f"form's {same}; E0 {eng.ground_energy!r} against phase 5's "
        f"{refs['e0_u4']!r} (rel {e_err:.3e}, tolerance 1e-12); wall "
        f"{wall:.3f} s, launches {runs[label]}")
    check(same, "13e: the Ainur form parses to other labels")
    check(e_err <= 1e-12, f"13e E0 rel err {e_err:.3e}")
    check(runs[label]["factor_matmul"] > 0, f"13e launches {runs[label]}")
    del eng

    # -- 13f: sector files, card against CPU ---------------------------------
    label = "13f sector files 6-site Hubbard"
    _, model6 = sector_of(hubbard_chain_text(6, 4))
    read, walls = {}, {}
    K.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for where, device in (("card", dev), ("cpu", cpu)):
            path = os.path.join(tmp, f"sectors_{where}.dat")
            torch.cuda.synchronize()
            t = time.perf_counter()
            count = sector_files.write_all_sectors(path, model6, 6,
                                                   device=device)
            torch.cuda.synchronize()
            walls[where] = time.perf_counter() - t
            read[where] = sector_files.read_sectors(path)
            check(len(read[where]) == count == 49,
                  f"13f: {count} sectors on {device}")
    runs[label] = dict(K.LAUNCHES)
    card, host = read["card"], read["cpu"]
    ev_err = max(np.abs(s["evals"] - h["evals"]).max()
                 for s, h in zip(card, host))
    ops_equal = all(
        s["parts"] == h["parts"] and s["operators"].keys() ==
        h["operators"].keys() and all(
            s["operators"][k][0] == h["operators"][k][0]
            and np.array_equal(s["operators"][k][1], h["operators"][k][1])
            for k in s["operators"]) for s, h in zip(card, host))
    beta, mu = 1.1, 0.3
    z_file = sum(np.exp(beta * (mu * sum(s["parts"]) - s["evals"])).sum()
                 for s in card)
    z_gc = GrandCanonical(model6, nsite=6, device=dev).partition(beta, mu)
    z_err = rel(z_file, z_gc)
    say(f"phase {label}: 49 sectors written on {dev} in "
        f"{walls['card']:.3f} s and on the CPU in {walls['cpu']:.3f} s; "
        f"eigenvalues max abs diff {ev_err:.3e} (tolerance 1e-10), "
        f"operator matrices equal {ops_equal}; Z(beta {beta}, mu {mu}) "
        f"from the card's file {float(z_file)!r} against GrandCanonical.partition "
        f"{z_gc!r} (rel {z_err:.3e}, tolerance 1e-9); launches {runs[label]} "
        f"(eigh is the library's)")
    check(ev_err <= 1e-10, f"13f eigenvalues {ev_err:.3e}")
    check(ops_equal, "13f operator matrices differ")
    check(z_err <= 1e-9, f"13f Z rel err {z_err:.3e}")

    # -- 13g: the native host runtime against the numpy paths ----------------
    nsite, nup, ndn = 20, 10, 2
    inp20, model20 = sector_of(hubbard_chain_text(nsite, 4, nup, ndn))
    bonds = directed_bonds(model20.hoppings)
    table = C.binomial_table(64 + 1)
    timings = {}

    def timed(key, fn, *args):
        t = time.perf_counter()
        made = fn(*args)
        timings[key] = time.perf_counter() - t
        return made

    def setup(key):
        """The 20-site sector's set-up as the Engine does it: basis, then
        the Hamiltonian on the card (diagonal, hop maps, transfer)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        basis = model20.create_basis(model20.default_parts(inp20))
        ham = model20.hamiltonian(basis, device=dev)
        torch.cuda.synchronize()
        timings[key] = time.perf_counter() - t
        return basis, ham

    with native_calls() as calls:
        basis = timed("basis native", OneSpinBasis, nsite, nup)
        ranks = timed("rank native", native.rank_combinations, basis.words,
                      table)
        ell = timed("hop map native", one_spin_ell, basis.words, basis.rank,
                    bonds, np.float64)
        words24 = timed("C(24,12) native", C.enumerate_combinations, 24, 12)
    check(calls == {"enumerate_combinations": 2, "one_spin_hop_ell": 1,
                    "rank_combinations": 1},
          f"13g native calls {calls}")
    with numpy_host_paths():
        basis_np = timed("basis numpy", OneSpinBasis, nsite, nup)
        ranks_np = timed("rank numpy", C.rank_combinations, basis_np.words,
                         nsite)
        ell_np = timed("hop map numpy", one_spin_ell, basis_np.words,
                       basis_np.rank, bonds, np.float64)
        words24_np = timed("C(24,12) numpy", C.enumerate_combinations, 24, 12)
        setup("sector set-up numpy")
    native_s = {"enumerate": [], "hop": []}
    with native_calls() as calls, \
            timed_calls(native, "enumerate_combinations",
                        native_s["enumerate"]), \
            timed_calls(native, "one_spin_hop_ell", native_s["hop"]):
        _, ham20 = setup("sector set-up native")
    share = sum(map(sum, native_s.values())) / timings["sector set-up native"]
    equal = (np.array_equal(basis.words, basis_np.words)
             and np.array_equal(ranks, ranks_np)
             and np.array_equal(ranks, np.arange(basis.size))
             and np.array_equal(ell[0], ell_np[0])
             and np.array_equal(ell[1], ell_np[1])
             and np.array_equal(words24, words24_np))
    say(f"phase 13g 20-site sector, N_up {nup} ({basis.size} up words, "
        f"{len(bonds)} directed bonds), N_dn {ndn}: words, ranks and the up "
        f"hop map's ELL columns and values equal bit for bit {equal}; "
        f"native against numpy: basis {timings['basis native']:.4f} / "
        f"{timings['basis numpy']:.4f} s, ranks {timings['rank native']:.4f} "
        f"/ {timings['rank numpy']:.4f} s, hop map "
        f"{timings['hop map native']:.4f} / {timings['hop map numpy']:.4f} "
        f"s; the sector's set-up (basis, Hamiltonian on the card, dim "
        f"{ham20.dim}) {timings['sector set-up native']:.3f} s with the "
        f"binding ({host_paths(calls)}), "
        f"{timings['sector set-up numpy']:.3f} s without; "
        f"the binding's share of it {share:.4f}; C(24, 12) enumeration "
        f"({words24.shape[0]} words) {timings['C(24,12) native']:.4f} / "
        f"{timings['C(24,12) numpy']:.4f} s")
    check(equal, "13g: the native and numpy builds differ")
    check(ham20.dim == 35_103_640, f"13g dim {ham20.dim}")
    del ham20, basis, basis_np, ell, ell_np
    torch.cuda.empty_cache()
    native_line = dict(
        library=native.build().name, available=native.available(),
        sector="20-site Hubbard chain, N_up 10, N_dn 2",
        seconds={key: value for key, value in timings.items()},
        binding_share_of_setup=share, bit_equal=equal)

    # -- 13h: LTLM's memory after the repair -----------------------------------
    label = "13h ltlm 14-site U=4"
    rows, steps = 4, 150
    inp_h, model_h = sector_of(hubbard_chain_text(14, 4))
    ham_h = F._schedule_ham(model_h, inp_h, dev)
    betas = np.asarray([0.5, 500.0])
    block = lz.random_start_block(ham_h.dim, rows, 982451653, torch.float64,
                                  dev)
    reckoned = F.ltlm_bytes(ham_h.dim, steps, rows, ham_h.dtype)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    t = time.perf_counter()
    out = F.ltlm(ham_h, betas, {"energy": ham_h}, steps=steps,
                 start_vectors=block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs[label] = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) - held
    before = dict(K.LAUNCHES)
    t = time.perf_counter()
    with plain_kernels():
        out_p = F.ltlm(ham_h, betas, {"energy": ham_h}, steps=steps,
                       start_vectors=block)
    plain_s = time.perf_counter() - t
    check(dict(K.LAUNCHES) == before, "13h: the plain run launched a kernel")
    diff = np.abs(out["energy"] - out_p["energy"]).max() / np.abs(
        out_p["energy"]).max()
    say(f"phase {label} on {dev}: R {rows}, {steps} steps, wall {wall:.3f} "
        f"s, launches {runs[label]}; peak device memory above what was held "
        f"before {peak / 1e9:.2f} GB against the reckoning "
        f"{reckoned / 1e9:.2f} GB (basis, start block, a 16-row image chunk, "
        f"four work vectors) and 44.25 GB before the repair (the whole image "
        f"of a run, kept into the next run); "
        f"energies {[float(e) for e in out['energy']]} against the same "
        f"block through the plain versions max rel diff {diff:.3e} "
        f"(tolerance 1e-8, plain {plain_s:.3f} s)")
    check(peak <= reckoned, f"13h peak {peak} above the reckoning {reckoned}")
    check(diff <= 1e-8, f"13h kernel vs plain energies {diff:.3e}")
    check(runs[label]["factor_matmul"] > 0, f"13h launches {runs[label]}")
    del ham_h, block
    torch.cuda.empty_cache()
    return runs, native_line


class ChunkInterrupt(Exception):
    """Raised by ``interrupted_after`` in place of a Lanczos chunk."""


@contextlib.contextmanager
def interrupted_after(lz, chunks: int):
    """Within the block, the solver's chunk runner raises ChunkInterrupt
    once `chunks` chunks have run: a run stopped between two checkpoint
    writes."""
    fn = lz._lanczos_chunk
    calls = [0]

    def limited(*args, **kwargs):
        if calls[0] >= chunks:
            raise ChunkInterrupt
        calls[0] += 1
        return fn(*args, **kwargs)
    lz._lanczos_chunk = limited
    try:
        yield
    finally:
        lz._lanczos_chunk = fn


@contextlib.contextmanager
def solve_record(lz, refinements: list, chunks: list,
                 coefficients: list | None = None):
    """Records, within the block, every energy refinement of the solver
    (the energies it was given, those it returned, seconds, the card
    synchronized at both ends) and every chunk of Lanczos steps (steps,
    whether selective), and into `coefficients`, where given, the chunks'
    (alphas, betas)."""
    refine, chunk = lz._maybe_refine, lz._lanczos_chunk

    def timed(ham, evals, vecs, twin=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = refine(ham, evals, vecs, twin)
        torch.cuda.synchronize()
        refinements.append((np.array(evals, dtype=np.float64),
                            np.array(out, dtype=np.float64),
                            time.perf_counter() - t))
        return out

    def counted(ham, V, carry, js, selective):
        chunks.append((len(js), selective))
        out = chunk(ham, V, carry, js, selective)
        if coefficients is not None:
            coefficients.append((list(out[1]), list(out[2])))
        return out
    lz._maybe_refine, lz._lanczos_chunk = timed, counted
    try:
        yield
    finally:
        lz._maybe_refine, lz._lanczos_chunk = refine, chunk


def lowprec_phase(dev, gen, results, refs, ell_case):
    """Phase 14: the float32 (complex64) solves with their float64
    refinement, the bf16 forms and the low-precision, resumable Krylov
    basis on the card, each solve with the launch counts set to 0 before
    and read after, by kernel and form: 14a lanczos -f --dtype float32 on
    phase 5's 14-site U=4 chain (the unrefined and refined E0 against phase
    5's, 1e-10); 14b phase 6's 12-site SuperHubbardExtended chain in
    float32 (the J-ELL through the float32 ell_spmv) against phase 6's;
    14c bench.py's 13-site real Rashba ring through lanczos -f with
    SolverOptions=factored,bf16cross at float64 and float32 (the
    bf16-source perm_gather, full reorthogonalization) against phase 10's
    factored E0 to 1e-8 absolute; 14d phase 10's 18-site t-J factored form
    in float32 and its 12-site complex Rashba form in complex64 against
    phase 10's E0s; 14e phase 11's 22-site Kitaev ring with bf16 factors
    from build_factored_kitaev(factor_dtype=torch.bfloat16) (its matvec
    against the float32 form's, 2e-2 of max |y|; its refined E0 beside the
    float64 one); 14f 80 float32 steps on 14a's sector with a float32 and
    a bf16 basis (lowest Ritz values within 2e-3, peak memory), and 100
    steps on 14b's sector checkpointed every 25, stopped after two chunks
    and resumed, bit-equal to an uninterrupted run; 14g each new kernel
    form alone against its plain version and one library call; 14h 14a's
    chain with bf16 dense factors from
    densify_factors(factor_dtype=torch.bfloat16) under a float32 and a
    float64 state (the matvec against the unquantized form's, 1e-2 of max
    |y|; the refined E0 against phase 5's, 1e-10).
    Returns {run label: launches by kernel and form}."""
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.cli import lanczos_main
    from lanczosplusplus_tpu_torch.engine import Engine
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        build_factored_kitaev)
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.ops.refine import narrowed
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    runs, above, repacks, coefficients = {}, {}, {}, {}

    def rel(a, b):
        return abs(a - b) / abs(b)

    def solved(label, run):
        """Runs run() with the launch counts set to 0 before and read
        after; returns (what it returns, its refinements, its chunks of
        steps, wall seconds); its bf16 repacks go to ``repacks[label]``,
        its Lanczos coefficients to ``coefficients[label]``.  The device
        memory the run took above what was held before it goes to
        ``above[label]`` (GB)."""
        refinements, chunks = [], []
        coefficients[label] = []
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        with solve_record(lz, refinements, chunks, coefficients[label]):
            got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[label] = dict(K.FORM_LAUNCHES)
        repacks[label] = dict(K.REPACKS)
        above[label] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        return got, refinements, chunks, wall

    def engine(text, real_dtype):
        inp = parse_input(text)
        return Engine(build_model(inp, Geometry(inp)), inp,
                      config=Config.from_input(inp, device=dev,
                                               real_dtype=real_dtype))

    def report(key, label, eng, refinements, chunks, wall, want, tol):
        """One line for the solve of run `key`: steps, unrefined and
        refined E0 against `want`, the solve's and the refinement's
        seconds, launches by form; held to `tol` (relative)."""
        (unrefined, refined, refine_s), = refinements
        e0 = eng.ground_energy
        err = rel(e0, want)
        reorth = ("full on every step" if not any(s for _, s in chunks)
                  else "selective")
        say(f"phase 14{key} {label}: dim {eng.basis.size}, "
            f"{eng.eigenvector(0).dtype}, steps {eng.solve_info.steps}, "
            f"reorthogonalization {reorth}, unrefined E0 {float(unrefined[0])!r}, "
            f"refined E0 {e0!r} against {want!r}: rel err {err:.3e} "
            f"(unrefined {rel(unrefined[0], want):.3e}); wall {wall:.3f} s, of "
            f"which the refinement {refine_s:.3f} s; launches by form "
            f"{runs[key]}; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
            f"{above[key]:.2f} GB above what was held before the run")
        check(refined[0] == e0, f"14{key}: the engine's energy is not the "
                                f"refined one")
        check(err <= tol, f"14{key}: E0 off by {err:.3e} > {tol:g}")

    # -- 14a: lanczos -f --dtype float32, the 14-site U=4 chain ----------
    (eng, out, _, _, _), refinements, chunks, wall = solved(
        "a", lambda: run_cli(lanczos_main, hubbard_chain_text(14, 4),
                             ["--dtype", "float32"]))
    printed = float(re.search(r"^Energy=(\S+)$", out, re.M).group(1))
    check(printed == eng.ground_energy, f"14a: printed {printed!r}")
    report("a", "14-site U=4 chain via lanczos -f --dtype float32", eng,
           refinements, chunks, wall, refs["e0_u4"], TOL_E0)
    (unrefined, _, _), = refinements
    alphas = [a for chunk, _ in coefficients["a"] for a in chunk]
    betas = [b for _, chunk in coefficients["a"] for b in chunk]
    say(f"phase 14a float32 solve before its refinement: unrefined E0 "
        f"{float(unrefined[0])!r}; first Lanczos coefficients alpha "
        f"{[float(a) for a in alphas[:5]]!r}, beta "
        f"{[float(b) for b in betas[:5]]!r}; {len(alphas)} steps")
    forms = runs["a"]
    check(forms.get("factor_matmul f32", 0) > 0
          and forms.get("factor_matmul f64", 0) > 0,
          f"14a: the float32 solve and its float64 refinement launched "
          f"{forms}")
    ham14 = eng.hamiltonian
    dense = getattr(ham14.factorized.up_dense, "dtype", None)
    check(ham14.dtype == f32 and dense == f32,
          f"14a: the solved form is {ham14.dtype}, its dense factors {dense}")
    check(eng._ham64 is None, "14a: the float64 form outlived the solve")
    model14, basis14 = eng.model, eng.basis
    del eng

    # -- 14h: the chain with bf16 dense factors, float32 and float64 ----
    x = torch.randn(ham14.dim, generator=gen, device=dev, dtype=f64)
    for dtype, plain in ((f32, ham14), (f64, refs["ham_u4"])):
        tag = DTYPE_TAGS[dtype]
        key = f"h {tag}"
        t = time.perf_counter()
        hb = model14.hamiltonian(basis14, dtype=dtype,
                                 device=dev).densify_factors(
            factor_dtype=bf16)
        build_s = time.perf_counter() - t
        f = hb.factorized
        check(hb.quantized and hb.dtype == dtype
              and f.up_dense.dtype == f.dn_dense.dtype == bf16,
              f"14h {tag}: quantized {hb.quantized}, {hb.dtype}, factors "
              f"{f.up_dense.dtype} and {f.dn_dense.dtype}")
        mv_err = rel_err(hb.matvec(x.to(dtype)), plain.matvec(x.to(dtype)))[1]
        (evals, _, info), refinements, chunks, wall = solved(
            key, lambda: lz.lowest_states(hb, seed=SEED, return_info=True))
        (unrefined, refined, refine_s), = refinements
        full = not any(s for _, s in chunks)
        err = rel(float(evals[0]), refs["e0_u4"])
        say(f"phase 14h 14-site U=4 chain, bf16 dense one-spin factors "
            f"(densify_factors(factor_dtype=torch.bfloat16)), {dtype} state:"
            f" dim {hb.dim}, factors {tuple(f.up_dense.shape)} and "
            f"{tuple(f.dn_dense.shape)}, host build {build_s:.3f} s; matvec "
            f"against the unquantized form's {mv_err:.3e} of max |y| "
            f"(tolerance 1e-2); steps {info.steps} (reorthogonalization "
            f"{'full on every step' if full else 'selective'}), unrefined "
            f"E0 {float(unrefined[0])!r}, refined {float(evals[0])!r} "
            f"against phase 5's {refs['e0_u4']!r}: rel err {err:.3e} "
            f"(unrefined {rel(float(unrefined[0]), refs['e0_u4']):.3e}); "
            f"wall {wall:.3f} s, of which the refinement {refine_s:.3f} s; "
            f"launches by form {runs[key]}; {above[key]:.2f} GB of device "
            f"memory above what was held before the run")
        check(mv_err <= 1e-2, f"14h {tag}: bf16 matvec off by {mv_err:.3e}")
        check(float(refined[0]) == float(evals[0]) and err <= TOL_E0,
              f"14h {tag}: E0 off by {err:.3e}")
        check(full and runs[key].get(f"factor_matmul bf16_{tag}", 0) > 0,
              f"14h {tag}: full reorthogonalization {full}, {runs[key]}")
        say(f"phase 14h {tag}: bf16 operands repacked for TMA "
            f"{repacks[key]} (none expected)")
        check(not repacks[key], f"14h {tag}: bf16 repacks {repacks[key]}")
        del hb, f
    del model14, basis14, x, plain
    torch.cuda.empty_cache()

    # -- 14b: the 12-site SuperHubbardExtended chain in float32 ---------
    eng, refinements, chunks, wall = solved(
        "b", lambda: engine(super_hubbard_text(12), f32))
    report("b", "12-site SuperHubbardExtended chain in float32", eng,
           refinements, chunks, wall, refs["e0_she"], TOL_E0)
    check(runs["b"].get("ell_spmv f32", 0) > 0,
          f"14b: no float32 ell_spmv: {runs['b']}")
    she32 = eng.hamiltonian
    del eng

    # -- 14c: bf16cross, 13-site Rashba half-cut, float64 and float32 ----
    text = rashba_ring_text(13, 13, amplitude="0.5",
                            options="factored,bf16cross")
    want = refs["factored 13-site Rashba ring, 13 electrons"]
    rashba_cross = {}
    for dtype in ("float64", "float32"):
        label = f"c {dtype}"
        (eng, out, _, _, _), refinements, chunks, wall = solved(
            label, lambda: run_cli(lanczos_main, text, ["--dtype", dtype]))
        printed = float(re.search(r"^Energy=(\S+)$", out, re.M).group(1))
        form = eng._cached_hamiltonian(eng.parts).inner
        (unrefined, refined, refine_s), = refinements
        err = abs(printed - want)
        full = not any(s for _, s in chunks)
        bf16_launches = runs[label].get(
            f"perm_gather bf16_{'f64' if dtype == 'float64' else 'f32'}", 0)
        say(f"phase 14c 13-site Rashba ring, SolverOptions=factored,bf16cross"
            f" via lanczos -f --dtype {dtype}: dim {form.dim}, {form.dtype}, "
            f"quantized {form.quantized}, steps {eng.solve_info.steps} "
            f"(reorthogonalization {'full on every step' if full else 'selective'}"
            f", {sum(n for n, _ in chunks)} steps in {len(chunks)} chunks), "
            f"Energy={printed!r} (unrefined {float(unrefined[0])!r}) against phase "
            f"10's {want!r}: abs err {err:.3e}; wall {wall:.3f} s, of which "
            f"the refinement {refine_s:.3f} s; bf16-source perm_gather "
            f"launches {bf16_launches}, launches by form {runs[label]}")
        check(printed == eng.ground_energy == refined[0],
              f"14c {dtype}: printed {printed!r}")
        check(err <= 1e-8, f"14c {dtype}: E0 off by {err:.3e}")
        check(form.quantized and full and bf16_launches > 0,
              f"14c {dtype}: quantized {form.quantized}, full "
              f"reorthogonalization {full}, launches {runs[label]}")
        rashba_cross[form.dtype] = largest_cross_term(
            form, "13-site Rashba half-cut")
        del eng, form
    torch.cuda.empty_cache()

    # -- 14d: factored t-J in float32, complex Rashba in complex64 ------
    cross_terms = {}
    for key, label, text, form_key in (
            ("d f32", "18-site t-J ring, 8 up 8 down", tj_ring_text(18, 8, 8),
             "perm_gather f32"),
            ("d c64", "12-site Rashba ring, 12 electrons",
             rashba_ring_text(12, 12), "perm_gather c64")):
        eng, refinements, chunks, wall = solved(
            key, lambda: engine(factored(text), f32))
        form = eng._cached_hamiltonian(eng.parts)
        form = getattr(form, "inner", form)
        (unrefined, refined, refine_s), = refinements
        want = refs[f"factored {label}"]
        err = rel(eng.ground_energy, want)
        say(f"phase 14d {label}, factored, {form.dtype}: dim {form.dim}, "
            f"steps {eng.solve_info.steps}, unrefined E0 {float(unrefined[0])!r}, "
            f"refined {eng.ground_energy!r} against phase 10's {want!r}: rel "
            f"err {err:.3e} (unrefined {rel(unrefined[0], want):.3e}); wall "
            f"{wall:.3f} s, of which the refinement {refine_s:.3f} s; "
            f"launches by form {runs[key]}")
        check(err <= TOL_E0, f"14d {label}: E0 off by {err:.3e}")
        check(runs[key].get(form_key, 0) > 0,
              f"14d {label}: no {form_key}: {runs[key]}")
        name = ("18-site t-J" if "t-J" in label
                else "12-site Rashba half-cut")
        cross_terms[form.dtype] = largest_cross_term(form, name)
        if form.dtype == f32:   # its largest tier, timed in 14g
            t_big = max(range(len(form.tiers)),
                        key=lambda i: form.col_t[i].numel())
            tier32 = (form.col_t[t_big], form.diag_t[t_big].shape[:2])
        del eng, form
    torch.cuda.empty_cache()

    # -- 14e: the 22-site Kitaev ring with bf16 factors -----------------
    e64, form64, kmodel, kbasis = refs.pop("22-site Kitaev ring")
    form32 = narrowed(form64)
    t = time.perf_counter()
    b16 = build_factored_kitaev(kmodel, kbasis, dtype=f32, device=dev,
                                factor_dtype=bf16)
    build_s = time.perf_counter() - t
    rounded = all(torch.equal(getattr(b16, name), getattr(form64, name).to(
        bf16)) for name in ("hl", "hr_t", "p", "q"))
    check(rounded and torch.equal(b16.diag2d, form32.diag2d),
          "14e: build_factored_kitaev's bf16 factors are not the float64 "
          "ones rounded, or its diagonal not the float32 one")
    del kmodel, kbasis
    x = torch.randn(b16.dim, generator=gen, device=dev, dtype=f32)
    y32, y16 = form32.matvec(x), b16.matvec(x)
    mv_err = rel_err(y16, y32)[1]
    del form64, y32, y16
    (evals, _, info), refinements, chunks, wall = solved(
        "e", lambda: lz.lowest_states(b16, seed=SEED, return_info=True))
    (unrefined, refined, refine_s), = refinements
    full = not any(s for _, s in chunks)
    say(f"phase 14e 22-site Kitaev ring, factored, float32 state, bf16 "
        f"factors (build_factored_kitaev(factor_dtype=torch.bfloat16), host "
        f"build {build_s:.3f} s, the float64 factors rounded bit for bit): "
        f"dim {b16.dim}, halves {tuple(b16.diag2d.shape)}, "
        f"{b16.p.shape[0]} cut terms, quantized {b16.quantized}; matvec "
        f"against the float32 form's {mv_err:.3e} of max |y| (tolerance "
        f"2e-2); steps {info.steps} (reorthogonalization "
        f"{'full on every step' if full else 'selective'}), unrefined E0 "
        f"{float(unrefined[0])!r}, refined (the bf16 factors as rounded, the JAX "
        f"package's operator) {float(evals[0])!r}, float64 E0 with float64 "
        f"factors {e64!r} (rel {rel(float(evals[0]), e64):.3e}: the factors' "
        f"rounding, no bar); wall {wall:.3f} s, of which the refinement "
        f"{refine_s:.3f} s; launches by form {runs['e']}")
    check(mv_err <= 2e-2, f"14e: bf16 matvec off by {mv_err:.3e}")
    check(b16.quantized and full
          and runs["e"].get("factor_matmul bf16_f32", 0) > 0,
          f"14e: quantized {b16.quantized}, full {full}, {runs['e']}")
    say(f"phase 14e: bf16 operands repacked for TMA {repacks['e']} (none "
        f"expected)")
    check(not repacks["e"], f"14e: bf16 repacks {repacks['e']}")
    kitaev_half = (b16.hl, form32.hl.shape[0])
    del form32, x
    torch.cuda.empty_cache()

    # -- 14f: a bf16 basis on 14a's sector; a checkpointed, resumed run --
    v0 = lz.random_start_vector(ham14.dim, SEED, f32, dev)
    ritz, peaks = {}, {}
    for basis in (f32, bf16):
        key = f"f {'f32' if basis == f32 else 'bf16'} basis"
        res, _, _, wall = solved(key, lambda: lz.tridiagonalize(
            ham14, v0, 80, reorth_dtype=basis))
        ritz[basis] = lz.tridiag_eigh(res.alphas, res.betas)[0][0]
        peaks[basis] = torch.cuda.max_memory_allocated(dev) / 1e9
        check(res.V.dtype == basis, f"14f: basis {res.V.dtype}")
        del res
    gap = rel(ritz[bf16], ritz[f32])
    say(f"phase 14f 14-site sector, 80 float32 steps: lowest Ritz value "
        f"{float(ritz[f32])!r} with a float32 basis, {float(ritz[bf16])!r} "
        f"with a bf16 "
        f"basis (rel {gap:.3e}, tolerance 2e-3); peak device memory "
        f"{peaks[f32]:.2f} GB and {peaks[bf16]:.2f} GB")
    check(gap <= 2e-3, f"14f: bf16 basis Ritz value off by {gap:.3e}")
    del ham14, v0
    v0 = lz.random_start_vector(she32.dim, SEED, f32, dev)
    ref, _, _, ref_wall = solved("f checkpoint", lambda: lz.tridiagonalize(
        she32, v0, 100))
    writes = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lanczos.npz")
        with timed_calls(lz, "_save", writes):
            try:
                with interrupted_after(lz, 2):
                    lz.tridiagonalize(she32, v0, 100, checkpoint=path,
                                      chunk=25)
                raise RuntimeError("14f: the run was not interrupted")
            except ChunkInterrupt:
                stopped = int(np.load(path)["next_step"])
            res, _, _, wall = solved("f resumed", lambda: lz.tridiagonalize(
                she32, v0, 100, checkpoint=path, chunk=25))
        size = os.path.getsize(path) / 1e6
    same = (np.array_equal(res.alphas, ref.alphas)
            and np.array_equal(res.betas, ref.betas))
    say(f"phase 14f 12-site SuperHubbardExtended sector in float32, 100 "
        f"steps checkpointed every 25: stopped after step {stopped}, "
        f"resumed to {len(res.alphas)} coefficients in {wall:.3f} s "
        f"(uninterrupted {ref_wall:.3f} s), bit-equal to the uninterrupted "
        f"run: {same}; writes {[round(w, 3) for w in writes]} s of a "
        f"{size:.1f} MB file")
    check(stopped == 50 and same, f"14f: stopped at {stopped}, bit-equal "
                                  f"{same}")
    del res, ref, v0

    # -- 14g: each new kernel form alone --------------------------------
    for size in (3432, 4096):
        xb = torch.randn(size, size, generator=gen, device=dev).to(bf16)
        ab = torch.randn(size, size, generator=gen, device=dev).to(bf16)
        out = torch.empty(size, size, device=dev)
        got = K.factor_matmul(xb, ab)
        ref = K.factor_matmul_ref(xb, ab)
        torch.cuda.synchronize()
        record(results, "factor_matmul",
               f"bf16 {size}^3 (wgmma fed by TMA, float32 sums; library "
               f"torch.matmul, bf16 out)", got, ref, TOL_BF16,
               (lambda: K.factor_matmul(xb, ab, out=out),
                lambda: K.factor_matmul_ref(xb, ab),
                lambda: torch.matmul(xb, ab.T)),
               1e3 * 2 * size ** 3 / PEAK_BF16_FLOPS, "operations")
        if size == 3432:  # the 14-site chain's factors under a float64 state
            out = torch.empty(size, size, device=dev, dtype=f64)
            got = K.factor_matmul(xb, ab, out=out.clone())
            ref = K.factor_matmul_ref(xb, ab).to(f64)
            torch.cuda.synchronize()
            record(results, "factor_matmul",
                   f"bf16->f64 {size}^3 (wgmma fed by TMA, float32 sums "
                   f"stored into float64; library torch.matmul, bf16 out)",
                   got, ref, TOL_BF16,
                   (lambda: K.factor_matmul(xb, ab, out=out),
                    lambda: K.factor_matmul_ref(xb, ab).to(f64),
                    lambda: torch.matmul(xb, ab.T)),
                   1e3 * 2 * size ** 3 / PEAK_BF16_FLOPS, "operations")
        del xb, ab, out, got, ref
    hl, half = kitaev_half
    xk = torch.randn(half, half, generator=gen, device=dev).to(bf16)
    y0 = torch.randn(half, half, generator=gen, device=dev)
    got = y0.clone()
    K.factor_matmul(xk.T, hl, out=got.T, accumulate=True)
    ref = y0 + K.factor_matmul_ref(xk.T, hl).T
    torch.cuda.synchronize()
    y1 = y0.clone()
    record(results, "factor_matmul",
           f"bf16 22-site Kitaev left half: Y+=H_L.X, {half}^3 into float32 "
           f"(transposed views, MN-major X)", got, ref, TOL_BF16,
           (lambda: K.factor_matmul(xk.T, hl, out=y1.T, accumulate=True),
            lambda: y1.T.add_(K.factor_matmul_ref(xk.T, hl)),
            lambda: torch.matmul(hl, xk)),
           1e3 * 2 * half ** 3 / PEAK_BF16_FLOPS, "operations")
    del hl, xk, y0, y1, got, ref
    # the float32 t-J form's largest tier: a factor per block, one launch
    a3, (nblk, rt) = tier32
    x3 = torch.randn(nblk, rt, a3.shape[1], generator=gen, device=dev,
                     dtype=f32)
    y0 = torch.randn_like(x3)
    got = y0.clone()
    K.factor_matmul(x3, a3, out=got, accumulate=True)
    ref = y0 + torch.matmul(x3, a3.transpose(1, 2))
    torch.cuda.synchronize()
    y1 = y0.clone()
    record(results, "factor_matmul",
           f"f32 18-site t-J tier: {nblk} blocks of {rt}x{a3.shape[1]} . "
           f"their own {a3.shape[1]}^2 factors, one launch (A batch "
           f"stride)", got, ref, TOL_F32,
           (lambda: K.factor_matmul(x3, a3, out=y1, accumulate=True),
            lambda: y1.add_(K.factor_matmul_ref(x3, a3)),
            lambda: y1.baddbmm_(x3, a3.transpose(1, 2))),
           1e3 * 2 * x3.numel() * a3.shape[1] / PEAK_FLOPS, "operations")
    del tier32, a3, x3, y0, y1, got, ref
    ell_case("f32 12-site SuperHubbardExtended J-ELL, R=1", she32.diag,
             she32.ell.cols, she32.ell.vals, (she32.dim,), TOL_F32)
    # the one-spin up form of the 14-site sector and the 8-site FeAs
    # term in float32 and complex64; the path's cross terms
    one_spin = refs["ham_u4"].factorized
    fcase, fsrc, fdst, ftables = refs["feas cross term"]
    for dtype, tag in ((f32, "f32"), (torch.complex64, "c64")):
        tables = {"cs": one_spin.up_cols.T.contiguous(),
                  "beta": one_spin.up_vals.T.contiguous().to(dtype)}
        szd, szu = one_spin.dn_cols.shape[0], one_spin.up_cols.shape[0]
        perm_gather_case(
            results, f"{tag} 14-site one-spin up gather form, R=1 "
                     f"({tables['cs'].shape[0]} channels)",
            torch.randn(szd, szu, generator=gen, device=dev, dtype=dtype),
            torch.randn(szd, szu, generator=gen, device=dev, dtype=dtype),
            tables)
        tables = {k: (v.to(dtype) if v.is_floating_point() else v)
                  for k, v in ftables.items()}
        perm_gather_case(
            results, fcase.replace("f64", tag),
            torch.randn(fsrc, generator=gen, device=dev, dtype=dtype),
            torch.randn(fdst, generator=gen, device=dev, dtype=dtype),
            tables)
    del one_spin, tables
    for dtype, (case, src, dst, tables) in cross_terms.items():
        perm_gather_case(
            results, case,
            torch.randn(src, generator=gen, device=dev, dtype=dtype),
            torch.randn(dst, generator=gen, device=dev, dtype=dtype), tables)
    for dtype, (case, src, dst, tables) in rashba_cross.items():
        tag = DTYPE_TAGS[dtype]
        perm_gather_case(
            results, case.replace(tag, f"bf16->{tag}", 1),
            torch.randn(src, generator=gen, device=dev).to(bf16),
            torch.randn(dst, generator=gen, device=dev, dtype=dtype), tables)
    del she32, cross_terms, rashba_cross
    torch.cuda.empty_cache()
    return runs


def float32_paths_phase(dev, gen, results, refs, ell_case):
    """Phase 15: float32 and complex64 on the paths the JAX package runs
    below float64 on its chip (``--dtype float32``), each run with the
    launch counts set to 0 before and read after, by form, its wall time
    and peak device memory beside its float64 counterpart's (`refs`, from
    phases 5, 8, 11 and 12, or run here from the same block): 15a lanczos
    --dtype float32 -g c on phase 8's 14-site chain (ComputeDensityOfStates
    =1, two batched float32 recurrences of 14 rows x 100 steps) at U=4
    against phase 8's ``#CFEnergy=`` (1e-10), and at U=0 against the
    one-particle levels; 15b phase 8's 12-site SuperHubbardExtended
    TSPCenter fleet in float32 (the float32 ell_spmv at R = 23); each U=4
    fleet's margins (``fleet_margins``) printed beside their bars; 15c
    --kpm on the 14-site chain (512
    moments) against phase 12c's moments and .kpmdos, --ftlm-dos 2.0 at R
    = 16 in float32 and float64 from the same card-drawn block, the FTLM
    recurrence (engine/ftlm.ftlm, R = 16, 80 steps: the (16*3432)x3432
    float32 GEMMs) on the 14-site form in float32 and float64 from the
    same block, and sqomega on phase 12f's 10-site ring; 15d the 14-site
    half-filled U=4 chain's 14 momentum blocks in float32 (12 of them
    complex64, each refined against its float64 block) against phase 5's
    E0 and Hamiltonian, the 14-site open (4, 4) chain's parity blocks and
    the 22-site Kitaev ring by projection in float32 against phase 11's
    E0s, each k's; then each kernel form at the shapes these paths gave
    it, alone against its plain version, its bound and one library call.
    Returns {run label: launches by kernel and form}."""
    from lanczosplusplus_tpu_torch.cli import lanczos_main, sqomega_main
    from lanczosplusplus_tpu_torch.core import sparse
    from lanczosplusplus_tpu_torch.engine import ftlm as F
    from lanczosplusplus_tpu_torch.engine import kpm as KPM
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    from lanczosplusplus_tpu_torch.engine.spectral import (
        ContinuedFractionCollection)
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.ops.refine import narrowed
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    from lanczosplusplus_tpu_torch.symmetry import projected
    f32, f64 = torch.float32, torch.float64
    runs, batched = {}, {}
    e0 = refs["e0_u4"]
    omegas = np.linspace(-10.0, 10.0, 401)
    # The bars a float32 run is measured against; each margin is printed
    # beside its bar, met or not.  A fleet's densities (each against its
    # own maximum) and first coefficients are printed against their bars
    # and fail no run: the float64 recurrence from the float32 run's own
    # start rows (`float64_witness`) splits their distance from the
    # float64 fleet into the arithmetic's share and the start rows' share.
    density_bar, coef_bar, e0_bar = 2e-3, 1e-5, TOL_E0

    def bar(value, limit):
        return f"bar {limit:g} {'met' if value <= limit else 'not met'}"

    def launched(label, run, counter=None):
        """Runs run() with the launch counts set to 0 before and read
        after, by form, into runs[label]; where `counter` is given (an
        owner and attribute), the batched applies it counts go to
        batched[label].  Returns (what run() returns, wall s, peak GB)."""
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (counted_applies(*counter, batched=True) if counter else
              contextlib.nullcontext({"applies": 0})) as seen:
            got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[label] = dict(K.FORM_LAUNCHES)
        batched[label] = seen["applies"]
        return got, wall, torch.cuda.max_memory_allocated(dev) / 1e9

    def beside(label, wall, peak, ref_wall, ref_peak, where):
        """One line: the run's wall and peak memory beside its float64
        counterpart's (None: not measured in this run)."""
        def gb(x):
            return "not measured" if x is None else f"{x:.2f} GB"
        say(f"  {label}: wall {wall:.3f} s against "
            + ("not measured" if ref_wall is None else f"{ref_wall:.3f} s")
            + f" in float64 ({where}); peak device memory {gb(peak)} "
              f"against {gb(ref_peak)}; launches by form {runs[label]}")

    def density_diff(colls, ref_colls, delta):
        """Worst difference of -Im G(w + i delta)/pi over the collections,
        of each reference collection's own maximum."""
        worst = 0.0
        for c, r in zip(colls, ref_colls):
            got, want = (spectral_density(x, omegas, delta) for x in (c, r))
            worst = max(worst, np.abs(got - want).max() / np.abs(want).max())
        return worst

    def coefficient_diff(colls, ref_colls, lead=5):
        """Worst difference of the first `lead` alphas and betas of each
        fraction, of the reference's maximum of them."""
        worst = 0.0
        for c, r in zip(colls, ref_colls):
            for cf, rf in zip(c.items, r.items):
                for a, b in ((cf.alphas, rf.alphas), (cf.betas, rf.betas)):
                    worst = max(worst, np.abs(a[:lead] - b[:lead]).max()
                                / np.abs(b[:lead]).max())
        return worst

    def float64_witness(eng, text):
        """The fleet of `eng`, a float32 Engine after its -g run on
        `text`, made again with each batched recurrence in float64: the
        sector's float64 form from the float32 run's own start rows,
        widened and renormalised.  Collections in the .comb files' order,
        with the run's E0, weights and signs."""
        n = eng.geometry.number_of_sites()
        pairs, _ = lanczos_main._spectral_pairs(parse_input(text), n)
        norb = lanczos_main.max_orbitals(eng.model, n)
        plain = lz.tridiagonalize_plain_batched

        def wide_recurrence(ham, v0s, steps):
            rows = v0s.to(torch.complex128 if v0s.is_complex() else f64)
            rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
            return plain(ham, rows, steps)

        eng._cached_dense_hamiltonian = (
            lambda parts: eng._build_hamiltonian(eng._cached_basis(parts)))
        lz.tridiagonalize_plain_batched = wide_recurrence
        try:
            fleets = [eng.spectral_functions_batched("c", pairs,
                                                     orbs=(o1, o2))
                      for o1 in range(norb) for o2 in range(o1, norb)]
        finally:
            lz.tridiagonalize_plain_batched = plain
            del eng._cached_dense_hamiltonian
        colls = []
        for counter in range(len(pairs)):
            colls.append(ContinuedFractionCollection())
            for fleet in fleets:
                colls[-1].items += fleet[counter][0].items
        return colls

    def ground_state_split(eng):
        """(|<v64|v32>|, and of v32's part orthogonal to v64 its norm and
        its Rayleigh quotient on the float64 form less E0): the float32
        run's ground state v32 against the float64 solve of its sector
        (the float64 phases' own solve).  A part of norm well above the
        float32 solve's error with a Rayleigh quotient at E0 is a second
        ground state: the level is degenerate and the two runs hold
        different vectors of it."""
        ham64 = eng._build_hamiltonian(eng.basis)
        e64, v64 = lz.lowest_states(ham64, num_states=1,
                                    seed=eng.config.seed,
                                    max_steps=eng.config.lanczos_steps)
        v64 = v64[0]
        v32 = eng.eigenvector(0).to(v64.dtype)
        v32 = v32 / torch.linalg.vector_norm(v32)
        overlap = torch.vdot(v64, v32)
        w = v32 - overlap * v64
        norm = torch.linalg.vector_norm(w).item()
        rq = (torch.vdot(w, ham64.matvec(w)).real.item() / norm ** 2
              - float(e64[0])) if norm > 0 else 0.0
        return abs(overlap.item()), norm, rq

    def fleet_margins(label, combs, ref_combs, eng, text):
        """Prints the float32 fleet's densities against the float64
        fleet's at delta 0.1 and 1 beside the density bar, split by the
        float64 witness, its first 5 coefficients against the witness's
        beside the coefficient bar, and the run's ground state against
        the float64 one (``ground_state_split``)."""
        t = time.perf_counter()
        witness = float64_witness(eng, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(len(witness) == len(combs)
              and all(len(w.items) == len(c.items)
                      for w, c in zip(witness, combs)),
              f"{label}: the witness's fractions do not pair with the run's")
        d = {(pair, delta): density_diff(a, b, delta)
             for pair, (a, b) in (("float64", (combs, ref_combs)),
                                  ("arithmetic", (combs, witness)),
                                  ("start rows", (witness, ref_combs)))
             for delta in (0.1, 1.0)}
        coef = coefficient_diff(combs, witness)
        say(f"  {label}: -Im G(w + i delta)/pi on {len(omegas)} points, "
            f"max diff of each density's own maximum, against the float64 "
            f"fleet: {d['float64', 0.1]:.3e} at delta 0.1 "
            f"({bar(d['float64', 0.1], density_bar)}), "
            f"{d['float64', 1.0]:.3e} at delta 1 "
            f"({bar(d['float64', 1.0], density_bar)}); the float64 "
            f"recurrence from the run's own start rows against the run "
            f"(the arithmetic) {d['arithmetic', 0.1]:.3e} / "
            f"{d['arithmetic', 1.0]:.3e} and against the float64 fleet "
            f"(the start rows) {d['start rows', 0.1]:.3e} / "
            f"{d['start rows', 1.0]:.3e} at delta 0.1 / 1; first 5 (alpha, "
            f"beta) of all {sum(len(c.items) for c in combs)} fractions "
            f"against that recurrence's: max diff {coef:.3e} of their "
            f"maximum ({bar(coef, coef_bar)}); the float64 recurrence "
            f"{wall:.3f} s")
        overlap, norm, rq = ground_state_split(eng)
        say(f"  {label}: the run's float32 ground state against the float64 "
            f"solve of its sector: |<v64|v32>| = {overlap!r}; the part "
            f"orthogonal to v64 has norm {norm:.3e} and Rayleigh quotient "
            f"E0 + {rq:.3e} on the float64 form")

    def cf_energies(colls):
        return [cf.e0 for c in colls for cf in c.items]

    # -- 15a: lanczos --dtype float32 -g c, the 14-site DOS fleet ----------
    nsite, steps8 = 14, 100
    dos_text = "ComputeDensityOfStates=1\n" f"SpectralSteps={steps8}\n"
    flat_form = (sparse.Hamiltonian, "matmat_t")
    label = "15a 14-site U=4 DOS"
    (eng, _, err, combs, _), wall, peak = launched(
        label, lambda: run_cli(lanczos_main, hubbard_chain_text(nsite, 4)
                               + dos_text, ["--dtype", "float32"]),
        flat_form)
    ref = refs["dos_u4"]
    rec = phase_seconds(err, "batched recurrence")
    forms = runs[label]
    check(len(combs) == nsite and len(rec) == 2 and batched[label]
          == 2 * steps8, f"{label}: {len(combs)} .comb files, {len(rec)} "
                         f"recurrences, {batched[label]} batched applies")
    check(forms.get("factor_matmul f32", 0) >= 2 * batched[label]
          and forms.get("factor_matmul f64", 0) > 0
          and not any(k.startswith("ell_spmv") for k in forms),
          f"{label}: launches {forms}")
    e0_err = max(abs(x - e0) for x in cf_energies(combs)) / abs(e0)
    sums = max(abs(sum(cf.weight for cf in c.items) - 1.0) for c in combs)
    say(f"phase 15a 14-site U=4 lanczos --dtype float32 -g c "
        f"(ComputeDensityOfStates=1) via CLI on cuda: {len(combs)} .comb "
        f"files, #CFEnergy= against phase 5's E0 max rel {e0_err:.3e} "
        f"(bar {e0_bar:g}); sum rules max |w_add + w_rem - 1| {sums:.3e}; "
        f"batched recurrences {rec} s = "
        f"{[round(1e3 * t / steps8, 3) for t in rec]} ms per batched step "
        f"of {nsite} rows against phase 8's "
        f"{[round(1e3 * t / steps8, 3) for t in ref['rec']]}")
    beside(label, wall, peak, ref["wall"], ref["peak"], "phase 8")
    check(e0_err <= e0_bar, f"{label}: #CFEnergy= off by {e0_err:.3e}")
    check(eng.eigenvector(0).dtype == f32,
          f"{label}: ground state {eng.eigenvector(0).dtype}")
    for parts in ((nsite // 2 + 1, nsite // 2), (nsite // 2 - 1, nsite // 2)):
        form = eng._cached_dense_hamiltonian(parts)
        check(form.dtype == f32, f"{label}: sector form {form.dtype}")
    fleet_margins(label, combs, ref["combs"], eng,
                  hubbard_chain_text(nsite, 4) + dos_text)
    del eng, combs, form
    torch.cuda.empty_cache()

    label = "15a 14-site U=0 DOS"
    (eng, _, err, combs, _), wall, peak = launched(
        label, lambda: run_cli(lanczos_main, hubbard_chain_text(nsite, 0)
                               + dos_text, ["--dtype", "float32"]),
        flat_form)
    levels = np.linalg.eigvalsh(Geometry(parse_input(
        hubbard_chain_text(nsite, 0))).coupling_matrix(0))
    near_bar = 1e-4
    worst = 0.0
    for coll in combs:
        for cf, want in zip(coll.items, (levels[nsite // 2:],
                                         levels[:nsite // 2])):
            poles, weights = cf.poles_and_weights()
            near = np.abs(poles[:, None] - want[None, :]) <= near_bar
            for k, level in enumerate(want):
                g = (np.abs(want - level) <= 1e-9).sum()
                worst = max(worst, abs(weights[near[:, k]].sum()
                                       - g / nsite))
            worst = max(worst, np.abs(weights[~near.any(axis=1)]).sum())
    e0_free = float(2.0 * np.sort(levels)[:nsite // 2].sum())
    e0_err = abs(eng.ground_energy - e0_free) / abs(e0_free)
    say(f"phase 15a 14-site U=0 lanczos --dtype float32 -g c via CLI on "
        f"cuda: E0 {eng.ground_energy!r} against the free-fermion "
        f"{e0_free!r} (rel {e0_err:.3e}); poles of all {2 * nsite} "
        f"fractions within {near_bar:g} of the hopping matrix's levels, "
        f"weights g/{nsite}: worst deviation {worst:.3e} (bar 1e-4)")
    beside(label, wall, peak, refs["dos_u0"]["wall"], refs["dos_u0"]["peak"],
           "phase 8")
    check(e0_err <= e0_bar, f"{label}: E0 off by {e0_err:.3e}")
    check(worst <= 1e-4, f"{label}: pole weights off by {worst:.3e}")
    check(batched[label] == 2 * steps8, f"{label}: {batched[label]} batched"
                                        f" applies")
    del eng, combs
    torch.cuda.empty_cache()

    # -- 15b: the 12-site SuperHubbardExtended TSPCenter fleet -------------
    steps_she, ref = 20, refs["tsp_she"]
    label = "15b 12-site SuperHubbardExtended TSPCenter fleet"
    she_text = (super_hubbard_text(12) + "TSPCenter=0\n"
                f"SpectralSteps={steps_she}\n")
    (eng, _, err, combs, _), wall, peak = launched(
        label, lambda: run_cli(lanczos_main, she_text,
                               ["-g", "c", "--dtype", "float32"]), flat_form)
    rows = [int(r) for r in re.findall(r"batched recurrence sector .* "
                                       r"rows=(\d+) steps=\d+ done", err)]
    forms = runs[label]
    check(len(combs) == 12 and rows == [23, 23]
          and batched[label] == 2 * steps_she
          and forms.get("ell_spmv f32", 0) >= batched[label],
          f"{label}: {len(combs)} files, rows {rows}, batched applies "
          f"{batched[label]}, launches {forms}")
    e0_err = max(abs(x - refs["e0_she"]) for x in cf_energies(combs)) / abs(
        refs["e0_she"])
    say(f"phase {label} via CLI -g c --dtype float32: rows per sector "
        f"{rows}, #CFEnergy= against phase 6's E0 max rel {e0_err:.3e}; "
        f"batched recurrences {phase_seconds(err, 'batched recurrence')} s "
        f"against {ref['rec']} s")
    beside(label, wall, peak, ref["wall"], ref["peak"], "phase 8")
    check(e0_err <= e0_bar, f"{label}: #CFEnergy= off by {e0_err:.3e}")
    fleet_margins(label, combs, ref["combs"], eng, she_text)
    fleet = eng._cached_dense_hamiltonian((7, 6))
    check(fleet.dtype == f32, f"{label}: fleet form {fleet.dtype}")
    fleet_ell = (fleet.diag, fleet.ell.cols, fleet.ell.vals, fleet.dim)
    del eng, combs, fleet
    torch.cuda.empty_cache()

    # -- 15c: the estimators in float32 ------------------------------------
    ref = refs["kpm"]
    moments = 512
    label = "15c 14-site lanczos -g c --kpm"
    (eng, _, err, files, _), wall, peak = launched(
        label, lambda: run_tool(
            lanczos_main, hubbard_chain_text(14, 4) + "TSPSites 2 0 0\n"
            f"KPMMoments={moments}\n",
            ["-g", "c", "--kpm", "-p", "17", "--dtype", "float32"], dev))
    kpmdos = np.loadtxt(files["input.inp0.kpmdos"].splitlines())
    np.testing.assert_array_equal(kpmdos[:, 0], ref["dos"][:, 0])
    dos_err = np.abs(kpmdos[:, 1] - ref["dos"][:, 1]).max() / np.abs(
        ref["dos"][:, 1]).max()
    loops = phase_seconds(err, "kpm moments")
    gs = eng.eigenvector(0)
    op_c = LabeledOperator("c")
    mom_err = 0.0
    for type_, (a, b, mu64) in enumerate(ref["moments"]):
        op = op_c if type_ else op_c.transpose_conjugate()
        parts, basis = eng._get_needed_basis(eng.parts, op, 0, 0)
        phi = torch.zeros(basis.size, dtype=f32, device=dev)
        eng.acc_modified_state(phi, op, basis, gs, eng.basis, 0, 0, 0, 1.0)
        ham = eng._cached_hamiltonian(parts)
        check(ham.dtype == f32, f"{label}: sector form {ham.dtype}")
        got = KPM.chebyshev_moments(ham, phi, moments, (b - a, b + a))
        mom_err = max(mom_err, np.abs(got.moments - mu64).max() / mu64[0])
    say(f"phase {label} --dtype float32 via CLI on cuda: .kpmdos "
        f"against phase 12c's max diff {dos_err:.3e} of its maximum (bar "
        f"{density_bar:g}); the {moments} moments of the float32 state on "
        f"the float32 forms, phase 12c's bounds, against phase 12c's "
        f"float64 moments: max |dmu_k| / mu_0 {mom_err:.3e} (bar 1e-3); "
        f"moment loops {loops} s against {ref['loops']} s")
    beside(label, wall, peak, ref["wall"], None, "phase 12c")
    check(dos_err <= density_bar, f"{label}: .kpmdos off by {dos_err:.3e}")
    check(mom_err <= 1e-3, f"{label}: moments off by {mom_err:.3e}")
    check(runs[label].get("factor_matmul f32", 0) > 0
          and "factor_matmul f64" in runs[label], f"{label}: launches "
                                                  f"{runs[label]}")
    del eng, gs, phi, ham
    torch.cuda.empty_cache()

    # --ftlm-dos 2.0 at R = 16, both types from the same card-drawn block;
    # 16 stored float64 source runs of 10 steps take 15.1 GB, under half of
    # what the card has free once the allocator's cache is emptied
    rows_e, steps_e = 16, 10
    text_e = hubbard_chain_text(14, 4) + (
        "TSPSites 2 0 0\nSpectralSteps=40\n"
        f"FTLMVectors={rows_e}\nFTLMSteps={steps_e}\nFTLMDelta=0.1\n")
    got = {}
    for dtype in ("float64", "float32"):
        torch.cuda.empty_cache()
        label = f"15c 14-site lanczos -g c --ftlm-dos {dtype}"
        (_, _, err, files, _), wall, peak = launched(
            label, lambda: run_tool(
                lanczos_main, text_e,
                ["-g", "c", "--ftlm-dos", "2.0", "-p", "17", "--dtype",
                 dtype], dev))
        got[dtype] = (np.loadtxt(files["input.inp0.ftlmdos"].splitlines()),
                      wall, peak, phase_seconds(err, "ftlm source runs"))
    (d64, wall64, peak64, src64), (d32, wall32, peak32, src32) = (
        got["float64"], got["float32"])
    ftlm_err = np.abs(d32[:, 1] - d64[:, 1]).max() / np.abs(d64[:, 1]).max()
    say(f"phase 15c 14-site lanczos -g c --ftlm-dos 2.0 (R {rows_e}, "
        f"{steps_e} steps, delta 0.1) via CLI on cuda: float32 against "
        f"float64 from the same block, max diff {ftlm_err:.3e} of the "
        f"maximum (bar {density_bar:g}); source runs {src32} s against "
        f"{src64} s")
    beside(label, wall32, peak32, wall64, peak64, "this phase")
    check(ftlm_err <= density_bar, f"--ftlm-dos float32 off by "
                                   f"{ftlm_err:.3e}")
    check(runs[label].get("factor_matmul f32", 0) > 0,
          f"{label}: launches {runs[label]}")

    # the batched FTLM recurrence on the 14-site form, R = 16, 80 steps
    rows_f, steps_f = 16, 80
    betas = np.asarray([0.1, 0.5, 1.0, 2.0, 5.0, 20.0])
    ham64 = refs["ham_u4"]
    block = lz.random_start_block(ham64.dim, rows_f, 982451653, f32, dev)
    res, recs = {}, {}
    for ham in (ham64, narrowed(ham64)):
        tag = DTYPE_TAGS[ham.dtype]
        label = f"15c 14-site ftlm R=16 {tag}"
        recs[tag] = []
        with timed_calls(F, "_ftlm_recurrence", recs[tag]):
            res[tag], wall, peak = launched(
                label, lambda: F.ftlm(ham, betas, steps=steps_f,
                                      start_vectors=block.to(ham.dtype)))
        recs[tag].append((wall, peak))
    e_err = np.abs(res["f32"].energy - res["f64"].energy).max() / np.abs(
        res["f64"].energy).max()
    lz_err = np.abs(res["f32"].log_z - res["f64"].log_z).max() / np.abs(
        res["f64"].log_z).max()
    est_err = abs(res["f32"].e0_estimate - e0) / abs(e0)
    say(f"phase 15c 14-site ftlm (R {rows_f}, {steps_f} steps, betas "
        f"{betas.tolist()}) on the float32 form against the float64 form from "
        f"the same card-drawn block: energies max rel {e_err:.3e}, ln Z "
        f"{lz_err:.3e} (bar 1e-4), e0_estimate {res['f32'].e0_estimate!r} "
        f"against phase 5's E0 (rel {est_err:.3e}); batched recurrence "
        f"{recs['f32'][0]:.3f} s = {1e3 * recs['f32'][0] / steps_f:.3f} ms "
        f"a step against {recs['f64'][0]:.3f} s = "
        f"{1e3 * recs['f64'][0] / steps_f:.3f} ms in float64")
    beside(label, *recs["f32"][1], *recs["f64"][1], "this phase")
    check(e_err <= 1e-4 and lz_err <= 1e-4, f"ftlm float32: energies "
                                            f"{e_err:.3e}, ln Z {lz_err:.3e}")
    check(runs[label] == {"factor_matmul f32": 2 * steps_f},
          f"{label}: launches {runs[label]}")
    del block, res
    torch.cuda.empty_cache()

    label = "15c sqomega 10-site Heisenberg ring"
    (sq, _, _, _, _), wall, peak = launched(
        label, lambda: run_tool(sqomega_main, heisenberg_ring_text(10),
                                ["-b", "-1", "-e", "5", "-s", "0.05", "-d",
                                 "0.1", "--dtype", "float32"], dev))
    sq_err = np.abs(sq[1] - refs["sqomega"]).max() / np.abs(
        refs["sqomega"]).max()
    say(f"phase {label} --dtype float32 via CLI on cuda: S(q, omega) "
        f"against phase 12f's float64 run max diff {sq_err:.3e} of its "
        f"maximum (bar {density_bar:g}); wall {wall:.3f} s, launches "
        f"{runs[label]}")
    check(sq_err <= density_bar, f"{label}: off by {sq_err:.3e}")
    check(runs[label].get("ell_spmv f32", 0) > 0, f"{label}: launches "
                                                  f"{runs[label]}")

    # -- 15d: the symmetry sectors in float32 -------------------------------
    label = "15d 14-site U=4 chain, translation"
    with counted_applies(sparse.Hamiltonian, "matmat_t") as seen:
        (eng, _, err, _, _), wall, peak = launched(
            label, lambda: run_cli(lanczos_main, hubbard_chain_text(
                14, 4, extra="UseTranslationSymmetry=1\n"),
                ["--dtype", "float32"]))
    blocks = [(int(m[0]), int(m[1]), m[2], int(m[3]), float(m[4]),
               int(m[5]), float(m[6])) for m in SECTOR_LINE.findall(err)]
    setup, = phase_seconds(err, "symmetry setup")
    builds = phase_seconds(err, "block build")
    solves = phase_seconds(err, "solve")
    kinds = [b[2] for b in blocks]
    e0_err = abs(eng.ground_energy - e0) / abs(e0)
    below = min(b[6] for b in blocks) - e0
    v = eng.eigenvector(0)
    resid = eigenvector_residual(refs["ham_u4"], v, eng.ground_energy)
    forms = runs[label]
    say(f"phase {label} --dtype float32 via CLI on cuda: dim "
        f"{eng.basis.size}, {len(blocks)} blocks ({kinds.count('complex64')} "
        f"complex64, {kinds.count('float32')} float32), min sector "
        f"{eng.solve_sector}, E0 {eng.ground_energy!r} against phase 5's "
        f"(rel {e0_err:.3e}, bar {e0_bar:g}); every block's refined E0 at "
        f"or above it (lowest - E0 = {below:.3e}); time to E0 {wall:.3f} s "
        f"= symmetry setup {setup:.3f} + block builds {sum(builds):.3f} "
        f"+ block solves and refinements {sum(solves):.3f} s + the rest, "
        f"{seen['applies']} block matvecs; the transformed eigenvector "
        f"({v.dtype}) on phase 5's Hamiltonian: ||Hv - E0 v|| = "
        f"{resid:.3e} (bar 1e-4)")
    for s, dim, dtype, width, mean, steps, e0_s in blocks:
        say(f"  sector {s}: dim {dim}, {dtype}, ELL K {width}, steps "
            f"{steps}, refined E0 {e0_s!r}")
    beside(label, wall, peak, None, None,
           "phase 11 runs the 12-site chain's blocks in its place")
    check(len(blocks) == 14 and kinds.count("complex64") == 12
          and kinds.count("float32") == 2, f"{label}: blocks {kinds}")
    check(e0_err <= e0_bar and below >= -e0_bar * abs(e0),
          f"{label}: E0 off by {e0_err:.3e}, a block {below:.3e} below")
    check(resid <= 1e-4, f"{label}: residual {resid:.3e}")
    check(forms.get("ell_spmv c64", 0) > 0 and forms.get("ell_spmv f32", 0)
          > 0 and forms.get("ell_spmv c128", 0) > 0,
          f"{label}: launches {forms}")
    check(v.dtype in (f32, torch.complex64), f"{label}: state {v.dtype}")
    sym = eng.symmetry
    kept = [(s, sym.block_hamiltonian(s, f32)) for s in range(sym.sectors())]
    momentum = max(((s, b) for s, b in kept if b is not None
                    and b.dtype == torch.complex64), key=lambda sb: sb[1].dim)
    momentum_entries = sym.block_entries[momentum[0]]
    # the complex128 block it was narrowed from, assembled again: the twin
    # the refinement applied
    momentum_wide = sym.block_pair(momentum[0], f32)[1]
    del eng, v, sym, kept
    torch.cuda.empty_cache()

    label = "15d 14-site open (4, 4) chain, reflection"
    ref = refs["phase 11 14-site open (4, 4) chain, reflection"]
    (eng, _, err, _, _), wall, peak = launched(
        label, lambda: run_cli(lanczos_main, hubbard_chain_text(
            14, 4, 4, 4, periodic=0, extra="UseReflectionSymmetry=1\n"),
            ["--dtype", "float32"]))
    kinds = [m[2] for m in SECTOR_LINE.findall(err)]
    e0_err = abs(eng.ground_energy - ref["e0"]) / abs(ref["e0"])
    say(f"phase {label} --dtype float32 via CLI on cuda: blocks "
        f"{kinds}, E0 {eng.ground_energy!r} against phase 11's "
        f"{ref['e0']!r} (rel {e0_err:.3e}, bar {e0_bar:g})")
    beside(label, wall, peak, ref["wall"], ref["peak"], "phase 11")
    check(kinds == ["float32", "float32"], f"{label}: blocks {kinds}")
    check(e0_err <= e0_bar, f"{label}: E0 off by {e0_err:.3e}")
    sym = eng.symmetry
    parity = max(((s, sym.block_hamiltonian(s, f32))
                  for s in range(sym.sectors())), key=lambda sb: sb[1].dim)
    parity_entries = sym.block_entries[parity[0]]
    del eng, sym

    label = "15d 22-site Kitaev ring, projected translation"
    ref = refs["phase 11 22-site Kitaev ring, projected translation"]
    with counted_applies(projected.RotationProjectedHamiltonian,
                         "matvec") as seen:
        (eng, _, err, _, _), wall, peak = launched(
            label, lambda: run_cli(lanczos_main, kitaev_ring_text(22)
                                   + "UseTranslationSymmetry=1\n",
                                   ["--dtype", "float32"]))
    per_k = [(int(k), int(steps), float(e)) for k, steps, e in re.findall(
        r"momentum sector k=(\d+): steps (\d+), E0 (\S+)", err)]
    k_err = max(abs(e - e_ref) / abs(e_ref) for (k, _, e), (k_ref, _, e_ref)
                in zip(per_k, ref["per_k"]))
    e0_err = abs(eng.ground_energy - ref["e0"]) / abs(ref["e0"])
    forms = runs[label]
    say(f"phase {label} --dtype float32 via CLI on cuda: "
        f"{len(per_k)} sectors, min k {eng.solve_sector}, E0 "
        f"{eng.ground_energy!r} against phase 11's {ref['e0']!r} (rel "
        f"{e0_err:.3e}); each k's refined E0 against phase 11's: max rel "
        f"{k_err:.3e} (bar {e0_bar:g}); purity {eng.projected_purity!r}; "
        f"{seen['applies']} projected matvecs, sector solves and "
        f"refinements {sum(phase_seconds(err, 'solve')):.3f} s against "
        f"{sum(ref['solves']):.3f} s")
    for (k, steps, e), (_, steps64, e64) in zip(per_k, ref["per_k"]):
        say(f"  k={k}: steps {steps} (float64 {steps64}), refined E0 {e!r} "
            f"(float64 {e64!r})")
    beside(label, wall, peak, ref["wall"], None, "phase 11")
    check([k for k, _, _ in per_k] == [k for k, _, _ in ref["per_k"]],
          f"{label}: sectors {per_k}")
    check(k_err <= e0_bar and e0_err <= e0_bar,
          f"{label}: E0 off by {e0_err:.3e}, a k by {k_err:.3e}")
    check(eng.projected_purity >= 1 - 1e-5,
          f"{label}: purity {eng.projected_purity!r}")
    # four GEMMs a projected matvec: the float32 solves and correction
    # solves, the float64 refinement's residuals
    check(forms.get("factor_matmul f32", 0) + forms.get("factor_matmul f64", 0)
          == 4 * seen["applies"] and forms.get("factor_matmul f64", 0) > 0,
          f"{label}: launches {forms}, {seen['applies']} projected matvecs")
    del eng
    torch.cuda.empty_cache()

    # -- each kernel form at the shapes these paths gave it -----------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the fleet's 14 rows of the N_up = 8 sector (3003 x 3432, pitch 3003:
    # 4-byte copies) and the FTLM recurrence's 16 of the 3432^2 sector
    batched_factor_cases(results, gen, dev, sms, 14, 3432, 3003, dtype=f32)
    batched_factor_cases(results, gen, dev, sms, 16, 3432, 3432, dtype=f32)
    diag, cols, vals, dim = fleet_ell
    ell_case(f"f32 J-ELL of the 12-site N_up = 7 sector, R=23, dim {dim}",
             diag, cols, vals, (23, dim), TOL_F32)
    for tag, name, blk, entries, tol in (
            ("c128", "14-site momentum block", momentum_wide,
             momentum_entries, TOL_ELL_F64),
            ("c64", "14-site momentum block", momentum[1], momentum_entries,
             TOL_F32),
            ("f32", "14-site parity block", parity[1], parity_entries,
             TOL_F32)):
        width = blk.ell.cols.shape[1]
        for rows in (1, 14):
            ell_case(f"{tag} {name} R={rows}, dim {blk.dim}, K {width} "
                     f"against {entries / blk.dim:.2f} entries a row",
                     blk.diag, blk.ell.cols, blk.ell.vals,
                     (blk.dim,) if rows == 1 else (rows, blk.dim),
                     tol, entries=entries)
    hl = refs["22-site Kitaev half"].float()
    half = hl.shape[0]
    x2 = torch.randn(half, half, generator=gen, device=dev, dtype=f32)
    y0 = torch.randn(half, half, generator=gen, device=dev, dtype=f32)
    got = y0.clone()
    K.factor_matmul(x2.T, hl, out=got.T, accumulate=True)
    want = y0 + hl @ x2
    torch.cuda.synchronize()
    y1 = y0.clone()
    record(results, "factor_matmul",
           f"f32 22-site Kitaev left half: Y+=H_L.X, {half}^3 (transposed "
           f"views)", got, want, TOL_F32,
           (lambda: K.factor_matmul(x2.T, hl, out=y1.T, accumulate=True),
            lambda: y1.T.add_(K.factor_matmul_ref(x2.T, hl)),
            lambda: y1.addmm_(hl, x2)),
           1e3 * 2 * half ** 3 / PEAK_FLOPS, "operations")
    del momentum, momentum_wide, parity, fleet_ell, hl, x2, y0, y1, got, want
    torch.cuda.empty_cache()
    say(f"phase 15 kernel launches by run and form: {runs}; batched "
        f"applies {batched}")
    return runs, batched


# -- 16. distribution --------------------------------------------------------

# phase 16's sectors for the 4-rank gloo world on the card: label, text,
# parts.  The 11-site SuperHubbardExtended sector (5 up, 3 down: dim
# 462 * 165 = 76 230) pads both the flat dimension and size_down at 4
# ranks; the t-J ring is the block-factored form's sector.
DIST_RANKS = 4
DIST_WORLD_SECONDS = 420
DIST_SEED = 271828
# rows a rank of the 12-site sector (dim 853 776) at 4 ranks: the size at
# which phase 16b probes gloo's collectives on CUDA tensors
DIST_PROBE_ROWS = 853776 // DIST_RANKS


def super_hubbard_sector_text(nsite: int, nup: int, ndown: int) -> str:
    """``super_hubbard_text``'s chain with nup and ndown electrons."""
    return super_hubbard_text(nsite).replace(
        f"TargetElectronsUp={nsite // 2}\n", f"TargetElectronsUp={nup}\n"
    ).replace(f"TargetElectronsDown={nsite // 2}\n",
              f"TargetElectronsDown={ndown}\n")


DIST_SECTORS = (
    ("12-site SuperHubbardExtended", super_hubbard_text(12), (6, 6)),
    ("11-site SuperHubbardExtended 5/3",
     super_hubbard_sector_text(11, 5, 3), (5, 3)),
    ("14-site t-J ring 6/6, factored", tj_ring_text(14, 6, 6), (6, 6)))
# sectors whose estimators phase 16 runs, and the one its scatter plan maps
DIST_ESTIMATOR_SECTORS = ("11-site SuperHubbardExtended 5/3",
                          "14-site t-J ring 6/6, factored")
DIST_BETAS = (0.5, 2.0)


def dist_build(text: str, parts, dev):
    """(model, basis, the sector Hamiltonian on `dev`, or for a t-J sector
    its factored form)."""
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.tj_factored import \
        build_factored_tj

    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(parts)
    if "TjMultiOrb" in text:
        return model, basis, build_factored_tj(model, basis,
                                               dtype=torch.float64,
                                               device=dev)
    return model, basis, model.hamiltonian(basis, dtype=torch.float64,
                                           device=dev)


def dist_forms(ham, mesh):
    """(form label, sharded form, halo fraction or None) of every
    distributed form that takes `ham`."""
    from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
    from lanczosplusplus_tpu_torch.parallel.blockkron_dist import \
        shard_blockkron
    from lanczosplusplus_tpu_torch.parallel.halo import (HaloPlan,
                                                         KronHaloPlan)
    from lanczosplusplus_tpu_torch.parallel.kron import \
        shard_kron_hamiltonian

    if hasattr(ham, "inner"):
        return [("block-Kronecker", shard_blockkron(ham.inner, mesh), None)]
    plan = HaloPlan(ham, mesh.size)
    kplan = KronHaloPlan(ham, mesh.size)
    return [("flat ELL", pmesh.shard_hamiltonian(ham, mesh), None),
            ("Kronecker", shard_kron_hamiltonian(ham, mesh)[0], None),
            ("halo", plan.hamiltonian(mesh), plan.halo_fraction),
            ("halo-Kronecker", kplan.hamiltonian(mesh), kplan.halo_fraction)]


def dist_inputs(ham, dev):
    """The state every matvec of phase 16 applies H to (block order for a
    factored form), drawn from DIST_SEED on the card."""
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    return torch.randn(ham.dim, generator=gen, dtype=torch.float64,
                       device=dev)


def dist_estimators(ham, dev, mesh=None, bounds=None):
    """The estimators of phase 16 on `ham`, sharded over `mesh` or, with
    none, on the one card, from the same start blocks: FTLM energies (R 8,
    40 steps), the first coefficients of a spectral fleet of 3 rows, KPM
    moments (64, R 4, `bounds` given), the FTLM dynamics' first pole
    moments (R 2, 20 steps, a diagonal operator)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import ftlm
    from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import ftlm_dynamic
    from lanczosplusplus_tpu_torch.engine.kpm import kpm_dos
    from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    gen = torch.Generator(device=dev).manual_seed(DIST_SEED + 1)
    v0s = torch.randn(3, ham.dim, generator=gen, dtype=torch.float64,
                      device=dev)
    v0s /= torch.linalg.vector_norm(v0s, dim=1, keepdim=True)
    vd = torch.randn(ham.dim, 2, generator=gen, dtype=torch.float64,
                     device=dev)
    vd /= torch.linalg.vector_norm(vd, dim=0)
    op = torch.linspace(-1.0, 1.0, ham.dim, dtype=torch.float64, device=dev)

    def apply(x):
        return op * x
    out = {}
    if mesh is None:
        out["ftlm"] = ftlm(ham, DIST_BETAS, num_vectors=8, steps=40,
                           seed=DIST_SEED).energy
        rows = lz.tridiagonalize_plain_batched(
            ham.inner if hasattr(ham, "inner") else ham,
            ham.to_inner(v0s) if hasattr(ham, "inner") else v0s, 40)
        out["kpm"] = kpm_dos(ham, num_moments=64, num_vectors=4,
                             seed=DIST_SEED, bounds=bounds).moments
        dyn = ftlm_dynamic(ham, ham, apply, steps=20, start_vectors=vd)
    else:
        out["ftlm"] = pmesh.distributed_ftlm(ham, mesh, DIST_BETAS,
                                             num_vectors=8, steps=40,
                                             seed=DIST_SEED).energy
        rows = pmesh.distributed_spectral_fleet(ham, mesh, v0s, steps=40)
        out["kpm"] = pmesh.distributed_kpm_dos(ham, mesh, num_moments=64,
                                               num_vectors=4, seed=DIST_SEED,
                                               bounds=bounds).moments
        dyn = pmesh.distributed_ftlm_dynamic(ham, ham, apply, mesh,
                                             steps=20, start_vectors=vd)
    out["fleet"] = np.stack([np.concatenate([r.alphas[:10], r.betas[:10]])
                             for r in rows])
    om, wt = dyn.poles(1.0)
    out["dynamic"] = np.asarray([(wt * om ** k).sum() for k in range(3)])
    return out


def dist_probe(mesh, rows: int) -> dict:
    """Whether gloo takes, on CUDA tensors, the two collectives the mesh
    makes (``Mesh.all_gather``, ``Mesh.all_to_all``: gloo's all_gather and
    all_to_all_single, a complex tensor as its real view), in each type a
    state may have, at 8 x `rows` entries a rank: 'exact' where every rank's
    slab came back bit for bit, else what went wrong."""
    out = {}
    for dt in (torch.float64, torch.float32, torch.complex128,
               torch.complex64):
        def block(rank):
            v = torch.arange(8 * rows, device=mesh.device, dtype=torch.float64)
            v = (rank + 1) * torch.sin(v).reshape(8, rows)
            return torch.complex(v, -v).to(dt) if dt.is_complex else v.to(dt)
        for name, fn, want in (
                ("all_gather", lambda: mesh.all_gather(block(mesh.rank)),
                 torch.stack([block(r) for r in range(mesh.size)])),
                ("all_to_all_single",
                 lambda: mesh.all_to_all(block(mesh.rank).reshape(
                     mesh.size, -1, rows)),
                 torch.stack([block(r).reshape(mesh.size, -1, rows)[mesh.rank]
                              for r in range(mesh.size)]))):
            key = f"{name} {str(dt).split('.')[1]}"
            try:
                got = fn()
                torch.cuda.synchronize()
                out[key] = ("exact" if torch.equal(got, want) else
                            "wrong values")
            except Exception as exc:   # noqa: BLE001  the refusal is the result
                out[key] = f"refused: {str(exc).splitlines()[0][:100]}"
    return out


def dist_rank(rank: int, size: int, store: str, outdir: str,
              bounds: dict) -> None:
    """One rank of phase 16's gloo world on the card (spawned; the kernel
    library is built already, so it only loads it)."""
    import datetime

    import torch.distributed as dist
    from lanczosplusplus_tpu_torch.engine.engine import apply_operator_map
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
    from lanczosplusplus_tpu_torch.parallel.dryrun import dryrun
    from lanczosplusplus_tpu_torch.parallel.scatter_plan import \
        distributed_apply_operator_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=300))
    try:
        started = time.perf_counter()
        mesh = pmesh.make_mesh()
        dev = mesh.device
        out = dict(rank=rank, backend=str(dist.get_backend()),
                   transport=mesh.transport, device=str(dev),
                   probe=dist_probe(mesh, DIST_PROBE_ROWS), walls={}, halo={}, e0={}, y={},
                   est={}, sector_launches={})
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out["dryrun"] = dryrun(mesh)
        out["walls"]["dryrun"] = time.perf_counter() - t
        out["sector_launches"]["dry run"] = dict(K.FORM_LAUNCHES)
        for label, text, parts in DIST_SECTORS:
            t = time.perf_counter()
            model, basis, ham = dist_build(text, parts, dev)
            out["walls"][f"{label} build"] = time.perf_counter() - t
            x = dist_inputs(ham, dev)
            before = dict(K.FORM_LAUNCHES)
            for form, sham, fraction in dist_forms(ham, mesh):
                key = f"{label}, {form}"
                y = mesh.gather_rows(sham.matvec(mesh.local_rows(x,
                                                                 sham.dim)))
                if rank == 0:
                    out["y"][key] = y[:ham.dim].cpu()
                out["halo"][key] = fraction
                t = time.perf_counter()
                evals, _ = pmesh.sharded_selective_solve(
                    sham, mesh, ham.dim, seed=SEED, max_steps=200)
                torch.cuda.synchronize()
                out["walls"][f"{key} solve"] = time.perf_counter() - t
                out["e0"][key] = float(evals[0])
                if form == "flat ELL" and label == DIST_SECTORS[0][0]:
                    # the shard-local ell_spmv with the gathered state as
                    # its source, timed while the other ranks time theirs;
                    # its launches are not the path's
                    xl = mesh.local_rows(x, sham.dim)
                    src = mesh.gather_rows(xl)
                    sliced = sham.ell.sliced()
                    with K.uncounted():
                        out["shard_ell_ms"] = median_ms(
                            lambda: K.ell_spmv(sham.diag, sham.ell.cols,
                                               sham.ell.vals, xl,
                                               sliced=sliced, src=src), 20)
                    out["shard_ell_nnz"] = sliced.nnz
                del sham
            if label in DIST_ESTIMATOR_SECTORS:
                t = time.perf_counter()
                out["est"][label] = dist_estimators(ham, dev, mesh,
                                                    bounds[label])
                out["walls"][f"{label} estimators"] = \
                    time.perf_counter() - t
            if label == DIST_SECTORS[0][0]:
                dst = model.create_basis((parts[0] - 1, parts[1]))
                tgt, amp, dst_dim = model.operator_map(
                    LabeledOperator("c"), 0, 0, 0, basis, dst)
                t = time.perf_counter()
                z = distributed_apply_operator_map(tgt, amp, dst_dim, x, mesh)
                out["walls"]["scatter plan"] = time.perf_counter() - t
                with K.uncounted():
                    ref = apply_operator_map(tgt, amp, dst_dim, x)
                out["scatter_err"] = rel_err(z, ref)[1]
            out["sector_launches"][label] = {
                k: n - before.get(k, 0) for k, n in K.FORM_LAUNCHES.items()
                if n - before.get(k, 0)}
            del ham
        out["launches"] = dict(K.FORM_LAUNCHES)
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["walls"]["rank"] = time.perf_counter() - started
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def shard_ell_case(results, case, sham, x, src, offset):
    """ell_spmv of a row shard with a longer source against its plain
    version, timed beside its nonzero-bytes bound and one library call:
    the shard's rows as one (rows, len(src)) CSR matrix, its diagonal
    folded into the columns of its own rows (from `offset` in src), by
    ``csr @ src`` (cuSPARSE)."""
    from lanczosplusplus_tpu_torch.ops import kernels as K

    diag, cols, vals = sham.diag, sham.ell.cols, sham.ell.vals
    sliced = sham.ell.sliced()
    got = K.ell_spmv(diag, cols, vals, x, sliced=sliced, src=src)
    ref = K.ell_spmv_ref(diag, cols, vals, x, src=src)
    sliced_err = rel_err(K.ell_spmv_sliced_ref(diag, sliced, x, src=src),
                         ref)[1]
    check(sliced_err <= TOL_ELL_F64, f"{case}: the sliced plain version "
                                     f"differs by {sliced_err:.3e}")
    rows, k = cols.shape
    r = torch.arange(rows, device=cols.device)
    csr = coo_to_csr(torch.cat([r, r.repeat_interleave(k)]),
                     torch.cat([r + offset, cols.reshape(-1).long()]),
                     torch.cat([diag, vals.reshape(-1)]),
                     (rows, src.shape[-1]))
    lib_err = rel_err(csr @ src, ref)[1]
    check(lib_err <= 1e-12, f"{case}: the CSR form differs by {lib_err:.3e}")
    # per nonzero entry its index and value, per row diag, x and y, and
    # every entry of the source a row gathers, once
    used = torch.unique(sliced.cols[sliced.vals != 0]).numel()
    size = x.element_size()
    nbytes = sliced.nnz * (4 + size) + rows * 3 * size + used * size
    record(results, "ell_spmv", case, got, ref, TOL_ELL_F64,
           (lambda: K.ell_spmv(diag, cols, vals, x, sliced=sliced, src=src),
            lambda: K.ell_spmv_ref(diag, cols, vals, x, src=src),
            lambda: csr @ src),
           1e3 * nbytes / PEAK_BYTES, "bytes",
           padded_bound_ms=1e3 * (cols.numel() * (4 + size) + rows * 3 * size
                                  + used * size) / PEAK_BYTES,
           nnz=sliced.nnz, slots=sliced.cols.numel(),
           sliced_bytes=sliced.nbytes, source_entries=src.shape[-1],
           source_entries_read=used)


def distributed_phase(dev, results, refs) -> dict:
    """16. distribution (``parallel/``): 16a world 1 on NCCL in this
    process (a one-rank group from a file store, device_id cuda:0): the
    dry run of every path, the 14-site U=4 chain (phase 5's sector) solved
    in the Kronecker and the halo-Kronecker forms against phase 5's E0
    (1e-12), distributed_ftlm at R = 16 and 80 steps against the
    single-process ftlm from the same block (1e-8), and ell_spmv with a
    longer source on the 12-site SuperHubbardExtended flat form's row
    shards, one rank's of one and of 4, against its plain version; 16b 4
    gloo ranks spawned on the one card (gloo with CUDA tensors as they
    are), which check that gloo's all_gather and all_to_all_single give
    every type of state back exactly, run the dry run and, on
    DIST_SECTORS, every form's matvec (against this process's, 1e-12 of
    max |y|) and solve (E0 against this process's, 1e-10), the estimators
    on DIST_ESTIMATOR_SECTORS against this process's from the same blocks,
    and a scatter plan (c_up at site 0 of the 12-site sector, 1e-12).
    Each run's launches, by kernel and form, are counted, its references'
    and the timings' left out.  Returns the
    launches of the phase by form and by run."""
    import dataclasses
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from lanczosplusplus_tpu_torch.engine.ftlm import ftlm
    from lanczosplusplus_tpu_torch.engine.kpm import spectral_bounds
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
    from lanczosplusplus_tpu_torch.parallel.dryrun import dryrun
    from lanczosplusplus_tpu_torch.parallel.halo import halo_lowest_states
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    started = time.perf_counter()
    runs = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # -- 16a: world 1 on NCCL, in this process -----------------------
        dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = pmesh.make_mesh()
            check(mesh.transport == "nccl", f"transport {mesh.transport}")
            K.reset_launches()
            t = time.perf_counter()
            errs = dryrun(mesh)
            say(f"phase 16a world 1, backend {dist.get_backend()}, transport "
                f"{mesh.transport}: dry run of every path in "
                f"{time.perf_counter() - t:.3f} s, worst deviation from the "
                f"single-device port {max(errs.values()):.3e} "
                f"({', '.join(f'{k} {v:.1e}' for k, v in errs.items())})")
            runs["16a dry run"] = dict(K.FORM_LAUNCHES)
            ham, e0 = refs["ham_u4"], refs["e0_u4"]
            for label, solve in (
                    ("Kronecker", lambda: pmesh.distributed_lowest_states(
                        ham, mesh, seed=SEED, max_steps=200,
                        return_info=True)),
                    ("halo-Kronecker", lambda: halo_lowest_states(
                        ham, mesh, seed=SEED, max_steps=200,
                        return_info=True))):
                K.reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                evals, _, info = solve()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                runs[f"16a 14-site {label}"] = dict(K.FORM_LAUNCHES)
                err = abs(float(evals[0]) - e0) / abs(e0)
                say(f"phase 16a 14-site U=4, {label} form, world 1 on NCCL: "
                    f"dim {ham.dim}, steps {info.steps}, E0 "
                    f"{float(evals[0])!r} against phase 5's {e0!r}: rel err "
                    f"{err:.3e} (tol 1e-12), bit-equal "
                    f"{float(evals[0]) == e0}; wall {wall:.3f} s, peak "
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
                    f"launches {dict(K.FORM_LAUNCHES)}")
                check(info.converged, f"16a {label} unconverged")
                check(err <= 1e-12, f"16a {label} E0 off by {err:.3e}")
            betas = np.asarray([0.1, 0.5, 1.0, 2.0, 5.0, 20.0])
            K.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res_d = pmesh.distributed_ftlm(ham, mesh, betas, num_vectors=16,
                                           steps=80, seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            runs["16a 14-site ftlm R=16"] = dict(K.FORM_LAUNCHES)
            launches = dict(K.FORM_LAUNCHES)
            res_s = ftlm(ham, betas, num_vectors=16, steps=80, seed=SEED)
            err = float(np.max(np.abs(res_d.energy - res_s.energy)
                               / np.abs(res_s.energy)))
            say(f"phase 16a 14-site U=4 distributed_ftlm R 16, 80 steps, "
                f"world 1: energies {res_d.energy.tolist()} against the "
                f"single-process ftlm from the same block: max rel diff "
                f"{err:.3e} (tol 1e-8); wall {wall:.3f} s, launches "
                f"{launches}")
            check(err <= 1e-8, f"16a FTLM energies off by {err:.3e}")
            del res_d, res_s
            # the longer source: the 12-site sector's flat form, one rank's
            # rows of one (the gathered state as its source) and of 4
            label, text, parts = DIST_SECTORS[0]
            _, _, she = dist_build(text, parts, dev)
            x = dist_inputs(she, dev)
            sham = pmesh.shard_hamiltonian(she, mesh)
            src = mesh.gather_rows(mesh.local_rows(x, sham.dim))
            shard_ell_case(results, "f64 12-site SuperHubbardExtended flat "
                           "row shard, world 1, gathered source", sham,
                           mesh.local_rows(x, sham.dim), src, 0)
            quarter = pmesh.shard_hamiltonian(
                she, dataclasses.replace(mesh, size=DIST_RANKS))
            xq = x.new_zeros(quarter.dim)
            xq[:she.dim] = x
            shard_ell_case(results, f"f64 12-site SuperHubbardExtended flat "
                           f"row shard, rank 0 of {DIST_RANKS}, gathered "
                           f"source", quarter, xq[:quarter.rows].contiguous(),
                           xq, 0)
            del sham, quarter, she, src, xq
        finally:
            dist.destroy_process_group()

        # -- 16b: 4 gloo ranks on the one card ---------------------------
        t = time.perf_counter()
        single = {}
        bounds = {}
        for label, text, parts in DIST_SECTORS:
            _, _, ham = dist_build(text, parts, dev)
            x = dist_inputs(ham, dev)
            inner = ham.inner if hasattr(ham, "inner") else ham
            y = inner.matvec(x)
            e0 = (refs["e0_she"] if label == DIST_SECTORS[0][0] else
                  float(lz.lowest_states(ham, seed=SEED,
                                         max_steps=200)[0][0]))
            single[label] = dict(y=y, e0=e0)
            if label in DIST_ESTIMATOR_SECTORS:
                bounds[label] = spectral_bounds(inner)
                single[label]["est"] = dist_estimators(ham, dev,
                                                       bounds=bounds[label])
            del ham, inner, x, y
        say(f"phase 16b single-process references in "
            f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        outdir = os.path.join(work, "ranks")
        os.makedirs(outdir)
        ctx = mp.start_processes(dist_rank, args=(
            DIST_RANKS, os.path.join(work, "gloo"), outdir, bounds),
            nprocs=DIST_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + DIST_WORLD_SECONDS
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"the {DIST_RANKS}-rank gloo world did not end within "
                      f"{DIST_WORLD_SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        wall = time.perf_counter() - t
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(DIST_RANKS)]
        r0 = ranks[0]
        say(f"phase 16b {DIST_RANKS} ranks on one card: backend "
            f"{r0['backend']}, transport {r0['transport']}, device "
            f"{r0['device']}, world wall {wall:.3f} s (spawn included); "
            f"gloo on CUDA tensors: {r0['probe']}")
        check(all(r["transport"] == "gloo" for r in ranks),
              "16b transport")
        check(all(set(r["probe"].values()) == {"exact"} for r in ranks),
              f"16b gloo on CUDA tensors: {[r['probe'] for r in ranks]}")
        say(f"  dry run on {DIST_RANKS} ranks: worst deviation "
            f"{max(max(r['dryrun'].values()) for r in ranks):.3e}, wall "
            f"{max(r['walls']['dryrun'] for r in ranks):.3f} s, launches "
            f"(all ranks) {[r['sector_launches']['dry run'] for r in ranks]}")
        total = {}
        for r in ranks:
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
        for label, _, _ in DIST_SECTORS:
            ref = single[label]
            e0s = {k: v for k, v in r0["e0"].items()
                   if k.startswith(f"{label}, ")}
            check(all(r["e0"] == r0["e0"] for r in ranks),
                  f"16b {label}: the ranks' E0s differ")
            for key, e0 in e0s.items():
                form = key[len(label) + 2:]
                y_err = rel_err(r0["y"][key].to(dev), ref["y"])[1]
                e_err = abs(e0 - ref["e0"]) / abs(ref["e0"])
                say(f"  {key}: matvec against the single process "
                    f"{y_err:.3e} of max|y| (tol 1e-12), E0 {e0!r} against "
                    f"{ref['e0']!r}: rel {e_err:.3e} (tol 1e-10); solve "
                    f"{max(r['walls'][f'{key} solve'] for r in ranks):.3f} s"
                    + ("" if r0["halo"][key] is None else
                       f", halo fraction {r0['halo'][key]:.4f}"))
                check(y_err <= 1e-12, f"16b {key}: matvec off by {y_err:.3e}")
                check(e_err <= 1e-10, f"16b {key}: E0 off by {e_err:.3e}")
            say(f"  {label}: build {max(r['walls'][f'{label} build'] for r in ranks):.3f}"
                f" s a rank, launches (all ranks) "
                f"{[r['sector_launches'][label] for r in ranks]}")
            if label in DIST_ESTIMATOR_SECTORS:
                got, want = r0["est"][label], ref["est"]
                errs = {
                    "ftlm": float(np.max(np.abs(got["ftlm"] - want["ftlm"])
                                         / np.abs(want["ftlm"]))),
                    "fleet": float(np.max(np.abs(got["fleet"]
                                                 - want["fleet"]))),
                    "kpm": float(np.max(np.abs(got["kpm"] - want["kpm"]))
                                 / abs(want["kpm"][0])),
                    "dynamic": float(np.max(np.abs(got["dynamic"]
                                                   - want["dynamic"])))}
                say(f"  {label} estimators against the single process: FTLM "
                    f"energies {errs['ftlm']:.3e} (tol 1e-8), first 10 "
                    f"fleet coefficients {errs['fleet']:.3e} (tol 1e-9), KPM "
                    f"moments {errs['kpm']:.3e} of mu_0 (tol 1e-10), FTLM "
                    f"dynamics pole moments {errs['dynamic']:.3e} (tol "
                    f"1e-10); wall "
                    f"{max(r['walls'][f'{label} estimators'] for r in ranks):.3f} s")
                for name, tol in (("ftlm", 1e-8), ("fleet", 1e-9),
                                  ("kpm", 1e-10), ("dynamic", 1e-10)):
                    check(errs[name] <= tol,
                          f"16b {label} {name} off by {errs[name]:.3e}")
        say(f"  scatter plan (c_up at site 0, 12-site sector): "
            f"{max(r['scatter_err'] for r in ranks):.3e} against "
            f"apply_operator_map (tol 1e-12), wall "
            f"{max(r['walls']['scatter plan'] for r in ranks):.3f} s")
        check(max(r["scatter_err"] for r in ranks) <= 1e-12,
              "16b scatter plan")
        say(f"  shard-local ell_spmv with the gathered source (12-site flat "
            f"form, {DIST_RANKS} processes sharing one card): "
            f"{[round(r['shard_ell_ms'], 4) for r in ranks]} ms a rank, "
            f"nonzero entries {[r['shard_ell_nnz'] for r in ranks]}")
        say(f"  peak device memory a rank "
            f"{[round(r['peak_gb'], 2) for r in ranks]} GB, rank walls "
            f"{[round(r['walls']['rank'], 1) for r in ranks]} s; launches "
            f"by form, all ranks: {total}")
        runs[f"16b {DIST_RANKS} gloo ranks"] = total
        shard_ell_ms = [r["shard_ell_ms"] for r in ranks]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    forms = {}
    for counts in runs.values():
        for k, n in counts.items():
            forms[k] = forms.get(k, 0) + n
    say(f"phase 16 launches by form: {forms}; phase wall "
        f"{time.perf_counter() - started:.1f} s")
    for kernel in ("factor_matmul", "ell_spmv", "perm_gather"):
        check(sum(n for k, n in forms.items()
                  if k.split(" ")[0] == kernel) > 0,
              f"{kernel} was not launched in phase 16")
    return dict(forms=forms, runs=runs, shard_ell_ms=shard_ell_ms)


def main() -> None:
    started = time.perf_counter()
    # -- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.cli import lanczos_main
    from lanczosplusplus_tpu_torch.engine import Engine
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.ops import build
    from lanczosplusplus_tpu_torch.ops import kernels as K
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    check(torch.cuda.device_count() == 1,
          f"{torch.cuda.device_count()} cards visible; the smoke run uses "
          "one (set CUDA_VISIBLE_DEVICES to one card)")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"phase 1 env: card {torch.cuda.get_device_name(0)} ({smi}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    say(f"phase 2 build: {time.perf_counter() - t0:.3f} s, {lib.name}")
    lib_c = build.load_library()
    built = set()
    for r in build.kernel_resources(build.build_log()):
        # template arguments of a float64 factor_matmul instantiation:
        # BM, BN, X k-major, A k-major
        found = re.search(r"dmma_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)",
                          r["name"])
        # the sums' and the source's types, row tables
        gather = re.search(r"perm_gather_kernelI(.*?)Lb(\d)E", r["name"])
        # X k-major, A k-major, the sums' store type
        bf16 = re.search(r"factor_matmul_wgmma_kernelILb(\d)ELb(\d)E(\w)E",
                         r["name"])
        # tile rows and columns, X k-major, A k-major
        f32 = re.search(r"factor_matmul_simt_kernelILi(\d+)ELi(\d+)ELb(\d)"
                        r"ELb(\d)E", r["name"])
        if gather:
            tag = GATHER_TAGS[gather.group(1)]
            side = ("row tables" if gather.group(2) == "1"
                    else "rows the identity")
            label = (f"perm_gather {tag}, {side}, static smem "
                     f"{r['static_smem_bytes']} B")
            built.add(f"perm_gather {tag} {side}")
        elif bf16:
            xk, ak, out = bf16.groups()
            tag = {"d": "f64", "f": "f32"}[out]
            label = (f"factor_matmul bf16 operands into {tag} (wgmma, TMA), "
                     f"128x256 tile, X {'k' if xk == '1' else 'MN'}-major, A "
                     f"{'k' if ak == '1' else 'MN'}-major")
            built.add(f"factor_matmul bf16 {tag}")
        elif f32:
            bm, bn, xk, ak = f32.groups()
            label = (f"factor_matmul f32 {bm}x{bn} tile, X "
                     f"{'k' if xk == '1' else 'row'}-major, A "
                     f"{'k' if ak == '1' else 'row'}-major")
            built.add("factor_matmul f32")
        elif found:
            bm, bn, xk, ak = map(int, found.groups())
            bits = K.MatmulPlan(bool(xk), False, bool(ak), False, False,
                                bm).bits
            label = (f"factor_matmul f64 {bm}x{bn} tile, X "
                     f"{'k' if xk else 'row'}-major, A "
                     f"{'k' if ak else 'row'}-major, dynamic smem "
                     f"{lib_c.lpp_factor_matmul_f64_smem_bytes(bits)} B")
        else:
            # value type d or f, inside Cplx<...> for the complex ones (the
            # complex128 kernel is a template of the entries alone), then
            # the entries a lane takes at a time
            args = r["name"].split("ell_spmv_kernelI", 1)[1]
            cplx = re.search(r"4CplxI(\w)E", args)
            tag = ({"d": "c128", "f": "c64"}[cplx.group(1)] if cplx else
                   {"d": "f64", "f": "f32"}[args[0]])
            entries = re.search(r"Li(\d+)E", args).group(1)
            label = (f"ell_spmv {tag}, {entries} entries at a time, static "
                     f"smem {r['static_smem_bytes']} B")
            built.add(f"ell_spmv {tag}")
        say(f"  {label}: {r['registers']} registers, spill stores "
            f"{r['spill_store_bytes']} B, loads {r['spill_load_bytes']} B")
        check(r["spill_store_bytes"] == 0 and r["spill_load_bytes"] == 0,
              f"{r['name']} spills registers")
    check({"ell_spmv f64", "ell_spmv f32", "ell_spmv c128",
           "ell_spmv c64", "factor_matmul f32", "factor_matmul bf16 f32",
           "factor_matmul bf16 f64"} | {
               f"perm_gather {t} {side}" for t in GATHER_TAGS.values()
               for side in ("row tables", "rows the identity")} <= built,
          f"ell_spmv, perm_gather and float32 and bf16 factor_matmul "
          f"instantiations: {built}")
    for opcode, what in (("DMMA", "the float64 factor_matmul"),
                         ("HGMMA", "the bf16 factor_matmul")):
        found = build.sass_opcode_counts(lib, opcode)
        say(f"  {opcode} instructions in the library's machine code: "
            f"{found} (None: no cuobjdump)")
        check(found is None or sum(found.values()) > 0,
              f"{what} holds no {opcode} instruction")

    # -- 3. kernels against their plain versions ---------------------------
    say(f"phase 3 starts at {time.perf_counter() - started:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("phase 3 kernels: torch.backends.cuda.matmul.allow_tf32 = False")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"factor_matmul": [], "ell_spmv": [], "perm_gather": []}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt, tol, shapes in (
            (torch.float64, TOL_F64, ((3432, 3432, 3432), (1820, 1820, 1820),
                                      (924, 924, 924), (300, 123, 257))),
            (torch.float32, TOL_F32, ((3432, 3432, 3432), (924, 924, 924),
                                      (300, 123, 257)))):
        tag = "f64" if dt == torch.float64 else "f32"
        for m, n, k in shapes:
            x = torch.randn(m, k, generator=gen, device=dev, dtype=dt)
            a = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
            bound_ms = 1e3 * 2 * m * n * k / PEAK_FLOPS
            out = torch.empty(m, n, device=dev, dtype=dt)
            plan = K.factor_matmul_plan(
                x.data_ptr(), x.stride(), a.data_ptr(), a.stride(),
                out.data_ptr(), out.stride(), m, n, sms, 1, x.element_size())
            # float32: the same cp.async staging, an FMA consumer, the
            # large tile 256 x 128
            wide = plan.x_vec16 and plan.a_vec16
            vec = 16 // x.element_size()
            tile = ("256x128" if dt == torch.float32 and plan.tile == 128
                    else f"{plan.tile}x{plan.tile}")
            path = (f"{'FMA, ' if dt == torch.float32 else ''}{tile} tile, "
                    f"{16 if wide else x.element_size()}-byte copies")
            check(wide == (k % vec == 0),
                  f"{tag} {m}x{k}: 16-byte copies planned: {wide}")
            got = K.factor_matmul(x, a)
            ref = K.factor_matmul_ref(x, a)
            torch.cuda.synchronize()
            record(results, "factor_matmul", f"{tag} {m}x{k}.{n}x{k}^T ({path})", got,
                   ref, tol,
                   (lambda: K.factor_matmul(x, a, out=out),
                    lambda: K.factor_matmul_ref(x, a),
                    lambda: torch.matmul(x, a.T, out=out)),
                   bound_ms, "operations")
            if m != n:
                continue
            # the dn-factor form of the path: Y += A . X on transposed views
            y0 = torch.randn(m, m, generator=gen, device=dev, dtype=dt)
            got = y0.clone()
            K.factor_matmul(x.T, a, out=got.T, accumulate=True)
            ref = y0 + a @ x
            torch.cuda.synchronize()
            y1 = y0.clone()
            record(results, "factor_matmul",
                   f"{tag} {m}^3 Y+=A.X transposed views ({path})", got, ref,
                   tol,
                   (lambda: K.factor_matmul(x.T, a, out=y1.T,
                                            accumulate=True),
                    lambda: y1.T.add_(K.factor_matmul_ref(x.T, a)),
                    lambda: y1.addmm_(a, x)),
                   bound_ms, "operations")
            del x, a, y0, y1, got, ref, out

    # the batched forms of the spectral path, (rows, size_down, size_up):
    # 14 states of the 14-site N_up = 8 sector (odd pitch: 8-byte copies of
    # X, Y and the up factor) and the 23 of the 12-site N_up = 7 sector
    for rows, szd, szu in ((14, 3432, 3003), (23, 924, 792)):
        batched_factor_cases(results, gen, dev, sms, rows, szd, szu)
    xr = torch.randn(3, 300, 257, generator=gen, device=dev,
                     dtype=torch.float64)
    ar = torch.randn(123, 257, generator=gen, device=dev, dtype=torch.float64)
    got = K.factor_matmul(xr, ar)
    ref = K.factor_matmul_ref(xr, ar)
    torch.cuda.synchronize()
    out = torch.empty_like(got)
    record(results, "factor_matmul", "f64 ragged batch R=3 of 300x257.123x257^T "
           "(64-tile, 8-byte copies)", got, ref, TOL_F64,
           (lambda: K.factor_matmul(xr, ar, out=out),
            lambda: K.factor_matmul_ref(xr, ar),
            lambda: torch.matmul(xr, ar.T, out=out)),
           1e3 * 2 * 3 * 300 * 123 * 257 / PEAK_FLOPS, "operations")
    for x2 in (xr[0], torch.randn(924, 924, generator=gen, device=dev,
                                  dtype=torch.float64)):
        a2 = ar if x2.shape[1] == 257 else x2.flip(0)
        check(torch.equal(K.factor_matmul(x2[None], a2)[0],
                          K.factor_matmul(x2, a2)),
              f"factor_matmul: a batch of one {tuple(x2.shape)} differs "
              f"from the 2-D call")
    say("  factor_matmul: a batch of one equals the 2-D call bit for bit "
        "(300x257.123x257^T and 924^3)")
    del xr, ar, got, ref, out

    # a complex state through the real kernel as its two planes, at the
    # FeAs sector's one-spin size (1820 = C(16, 4)) and at input100's
    # (220 = C(12, 3)); the library call is torch.matmul on the complex
    # tensors.  Operations: a real factor takes two real products, a
    # complex one four.
    for size, factor_is_real in ((1820, True), (220, True), (1820, False)):
        xc = torch.randn(size, size, generator=gen, device=dev,
                         dtype=torch.complex128)
        ac = torch.randn(size, size, generator=gen, device=dev,
                         dtype=torch.complex128)
        a_in = ac.real.contiguous() if factor_is_real else ac
        a_lib = a_in.to(torch.complex128)
        before = K.LAUNCHES["factor_matmul"]
        got = K.factor_matmul(xc, a_in)
        went = K.LAUNCHES["factor_matmul"] - before
        check(went == (1 if factor_is_real else 3),
              f"complex factor_matmul made {went} launches")
        ref = K.factor_matmul_ref(xc, a_in)
        torch.cuda.synchronize()
        out = torch.empty_like(xc)
        products = 2 if factor_is_real else 4
        record(results, "factor_matmul",
               f"c128 planes {size}x{size}.{size}x{size}^T, "
               f"{'real' if factor_is_real else 'complex'} factor "
               f"({went} launch{'es' if went > 1 else ''} of the f64 kernel "
               f"over the planes)", got, ref, TOL_F64,
               (lambda: K.factor_matmul(xc, a_in, out=out),
                lambda: K.factor_matmul_ref(xc, a_in),
                lambda: torch.matmul(xc, a_lib.T, out=out)),
               1e3 * products * 2 * size ** 3 / PEAK_FLOPS, "operations")
        y0 = torch.randn(size, size, generator=gen, device=dev,
                         dtype=torch.complex128)
        got = y0.clone()
        K.factor_matmul(xc.T, a_in, out=got.T, accumulate=True)
        torch.cuda.synchronize()
        err = rel_err(got, y0 + a_lib @ xc)[1]
        check(err <= TOL_F64, f"complex dn form at {size}: {err:.3e}")
        check(torch.equal(K.factor_matmul(xc[None], a_in)[0],
                          K.factor_matmul(xc, a_in)),
              "complex factor_matmul: a batch of one differs")
        del xc, ac, a_in, a_lib, got, ref, out, y0

    she_text = super_hubbard_text(12)
    she_inp = parse_input(she_text)
    she_model = build_model(she_inp, Geometry(she_inp))
    she_basis = she_model.create_basis(she_model.default_parts(she_inp))
    she_ham = she_model.hamiltonian(she_basis, dtype=torch.float64,
                                    device=dev)
    jc, jv = she_ham.ell.cols, she_ham.ell.vals
    check(jc.is_contiguous() and jv.is_contiguous(),
          f"the model's J-ELL is not contiguous: strides {jc.stride()}")
    # the TSPCenter fleet's N_up = 7 sector, which phase 8 runs 23 rows in
    fleet_ham = she_model.hamiltonian(
        she_model.create_basis((7, 6)),
        dtype=torch.float64, device=dev)

    ell_cases = [
        (f"f64 12-site SuperHubbardExtended J-ELL, R={rows}", she_ham.diag,
         jc, jv, (jc.shape[0],) if rows == 1 else (rows, jc.shape[0]),
         TOL_ELL_F64) for rows in (1, 14)]
    ell_cases.append((
        "f64 J-ELL of the 12-site N_up = 7 sector, R=23", fleet_ham.diag,
        fleet_ham.ell.cols, fleet_ham.ell.vals, (23, fleet_ham.dim),
        TOL_ELL_F64))
    dim = 1_000_003
    for dt, tol, kk, shape in (
            (torch.float64, TOL_ELL_F64, 7, (dim,)),
            (torch.float32, TOL_F32, 7, (dim,)),
            (torch.float64, TOL_ELL_F64, 7, (14, dim)),
            # one entry past what a thread keeps in registers
            (torch.float64, TOL_ELL_F64, 17, (dim,)),
            (torch.float64, TOL_ELL_F64, 17, (14, dim))):
        ell_cases.append((
            f"{'f64' if dt == torch.float64 else 'f32'} random dim {dim} "
            f"K {kk}" + (f", R={shape[0]}" if len(shape) == 2 else ""),
            torch.randn(dim, generator=gen, device=dev, dtype=dt),
            torch.randint(0, dim, (dim, kk), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randn(dim, kk, generator=gen, device=dev, dtype=dt),
            shape, tol))

    def ell_case(case, diag, cols, vals, shape, tol, entries=None):
        """ell_spmv against its plain version on one (diag, cols, vals)
        and a random x of `shape`, through the sliced form the kernel
        reads (made here, outside the timed region, its bytes and seconds
        recorded; its own plain version held against the padded one),
        timed beside the bytes bound of y = Hx over the nonzero entries
        and the padded form's; `entries`, where given, is the count of
        nonzero entries the caller counted on the host."""
        x = torch.randn(shape, generator=gen, device=dev, dtype=diag.dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sliced = K.slice_ell(cols, vals)
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t
        check(entries is None or entries == sliced.nnz,
              f"ell_spmv {case}: {sliced.nnz} nonzero entries sliced, "
              f"{entries} counted")

        def member_by_member(fn):
            # a block's gather intermediate is batch x entries values:
            # member by member where that would not fit beside the matrix
            if x.dim() == 2 and x.numel() * max(
                    cols.shape[1], sliced.cols.numel() // max(
                        diag.shape[0], 1)) * x.element_size() > 8e9:
                return torch.stack([fn(row) for row in x])
            return fn(x)

        def plain():
            return member_by_member(
                lambda v: K.ell_spmv_ref(diag, cols, vals, v))
        got = K.ell_spmv(diag, cols, vals, x, sliced=sliced)
        ref = plain()
        sliced_err = rel_err(member_by_member(
            lambda v: K.ell_spmv_sliced_ref(diag, sliced, v)), ref)[1]
        torch.cuda.synchronize()
        check(sliced_err <= tol, f"ell_spmv {case}: the sliced plain "
                                 f"version differs by {sliced_err:.3e}")
        if len(shape) == 2:
            check(torch.equal(
                K.ell_spmv(diag, cols, vals, x[:1], sliced=sliced)[0],
                K.ell_spmv(diag, cols, vals, x[0], sliced=sliced)),
                "ell_spmv: a batch of one differs from the 1-D call")
            # an even member, an odd one and the last
            for b in (2, 3, shape[0] - 1):
                check(torch.equal(got[b], K.ell_spmv(diag, cols, vals, x[b],
                                                     sliced=sliced)),
                      f"ell_spmv: row {b} of the batch differs from its 1-D "
                      f"call")
        # the library's form: one CSR matrix, diagonal folded in, applied
        # by csr @ x (a block as a column-major (dim, R) copy), built
        # outside the timed region
        csr = ell_csr(diag, cols, vals)
        xl = x if x.dim() == 1 else x.T.contiguous()
        lib_err = rel_err((csr @ xl) if x.dim() == 1 else (csr @ xl).T,
                          ref)[1]
        check(lib_err <= TOL_F32 if diag.dtype in (torch.float32,
                                                    torch.complex64)
              else lib_err <= 1e-12, f"ell_spmv {case}: the CSR form "
                                     f"differs by {lib_err:.3e}")
        # per nonzero entry its index and value, per row diag read once,
        # per batch member x read and y written; the padded form reads K
        # entries a row
        size = x.element_size()
        vec_bytes = diag.shape[0] * (size + 2 * size * (
            shape[0] if len(shape) == 2 else 1))
        say(f"  ell_spmv {case}: sliced form {sliced.nbytes} bytes "
            f"({sliced.cols.numel()} slots for {sliced.nnz} nonzero "
            f"entries, widest slice {sliced.width}, typical "
            f"{sliced.typical_width}), made in {slice_s:.3f} s; the sliced "
            f"plain version against the padded one "
            f"{sliced_err:.3e}")
        record(results, "ell_spmv", case, got, ref, tol,
               (lambda: K.ell_spmv(diag, cols, vals, x, sliced=sliced),
                plain, lambda: csr @ xl),
               1e3 * (sliced.nnz * (4 + size) + vec_bytes) / PEAK_BYTES,
               "bytes",
               padded_bound_ms=1e3 * (cols.numel() * (4 + size) + vec_bytes)
               / PEAK_BYTES,
               nnz=sliced.nnz, slots=sliced.cols.numel(),
               sliced_bytes=sliced.nbytes, slice_s=slice_s,
               sliced_plain_rel_err=sliced_err)
        del csr, xl, sliced

    for case in ell_cases:
        ell_case(*case)
    say("  ell_spmv: a batch of one, and rows of every batch, equal the 1-D "
        "call bit for bit")
    del ell_cases, she_ham, fleet_ham, jc, jv

    # -- 4-6. the main path through the kernels ---------------------------
    say(f"phase 4 starts at {time.perf_counter() - started:.1f} s")
    K.reset_launches()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "input0.inp")
        with open(path, "w") as f:
            f.write(INPUT0)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            engine0 = lanczos_main.run(["-f", path, "-p", "17",
                                        "--device", "cuda"])
    printed = float(re.search(r"^Energy=(\S+)$", out.getvalue(),
                              re.M).group(1))
    err0 = abs(printed - E0_INPUT0)
    say(f"phase 4 input0 via CLI on cuda: Energy={printed!r} "
        f"(golden {E0_INPUT0!r}, abs err {err0:.3e}), dense branch "
        f"{engine0.solve_info.used_dense_fallback}")
    check(err0 <= 1e-12, f"input0 E0 off by {err0:.3e}")
    check(engine0.eigenvector(0).device.type == "cuda",
          "input0 eigenvector not on the card")

    def solve(text, v0=None):
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        config = Config.from_input(inp, device=dev)
        launches = K.LAUNCHES["factor_matmul"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine = Engine(model, inp, config=config, v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        matvecs = (K.LAUNCHES["factor_matmul"] - launches) // 2
        return engine, wall, matvecs

    nsite = 14
    torch.cuda.reset_peak_memory_stats(dev)
    eng_u0, wall_u0, mv_u0 = solve(hubbard_chain_text(nsite, 0))
    eps = np.sort(-2.0 * np.cos(2.0 * np.pi * np.arange(nsite) / nsite))
    e_free = 2.0 * eps[:nsite // 2].sum()
    rel_u0 = abs(eng_u0.ground_energy - e_free) / abs(e_free)
    dim14 = eng_u0.basis.size
    say(f"phase 5 14-site U=0: dim {dim14}, steps "
        f"{eng_u0.solve_info.steps}, matvecs {mv_u0}, E0 "
        f"{eng_u0.ground_energy!r}, free-fermion {e_free!r}, rel err "
        f"{rel_u0:.3e}, wall {wall_u0:.3f} s")
    check(dim14 == 11_778_624, f"14-site dim {dim14}")
    check(eng_u0.solve_info.converged, "14-site U=0 unconverged")
    check(rel_u0 <= TOL_E0, f"14-site U=0 rel err {rel_u0:.3e}")
    del eng_u0

    v0_u4 = lz.random_start_vector(dim14, SEED, torch.float64, dev)
    eng_u4, wall_u4, mv_u4 = solve(hubbard_chain_text(nsite, 4), v0=v0_u4)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"phase 5 14-site U=4: dim {dim14}, steps "
        f"{eng_u4.solve_info.steps}, matvecs {mv_u4}, E0 "
        f"{eng_u4.ground_energy!r}, wall {wall_u4:.3f} s, "
        f"{1e3 * wall_u4 / mv_u4:.3f} ms per Lanczos step, peak device "
        f"memory {peak_gb:.2f} GB")
    check(eng_u4.solve_info.converged, "14-site U=4 unconverged")
    # what phase 10 holds the factored forms and the gather apply against
    refs = {"e0_u4": eng_u4.ground_energy, "v0_u4": v0_u4,
            "ham_u4": eng_u4.hamiltonian}
    check(K.LAUNCHES["factor_matmul"] > 0, "factor_matmul never launched")

    v0_she = lz.random_start_vector(she_basis.size, SEED, torch.float64,
                                    dev)
    eng_she, wall_she, mv_she = solve(she_text, v0=v0_she)
    say(f"phase 6 12-site SuperHubbardExtended: dim {eng_she.basis.size}, "
        f"J bonds {eng_she.hamiltonian.ell.cols.shape[1]}, steps "
        f"{eng_she.solve_info.steps}, matvecs {mv_she}, E0 "
        f"{eng_she.ground_energy!r}, wall {wall_she:.3f} s")
    check(eng_she.solve_info.converged, "SuperHubbardExtended unconverged")
    refs["e0_she"] = eng_she.ground_energy

    launches = dict(K.LAUNCHES)
    say(f"main path kernel launches: {launches}; sliced forms made "
        f"{dict(K.SLICINGS)}")
    for name in ("factor_matmul", "ell_spmv"):
        check(launches[name] > 0, f"{name} was not launched on the main "
                                  f"path")
    # one ELL on the path (the SuperHubbardExtended J-ELL), sliced once
    check(K.SLICINGS == {"ell_spmv": 1},
          f"sliced forms made on the main path: {K.SLICINGS}")
    check(launches["perm_gather"] == 0,
          "the dense one-spin factors' path launched perm_gather")

    # -- 7. the same solves with the plain versions ------------------------
    say(f"phase 7 starts at {time.perf_counter() - started:.1f} s")
    for label, eng, v0 in (("14-site U=4", eng_u4, v0_u4),
                           ("12-site SuperHubbardExtended", eng_she,
                            v0_she)):
        t = time.perf_counter()
        evals, _ = lz.lowest_states(PlainForm(eng.hamiltonian),
                                    seed=SEED,
                                    max_steps=eng.config.lanczos_steps,
                                    v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        diff = abs(evals[0] - eng.ground_energy) / abs(evals[0])
        say(f"phase 7 {label} plain versions: E0 {float(evals[0])!r}, "
            f"kernel path {eng.ground_energy!r}, rel diff {diff:.3e}, "
            f"wall {wall:.3f} s")
        check(diff <= TOL_E0, f"{label} kernel vs plain rel diff {diff:.3e}")
    check(dict(K.LAUNCHES) == launches, "the plain solves launched a kernel")

    ham14 = eng_u4.hamiltonian
    x = eng_u4.eigenvector(0).contiguous()
    mv_ms = median_ms(lambda: ham14.matvec(x), 10)
    plain = PlainForm(ham14)
    mv_plain_ms = median_ms(lambda: plain.matvec(x), 10)
    say(f"phase 7 14-site matvec: kernels {mv_ms:.4f} ms, plain versions "
        f"{mv_plain_ms:.4f} ms")

    # -- 8. the spectral slice through the CLI ---------------------------
    say(f"phase 8 starts at {time.perf_counter() - started:.1f} s")
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    del eng_u4, ham14, plain, x
    torch.cuda.empty_cache()
    steps8, omegas = 100, np.linspace(-10.0, 10.0, 401)
    levels = np.linalg.eigvalsh(
        Geometry(parse_input(hubbard_chain_text(nsite, 0)))
        .coupling_matrix(0))
    spectral_launches = {name: 0 for name in K.LAUNCHES}

    def dos_run(u, gs_matvecs):
        """ComputeDensityOfStates=1 on the 14-site chain through the CLI;
        checks the launch counts the code predicts and returns (engine,
        the 14 collections, stderr)."""
        text = (hubbard_chain_text(nsite, u) + "ComputeDensityOfStates=1\n"
                f"SpectralSteps={steps8}\n")
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        engine, _, err, combs, wall = run_cli(lanczos_main, text)
        counts = dict(K.LAUNCHES)
        for name in counts:
            spectral_launches[name] += counts[name]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        setup = phase_seconds(err, "spectral start vectors")
        rec = phase_seconds(err, "batched recurrence")
        say(f"phase 8 14-site U={u} DOS via CLI: {len(combs)} .comb files, "
            f"wall {wall:.3f} s, host set-up of the start vectors (operator "
            f"maps, scatter plans, scatters) {setup} s, batched recurrences "
            f"{rec} s = {[round(1e3 * t / steps8, 3) for t in rec]} ms per "
            f"batched step of 14 rows, launches {counts}, peak device "
            f"memory {peak:.2f} GB")
        check(len(combs) == nsite and len(rec) == 2,
              f"{len(combs)} .comb files, {len(rec)} recurrences")
        # ground state: two GEMMs a matvec; fleet: two sectors, two
        # batched GEMMs a step, no ELL part in this model
        expect = 2 * gs_matvecs + 2 * 2 * steps8
        check(counts == {"factor_matmul": expect, "ell_spmv": 0,
                         "perm_gather": 0},
              f"U={u} DOS launches {counts}, predicted factor_matmul "
              f"{expect}, ell_spmv 0")
        # what phase 15 holds its float32 fleets against
        refs[f"dos_u{u}"] = dict(combs=combs, wall=wall, peak=peak, rec=rec)
        return engine, combs

    # U = 0: every fraction's poles are one-particle levels
    eng8, combs = dos_run(0, mv_u0)
    worst = 0.0
    for site, coll in enumerate(combs):
        check([cf.sigma for cf in coll.items] == [1, -1],
              f"site {site}: fractions {[cf.meta for cf in coll.items]}")
        for cf, want in zip(coll.items, (levels[nsite // 2:],
                                         levels[:nsite // 2])):
            poles, weights = cf.poles_and_weights()
            near = np.abs(poles[:, None] - want[None, :]) <= 1e-6
            for k, level in enumerate(want):
                # a level's weight is its degeneracy over the site count
                g = (np.abs(want - level) <= 1e-9).sum()
                worst = max(worst, abs(weights[near[:, k]].sum() - g / nsite))
            worst = max(worst, np.abs(weights[~near.any(axis=1)]).sum())
    say(f"phase 8 U=0: poles of all {2 * nsite} fractions (steps kept "
        f"{sorted({len(cf.alphas) for c in combs for cf in c.items})}) "
        f"against the hopping matrix's levels, addition on the "
        f"{nsite - nsite // 2} empty and removal on the {nsite // 2} filled "
        f"ones, weights g/{nsite}: worst deviation {worst:.3e}")
    check(worst <= 1e-9, f"U=0 pole weights off by {worst:.3e}")
    del eng8, combs
    torch.cuda.empty_cache()

    # U = 4: sum rules, kernel path against plain path, batched against
    # serial
    eng8, combs = dos_run(4, mv_u4)
    w_add = np.array([c.items[0].weight for c in combs])
    w_rem = np.array([c.items[1].weight for c in combs])
    sum_err = np.abs(w_add + w_rem - 1).max()
    occ_err = np.abs(w_rem - 0.5).max()
    say(f"phase 8 U=4 sum rules over {nsite} sites: max |w_add + w_rem - 1| "
        f"{sum_err:.3e}, max |w_rem - 1/2| {occ_err:.3e}")
    check(sum_err <= 1e-10 and occ_err <= 1e-10, "U=4 sum rules")
    gs = eng8.eigenvector(0)
    for op_name, parts, slot in (("cdagger", (nsite // 2 + 1, nsite // 2), 0),
                                 ("c", (nsite // 2 - 1, nsite // 2), 1)):
        basis_new = eng8._cached_basis(parts)
        _, Z = eng8._batched_modified_states(
            LabeledOperator(op_name), basis_new, gs, 0, 0, dressed=False)
        # normalized as spectral_functions_batched does, bit for bit:
        # plain Lanczos amplifies a last-bit difference of the start
        norms = np.sqrt((Z.abs() ** 2).sum(dim=1).cpu().numpy())
        v0s = Z / torch.as_tensor(norms, device=dev)[:, None]
        del Z
        ham_new = eng8._cached_dense_hamiltonian(parts)
        ress_kernel, ress_plain, walls, apply_err = recurrence_both_ways(
            lz, K, ham_new, v0s, steps8)
        coef_err, fn_err, cli_err = fractions_differ(
            [(ress_kernel[site], ress_plain[site], combs[site].items[slot])
             for site in range(nsite)], omegas, lead=20, cli_lead=20)
        say(f"phase 8 U=4 sector {parts} (dim {basis_new.size}), "
            f"{steps8} batched steps of {nsite} rows, kernel path "
            f"{[round(1e3 * t / steps8, 3) for t in walls['kernel']]} ms per "
            f"step, plain versions "
            f"{[round(1e3 * t / steps8, 3) for t in walls['plain']]} ms per "
            f"step (turns plain, kernel); kernel against "
            f"plain: one apply, worst of 20 steps, {apply_err:.3e} of max "
            f"|y|; first 20 (alpha, beta) max diff {coef_err:.3e} of their "
            f"maximum, -Im G(w + 0.1i)/pi on {len(omegas)} points max diff "
            f"{fn_err[0.1]:.3e} of its maximum; CLI's fractions against "
            f"this recurrence, first 20 coefficients, max abs diff "
            f"{cli_err:.3e}")
        check(apply_err <= TOL_F64, f"kernel vs plain apply {apply_err:.3e}")
        check(coef_err <= 1e-9, f"kernel vs plain coefficients {coef_err:.3e}")
        check(fn_err[0.1] <= 1e-8,
              f"kernel vs plain function {fn_err[0.1]:.3e}")
        check(cli_err <= 1e-9, f"CLI fractions vs recurrence {cli_err:.3e}")
        del v0s, ress_kernel, ress_plain
    # the serial spectral_function of site 0 runs the selective
    # recurrence with a stored basis.  Plain Lanczos coefficients are not
    # stable to rounding, so the two fractions share only their first
    # coefficients, and truncated at 100 steps they agree as functions
    # to 1e-8 only at a broadening the truncation resolves (delta = 1); at
    # 0.1 they are held to 1e-6.
    K.reset_launches()
    serial, labels = eng8.spectral_function("c", 0, 0)
    for name in K.LAUNCHES:
        spectral_launches[name] += K.LAUNCHES[name]
    check(labels == [cf.meta for cf in combs[0].items],
          f"serial labels {labels}")
    lead = max(np.abs(s_.alphas[:6] - b_.alphas[:6]).max()
               for s_, b_ in zip(serial.items, combs[0].items))
    diffs = {}
    for delta in (1.0, 0.1):
        a, b = (spectral_density(c, omegas, delta)
                for c in (combs[0], serial))
        diffs[delta] = np.abs(a - b).max() / np.abs(b).max()
    say(f"phase 8 U=4 site 0, batched against serial spectral_function "
        f"({K.LAUNCHES['factor_matmul']} factor_matmul launches): weights "
        f"{[cf.weight for cf in serial.items]}, first 6 alphas max abs diff "
        f"{lead:.3e}, -Im G/pi max diff of its maximum: {diffs[1.0]:.3e} at "
        f"delta 1, {diffs[0.1]:.3e} at delta 0.1")
    check(max(abs(s_.weight - b_.weight)
              for s_, b_ in zip(serial.items, combs[0].items)) <= 1e-12,
          "serial and batched weights differ")
    check(lead <= 1e-8 and diffs[1.0] <= 1e-8 and diffs[0.1] <= 1e-6,
          f"batched vs serial: alphas {lead:.3e}, function {diffs}")
    check(K.LAUNCHES["factor_matmul"] == 2 * 2 * steps8,
          f"serial launches {dict(K.LAUNCHES)}")
    del eng8, combs, serial, gs
    torch.cuda.empty_cache()

    # the batched ell_spmv on a path: a TSPCenter fleet of the 12-site
    # SuperHubbardExtended chain, 23 rows in each of two sectors
    steps_she = 20
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    eng8, out8, err8, combs, wall = run_cli(
        lanczos_main, she_text + f"TSPCenter=0\nSpectralSteps={steps_she}\n",
        ["-g", "c"])
    counts = dict(K.LAUNCHES)
    refs["tsp_she"] = dict(
        combs=combs, wall=wall,
        peak=torch.cuda.max_memory_allocated(dev) / 1e9,
        rec=phase_seconds(err8, "batched recurrence"))
    for name in counts:
        spectral_launches[name] += counts[name]
    rec = phase_seconds(err8, "batched recurrence")
    rows8 = [int(r) for r in re.findall(r"batched recurrence sector .* "
                                        r"rows=(\d+) steps=\d+ done", err8)]
    say(f"phase 8 12-site SuperHubbardExtended TSPCenter=0 via CLI -g c: "
        f"{len(combs)} .comb files, rows per sector {rows8}, wall "
        f"{wall:.3f} s, batched recurrences {rec} s = "
        f"{[round(1e3 * t / steps_she, 3) for t in rec]} ms per batched "
        f"step, launches {counts}")
    expect = {"factor_matmul": 2 * mv_she + 2 * 2 * steps_she,
              "ell_spmv": mv_she + 2 * steps_she, "perm_gather": 0}
    check("TSPCenter=0" in out8 and len(combs) == 12 and rows8 == [23, 23],
          f"TSPCenter fleet: {len(combs)} files, rows {rows8}")
    check(counts == expect, f"TSPCenter launches {counts}, predicted "
                            f"{expect}")
    for site, coll in enumerate(combs):
        total = sum(cf.weight for cf in coll.items)
        # sum of all four types' weights is <{c_0, c_i^dag}> = delta_0i
        check(abs(total - (site == 0)) <= 1e-10,
              f"TSPCenter pair (0, {site}): weights sum to {total!r}")
        check(all(np.isfinite(spectral_density(coll, omegas, 0.1))),
              f"TSPCenter pair (0, {site}): not finite")
    # the fleet's two recurrences again, through the kernels and through
    # the plain versions, from its own start vectors: c_0|gs> for the pair
    # (0, 0), (c_0 + c_j)|gs> and (c_0 - c_j)|gs> for every other pair
    # (types 0 and 2 add a particle, 1 and 3 remove one).  ell_spmv sums a
    # row in another order than the plain version, one unit in the last
    # place of an apply, and the plain recurrence multiplies a difference
    # by 4 to 5 a step from about the sixth on (two plain versions that
    # differ only in that order part the same way).  So every apply is
    # held to 1e-13 on the recurrence's own blocks, the first 10
    # coefficients to 1e-9, and the truncated fractions as functions to
    # 1e-8 at delta 1 and 1e-6 at delta 0.1, as batched against serial is.
    gs = eng8.eigenvector(0)
    for op_name, parts, types in (("cdagger", (7, 6), (0, 2)),
                                  ("c", (5, 6), (1, 3))):
        basis_new = eng8._cached_basis(parts)
        _, Z = eng8._batched_modified_states(
            LabeledOperator(op_name), basis_new, gs, 0, 0, dressed=False)
        M = torch.stack([Z[0]] + [Z[0] + sign * Z[j] for j in range(1, 12)
                                  for sign in (1.0, -1.0)])
        fractions = [combs[0].items[types[0] & 1]] + [
            combs[j].items[t] for j in range(1, 12) for t in types]
        norms = np.sqrt((M.abs() ** 2).sum(dim=1).cpu().numpy())
        v0s = M / torch.as_tensor(norms, device=dev)[:, None]
        del Z, M
        ham_new = eng8._cached_dense_hamiltonian(parts)
        check(ham_new.ell is not None and v0s.shape[0] == 23,
              f"fleet sector {parts}: {v0s.shape[0]} rows")
        ress_kernel, ress_plain, walls, apply_err = recurrence_both_ways(
            lz, K, ham_new, v0s, steps_she)
        coef_err, fn_err, cli_err = fractions_differ(
            zip(ress_kernel, ress_plain, fractions), omegas, lead=10,
            cli_lead=steps_she)
        say(f"phase 8 TSPCenter fleet sector {parts} (dim {basis_new.size}, "
            f"J-ELL K {ham_new.ell.cols.shape[1]}), {steps_she} batched "
            f"steps of 23 rows, kernel path "
            f"{[round(1e3 * t / steps_she, 3) for t in walls['kernel']]} ms "
            f"per step, plain versions "
            f"{[round(1e3 * t / steps_she, 3) for t in walls['plain']]} ms "
            f"per step (turns plain, kernel); kernel against "
            f"plain: one apply, worst of {steps_she} steps, {apply_err:.3e} "
            f"of max |y|; first 10 (alpha, beta) max diff {coef_err:.3e} of "
            f"their maximum, -Im G/pi max diff of its maximum "
            f"{fn_err[1.0]:.3e} at delta 1, {fn_err[0.1]:.3e} at delta 0.1; "
            f"CLI's fractions against this recurrence, all {steps_she} "
            f"coefficients, max abs diff {cli_err:.3e}")
        check(apply_err <= TOL_ELL_F64,
              f"fleet kernel vs plain apply {apply_err:.3e}")
        check(coef_err <= 1e-9, f"fleet kernel vs plain coefficients "
                                f"{coef_err:.3e}")
        check(fn_err[1.0] <= 1e-8 and fn_err[0.1] <= 1e-6,
              f"fleet kernel vs plain function {fn_err}")
        check(cli_err <= 1e-9, f"fleet CLI fractions vs recurrence "
                               f"{cli_err:.3e}")
        del v0s, ress_kernel, ress_plain
    del eng8, combs, gs

    # two_point on the card against the CPU path, same ground state
    cpu_engine = Engine(she_model, she_inp, config=Config(
        device="cpu", lanczos_steps=2), v0=eng_she.eigenvector(0).cpu())
    cpu_engine._vectors = eng_she._vectors.cpu()
    before = dict(K.LAUNCHES)
    for op_name in ("n", "c"):
        t = time.perf_counter()
        got = eng_she.two_point(op_name)
        wall = time.perf_counter() - t
        diff = np.abs(got - cpu_engine.two_point(op_name)).max()
        trace = np.trace(got).real
        say(f"phase 8 12-site two_point({op_name!r}) on the card against "
            f"the CPU path: max abs diff {diff:.3e}, trace {trace!r}, "
            f"{wall:.3f} s on the card (first call: host maps included)")
        check(diff <= 1e-10, f"two_point({op_name!r}) card vs CPU {diff:.3e}")
        if op_name == "c":
            check(abs(trace - 6) <= 1e-10, f"trace of <c^dag_j c_i> {trace!r}")
    check(dict(K.LAUNCHES) == before, "two_point launched a kernel")
    say(f"spectral path kernel launches: {spectral_launches}")
    for name in ("factor_matmul", "ell_spmv"):
        check(spectral_launches[name] > 0,
              f"{name} was not launched on the spectral path")

    # -- 9. the flat models at full width -------------------------------
    say(f"phase 9 starts at {time.perf_counter() - started:.1f} s")
    del eng_she, cpu_engine
    torch.cuda.empty_cache()
    flat_launches = {}   # run label -> launches of that run

    def solve_flat(label, text, gemms, ells, golden=None, cases=()):
        """One flat model through the Engine on the card: launches set to
        0 before and read after and held against `gemms` and `ells`
        launches a matvec, the host's build timed apart, E0 against
        `golden` and against the plain versions from the same start
        vector; then ell_spmv on the model's own arrays for each
        (case label, batch) of `cases`.  Returns the engine."""
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        config = Config.from_input(inp, device=dev)
        host_s = {"create_basis": 0.0, "hamiltonian": 0.0}

        def timed(name):
            method = getattr(model, name)

            def call(*args, **kwargs):
                t = time.perf_counter()
                made = method(*args, **kwargs)
                torch.cuda.synchronize()
                host_s[name] += time.perf_counter() - t
                return made
            setattr(model, name, call)
        timed("create_basis")
        timed("hamiltonian")
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine = Engine(model, inp, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        flat_launches[label] = counts
        slicings = K.SLICINGS.get("ell_spmv", 0)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        ham, info = engine.hamiltonian, engine.solve_info
        dim, basis_s = ham.dim, host_s["create_basis"]
        build_s = [host_s["hamiltonian"]]
        # the start vector the Engine drew, for the plain solve below
        v0 = lz.random_start_vector(dim, config.seed, ham.dtype, dev)
        # the step count doubles from the first pass until the residual is
        # small: the matvecs are the sum over the passes
        first = min(dim, config.lanczos_steps)
        matvecs = 0 if info.used_dense_fallback else 2 * info.steps - first
        width = ham.ell.cols.shape[1] if ham.ell is not None else 0
        solve_s = wall - sum(build_s) - basis_s
        say(f"phase 9 {label}: dim {dim}, {ham.dtype}, ELL K {width}, "
            f"one-spin factors "
            f"{None if ham.factorized is None else tuple(ham.factorized.up_dense.shape)}"
            f", steps {info.steps}, matvecs {matvecs}, E0 "
            f"{engine.ground_energy!r}, time to E0 {wall:.3f} s = basis "
            f"{basis_s:.3f} + host build and transfer of the arrays "
            f"{sum(build_s):.3f} + solve {solve_s:.3f} s"
            + (f" ({1e3 * solve_s / matvecs:.3f} ms a step)" if matvecs
               else " (dense branch)")
            + f", launches {counts}, sliced forms made {slicings}, peak "
              f"device memory {peak:.2f} GB")
        check(info.converged, f"{label} unconverged")
        check(slicings == (1 if ells * matvecs else 0),
              f"{label}: {slicings} sliced forms made")
        refs[label] = engine.ground_energy
        check(counts == {"factor_matmul": gemms * matvecs,
                         "ell_spmv": ells * matvecs, "perm_gather": 0},
              f"{label}: launches {counts}, predicted factor_matmul "
              f"{gemms * matvecs}, ell_spmv {ells * matvecs}")
        check(engine.eigenvector(0).device.type == "cuda"
              and engine.eigenvector(0).dtype == ham.dtype,
              f"{label}: eigenvector {engine.eigenvector(0).dtype}")
        if golden is not None:
            err = abs(engine.ground_energy - golden) / abs(golden)
            say(f"  against its golden {golden!r}: rel err {err:.3e}")
            check(err <= TOL_E0, f"{label} E0 off its golden by {err:.3e}")
        if matvecs:
            t = time.perf_counter()
            evals, _ = lz.lowest_states(PlainForm(ham), seed=SEED,
                                        max_steps=config.lanczos_steps,
                                        v0=v0)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t
            diff = abs(evals[0] - engine.ground_energy) / abs(evals[0])
            say(f"  plain versions from the same start: E0 "
                f"{float(evals[0])!r}, rel diff {diff:.3e}, solve "
                f"{plain_wall:.3f} s")
            check(diff <= TOL_E0, f"{label} kernel vs plain {diff:.3e}")
            check(dict(K.LAUNCHES) == counts,
                  f"{label}: the plain solve launched a kernel")
        for case, rows in cases:
            ell_case(f"{case}, R={rows}", ham.diag, ham.ell.cols,
                     ham.ell.vals, (dim,) if rows == 1 else (rows, dim),
                     TOL_ELL_F64)
        return engine

    def cli_energy(label, text, golden):
        """A TestSuite input through the CLI on the card, at its golden."""
        K.reset_launches()
        engine, out, _, _, wall = run_cli(lanczos_main, text)
        flat_launches[label] = dict(K.LAUNCHES)
        energy = float(re.search(r"^Energy=(\S+)$", out, re.M).group(1))
        err = abs(energy - golden) / abs(golden)
        info = engine.solve_info
        say(f"phase 9 {label} via CLI on cuda: dim {engine.basis.size}, "
            f"{engine.hamiltonian.dtype}, Energy={energy!r} (golden "
            f"{golden!r}, rel err {err:.3e}), steps {info.steps}, dense "
            f"branch {info.used_dense_fallback}, wall {wall:.3f} s, "
            f"launches {flat_launches[label]}")
        check(err <= TOL_E0, f"{label} E0 off its golden by {err:.3e}")
        check(engine.eigenvector(0).dtype == torch.complex128
              and engine.eigenvector(0).device.type == "cuda",
              f"{label}: a useComplex run must be complex128 on the card")
        return engine

    # Heisenberg: the 12-site ring of the verify recipe, then 24 sites
    solve_flat("12-site Heisenberg ring", heisenberg_ring_text(12), 0, 1,
               golden=E0_HEISENBERG12)
    eng9 = solve_flat("24-site Heisenberg ring", heisenberg_ring_text(24),
                      0, 1, cases=(("f64 24-site Heisenberg ELL", 1),
                                   ("f64 24-site Heisenberg ELL", 14)))
    check(eng9.basis.size == 2_704_156
          and eng9.hamiltonian.ell.cols.shape[1] == 48,
          f"24-site Heisenberg: dim {eng9.basis.size}")
    refs["heisenberg24 vector"] = eng9.eigenvector(0)
    del eng9
    torch.cuda.empty_cache()

    # t-J: 18 sites with two holes; the 8-site ring's G_00 through -g
    eng9 = solve_flat("18-site t-J ring, 8 up 8 down", tj_ring_text(18, 8, 8),
                      0, 1, cases=(("f64 18-site t-J ELL", 1),))
    check(eng9.basis.size == 1_969_110, f"18-site t-J: dim {eng9.basis.size}")
    del eng9
    torch.cuda.empty_cache()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "goldens.json")) as f:
        goldens = json.load(f)
    K.reset_launches()
    eng9, _, _, combs, wall = run_cli(
        lanczos_main, tj_ring_text(8, 3, 3) + "TSPSites 2 0 0\n",
        ["-g", "c"])
    flat_launches["8-site t-J -g"] = dict(K.LAUNCHES)
    got = combs[0].evaluate(np.asarray(goldens["gf_tj_omegas"]),
                            goldens["gf_tj_delta"])
    want = np.asarray(goldens["gf_tj_re"]) + 1j * np.asarray(
        goldens["gf_tj_im"])
    gf_err = np.abs(got - want).max() / np.abs(want).max()
    refs["gf_tj"] = got
    say(f"phase 9 8-site t-J ring via CLI -g c, G_00(omega + 0.25i) on "
        f"{len(want)} points against the dense Lehmann sum of goldens.json: "
        f"max rel err {gf_err:.3e} (tolerance 1e-9), wall {wall:.3f} s, "
        f"launches {flat_launches['8-site t-J -g']}")
    check(gf_err <= 1e-9, f"gf_tj off its golden by {gf_err:.3e}")
    check(flat_launches["8-site t-J -g"]["ell_spmv"] > 0,
          "the t-J -g run launched no ell_spmv")
    del eng9, combs

    # Rashba: input10 (dense branch), then 12 sites in complex128
    cli_energy("input10", INPUT10, E0_INPUT10)
    eng9 = solve_flat("12-site Rashba ring, 12 electrons",
                      rashba_ring_text(12, 12), 0, 1,
                      cases=(("c128 12-site Rashba ELL", 1),
                             ("c128 12-site Rashba ELL", 14)))
    check(eng9.basis.size == 2_704_156
          and eng9.hamiltonian.dtype == torch.complex128
          and bool((eng9.hamiltonian.ell.vals.imag != 0).any()),
          f"12-site Rashba: dim {eng9.basis.size}, "
          f"{eng9.hamiltonian.dtype}")
    del eng9
    torch.cuda.empty_cache()

    # FeAs: input100 and input104 as they are, then the 8-site sector
    for label, text, golden in (("input100", INPUT100, E0_INPUT100),
                                ("input104", INPUT104, E0_INPUT104)):
        eng9 = cli_energy(label, text, golden)
        counts = flat_launches[label]
        f9 = eng9.hamiltonian.factorized
        check(eng9.basis.size == 48_400 and not f9.up_dense.is_complex(),
              f"{label}: dim {eng9.basis.size}, factors {f9.up_dense.dtype}")
        # real factors under a complex state: one launch over the two
        # planes for each factor, one complex ell_spmv, a matvec
        check(counts["ell_spmv"] > 0
              and counts["factor_matmul"] == 2 * counts["ell_spmv"],
              f"{label}: launches {counts}")
        del eng9, f9
    eng9 = solve_flat("8-site two-orbital FeAs sector, 4 up 4 down",
                      feas_ring_text(8, 4, 4), 2, 1,
                      cases=(("f64 8-site FeAs interaction ELL", 1),))
    check(eng9.basis.size == 3_312_400 and tuple(
        eng9.hamiltonian.factorized.up_dense.shape) == (1820, 1820),
        f"8-site FeAs: dim {eng9.basis.size}")
    del eng9
    torch.cuda.empty_cache()
    say(f"flat models' kernel launches: {flat_launches}")

    # -- 10. the factored forms and the one-spin gather apply -----------
    say(f"phase 10 starts at {time.perf_counter() - started:.1f} s")
    factored_runs, cross_cases = factored_phase(dev, gen, results, refs)
    say(f"factored forms' kernel launches: "
        f"{ {label: run['counts'] for label, run in factored_runs.items()} }")

    # -- 11. the symmetry sectors ----------------------------------------
    say(f"phase 11 starts at {time.perf_counter() - started:.1f} s")
    sym_runs = symmetry_phase(dev, gen, results, refs, ell_case)

    # -- 12. the estimators and their command lines ----------------------
    say(f"phase 12 starts at {time.perf_counter() - started:.1f} s")
    est_runs = estimator_phase(dev, gen, results, refs, ell_case)

    # -- 13. the last command lines and input forms, the native runtime --
    say(f"phase 13 starts at {time.perf_counter() - started:.1f} s")
    cli_runs, native_line = cli_phase(dev, refs, ell_case)

    # -- 14. float32 solves, their refinement, the bf16 forms ------------
    say(f"phase 14 starts at {time.perf_counter() - started:.1f} s")
    low_runs = lowprec_phase(dev, gen, results, refs, ell_case)
    low_forms = {}
    for counts in low_runs.values():
        for form, n in counts.items():
            low_forms[form] = low_forms.get(form, 0) + n
    say(f"phase 14 kernel launches by form: {low_forms}")

    # -- 15. float32 and complex64 on the fleets, estimators, symmetry ---
    say(f"phase 15 starts at {time.perf_counter() - started:.1f} s")
    f32_runs, f32_batched = float32_paths_phase(dev, gen, results, refs,
                                                ell_case)
    # what phase 16 holds its runs against; the rest is freed
    dist_refs = {key: refs[key] for key in ("ham_u4", "e0_u4", "e0_she")}
    del refs
    f32_forms = {}
    for counts in f32_runs.values():
        for form, n in counts.items():
            f32_forms[form] = f32_forms.get(form, 0) + n
    say(f"phase 15 kernel launches by form: {f32_forms}")
    fleets = (f32_batched["15a 14-site U=4 DOS"]
              + f32_batched["15a 14-site U=0 DOS"])

    # -- 16. distribution ---------------------------------------------------
    say(f"phase 16 starts at {time.perf_counter() - started:.1f} s")
    dist16 = distributed_phase(dev, results, dist_refs)

    sources = {"factor_matmul": ("lanczosplusplus_tpu_torch/csrc/"
                                 "factor_matmul.cu",
                                 "lanczosplusplus_tpu/ops/pallas_kernels.py:47"),
               "ell_spmv": ("lanczosplusplus_tpu_torch/csrc/ell_spmv.cu",
                            "lanczosplusplus_tpu/ops/pallas_kernels.py:102"),
               # no TPU kernel: the JAX package's gathers run outside
               # Pallas, as bond loops
               "perm_gather": ("lanczosplusplus_tpu_torch/csrc/perm_gather.cu",
                               "none: no TPU kernel; the JAX package's bond "
                               "loops lanczosplusplus_tpu/core/blockkron.py:"
                               "169 and core/sparse.py:126")}
    # One entry for each kernel and form of a path.  The counts of the
    # spectral runs were checked against the code's prediction above, so
    # their batched share is known: two DOS runs and the fleet, two sectors
    # each, one launch a step of the up form, the dn form and (the fleet's)
    # ell_spmv; the rest of those runs' launches are their ground states'
    # and the serial spectral_function's, at the ground-state path's shapes.
    batched = {"factor_matmul": 2 * (2 * 2 * steps8 + 2 * steps_she),
               "ell_spmv": 2 * steps_she}
    unbatched = "ground state, and the unbatched launches of the spectral runs"

    def flat_count(kernel, *words):
        """Launches of `kernel` over phase 9's runs whose label holds one
        of `words`."""
        return sum(counts[kernel] for label, counts in flat_launches.items()
                   if any(w in label for w in words))

    def sym_count(kernel, kind):
        """Launches of `kernel` over phase 11's runs of one kind."""
        return sum(counts[kernel] for run_kind, counts in sym_runs.values()
                   if run_kind == kind)

    def form_count(form):
        """Launches of one form over phase 10's runs, as counted at the
        form's call sites."""
        return sum(run["forms"].get(form, 0)
                   for run in factored_runs.values())

    # the PermCrossTerm case that carries the most device time on its run
    # (its ms times the run's applies, one launch of the term each) stands
    # for the cross terms; the others are listed beside it
    cross = [dict(case=r["case"], ms=r["ms"], bound_ms=r["bound_ms"],
                  library_ms=r["library_ms"], run=cross_cases[r["case"]],
                  device_ms_on_run=r["ms"] * factored_runs[
                      cross_cases[r["case"]]]["applies"]["blockkron"])
             for r in results["perm_gather"] if r["case"] in cross_cases]
    cross.sort(key=lambda c: -c["device_ms_on_run"])
    entries = (  # name, path, the phase 3 case of its shape, launches
        ("factor_matmul", unbatched, "f64 3432x3432.3432x3432^T",
         launches["factor_matmul"] + spectral_launches["factor_matmul"]
         - batched["factor_matmul"]),
        ("factor_matmul (batched, up form)", "spectral",
         "f64 batched up form (14*3432)", batched["factor_matmul"] // 2),
        ("factor_matmul (batched, dn form)", "spectral",
         "f64 batched dn form R=14", batched["factor_matmul"] // 2),
        ("ell_spmv", unbatched, "f64 12-site SuperHubbardExtended J-ELL, R=1",
         launches["ell_spmv"] + spectral_launches["ell_spmv"]
         - batched["ell_spmv"]),
        ("ell_spmv (batched)", "spectral",
         "f64 J-ELL of the 12-site N_up = 7 sector, R=23",
         batched["ell_spmv"]),
        # the flat models' forms, with the launches of phase 9's runs
        ("factor_matmul (FeAs one-spin factors)", "flat models",
         "f64 1820x1820.1820x1820^T", flat_count("factor_matmul", "FeAs")),
        ("factor_matmul (complex planes)", "flat models",
         "c128 planes 220x220.220x220^T, real factor",
         flat_count("factor_matmul", "input100", "input104")),
        ("ell_spmv (wide rows)", "flat models",
         "f64 24-site Heisenberg ELL, R=1",
         flat_count("ell_spmv", "Heisenberg", "t-J")),
        ("ell_spmv (complex128)", "flat models",
         "c128 12-site Rashba ELL, R=1",
         flat_count("ell_spmv", "Rashba", "input100", "input104")),
        ("ell_spmv (FeAs interaction ELL)", "flat models",
         "f64 8-site FeAs interaction ELL, R=1",
         flat_count("ell_spmv", "FeAs")),
        # the factored forms and the one-spin gather apply (phase 10)
        ("perm_gather", "factored forms: cross terms", cross[0]["case"],
         form_count("cross term")),
        ("perm_gather (one-spin up)", "one-spin gather apply",
         "f64 14-site one-spin up gather form, R=1",
         form_count("one-spin up")),
        ("perm_gather (one-spin dn)", "one-spin gather apply",
         "f64 14-site one-spin dn gather form, R=1",
         form_count("one-spin dn")),
        ("factor_matmul (factored, within-block)", "factored forms",
         "f64 24-site Heisenberg largest block", form_count("within")),
        ("factor_matmul (factored, tier)", "factored forms",
         "f64 18-site t-J tier", form_count("tier")),
        ("factor_matmul (factored, Kitaev)", "factored forms",
         "f64 24-site Kitaev left half", form_count("kitaev")),
        # the symmetry sectors (phase 11)
        ("ell_spmv (symmetry, momentum blocks)",
         "symmetry: translation blocks", "c128 14-site momentum block R=1",
         sym_count("ell_spmv", "translation blocks")),
        ("ell_spmv (symmetry, parity blocks)", "symmetry: reflection blocks",
         "f64 14-site parity block R=1",
         sym_count("ell_spmv", "reflection blocks")),
        ("factor_matmul (symmetry, projected Kitaev)",
         "symmetry: projected translation", "f64 22-site Kitaev left half",
         sym_count("factor_matmul", "projected")),
        # the estimators (phase 12): 12a's batched FTLM recurrence, two
        # launches a step (the up and the dn form), and 12d's factored and
        # flat t-J FTLM at R = 16
        ("factor_matmul (estimators, batched up form R=16)",
         "estimators: FTLM recurrence", "f64 batched up form (16*3432)",
         est_runs["12a ed --ftlm 14-site"]["factor_matmul"] // 2),
        ("factor_matmul (estimators, batched dn form R=16)",
         "estimators: FTLM recurrence", "f64 batched dn form R=16",
         est_runs["12a ed --ftlm 14-site"]["factor_matmul"] // 2),
        ("ell_spmv (estimators, batched R=16)", "estimators: flat t-J FTLM",
         "f64 18-site t-J ELL, R=16",
         est_runs["12d the flat form's FTLM"]["ell_spmv"]),
        ("perm_gather (estimators, cross terms R=16)",
         "estimators: factored t-J FTLM",
         "f64 18-site t-J largest PermCrossTerm, R=16",
         est_runs["12d ed --ftlm factored 18-site t-J"]["perm_gather"]),
        # float32 and complex64 solves with their refinement, the bf16
        # forms (phase 14), by the form each launch took
        ("factor_matmul (float32 solves)", "float32 solves",
         "f32 3432x3432.3432x3432^T", low_forms.get("factor_matmul f32", 0)),
        ("factor_matmul (bf16 factors, float32 out)",
         "bf16 factors under a float32 state: 14e's Kitaev ring, 14h's chain",
         "bf16 22-site Kitaev left half",
         low_forms.get("factor_matmul bf16_f32", 0)),
        ("factor_matmul (bf16 factors, float64 out)",
         "bf16 factors under a float64 state: 14h's chain",
         "bf16->f64 3432^3", low_forms.get("factor_matmul bf16_f64", 0)),
        ("ell_spmv (float32)", "float32 solves",
         "f32 12-site SuperHubbardExtended J-ELL, R=1",
         low_forms.get("ell_spmv f32", 0)),
        ("perm_gather (float32)", "float32 solves: factored t-J",
         "f32 18-site t-J largest PermCrossTerm",
         low_forms.get("perm_gather f32", 0)),
        ("perm_gather (complex64)", "complex64 solves: factored Rashba",
         "c64 12-site Rashba half-cut largest PermCrossTerm",
         low_forms.get("perm_gather c64", 0)),
        ("perm_gather (bf16 source, float32 sums)", "bf16cross in float32",
         "bf16->f32 13-site Rashba half-cut largest PermCrossTerm",
         low_forms.get("perm_gather bf16_f32", 0)),
        ("perm_gather (bf16 source, float64 sums)", "bf16cross in float64",
         "bf16->f64 13-site Rashba half-cut largest PermCrossTerm",
         low_forms.get("perm_gather bf16_f64", 0)),
        # float32 and complex64 on the fleets, the estimators and the
        # symmetry sectors (phase 15): a batched apply of the 14-site
        # fleet is one launch of each factor_matmul form, of the 12-site
        # fleet one ell_spmv launch
        ("factor_matmul (float32 fleets, batched up form)",
         "float32 spectral fleets (15a)", "f32 batched up form (14*3432)",
         fleets),
        ("factor_matmul (float32 fleets, batched dn form)",
         "float32 spectral fleets (15a)", "f32 batched dn form R=14", fleets),
        ("factor_matmul (float32 FTLM, batched up form R=16)",
         "float32 FTLM recurrence (15c)", "f32 batched up form (16*3432)",
         f32_runs["15c 14-site ftlm R=16 f32"]["factor_matmul f32"] // 2),
        ("factor_matmul (float32 FTLM, batched dn form R=16)",
         "float32 FTLM recurrence (15c)", "f32 batched dn form R=16",
         f32_runs["15c 14-site ftlm R=16 f32"]["factor_matmul f32"] // 2),
        ("ell_spmv (float32 fleet, batched R=23)",
         "float32 TSPCenter fleet (15b)",
         "f32 J-ELL of the 12-site N_up = 7 sector, R=23",
         f32_batched["15b 12-site SuperHubbardExtended TSPCenter fleet"]),
        ("ell_spmv (complex64 momentum blocks)",
         "float32 symmetry: translation blocks (15d)",
         "c64 14-site momentum block R=1",
         f32_runs["15d 14-site U=4 chain, translation"]["ell_spmv c64"]),
        ("ell_spmv (float32 parity blocks)",
         "float32 symmetry: reflection blocks (15d)",
         "f32 14-site parity block R=1",
         f32_runs["15d 14-site open (4, 4) chain, reflection"][
             "ell_spmv f32"]),
        ("factor_matmul (float32 projected Kitaev)",
         "float32 projection (15d)", "f32 22-site Kitaev left half",
         f32_runs["15d 22-site Kitaev ring, projected translation"][
             "factor_matmul f32"]),
        # distribution (phase 16): a row shard's ell_spmv with the gathered
        # state as its source, over every sharded ELL apply of the phase
        ("ell_spmv (row shard, longer source)",
         "distribution: flat, halo and remainder row shards (16)",
         "f64 12-site SuperHubbardExtended flat row shard, rank 0 of 4",
         sum(n for form, n in dist16["forms"].items()
             if form.split(" ")[0] == "ell_spmv")))
    kernels_line = []
    for name, path_name, case_start, count in entries:
        kernel = name.split(" ")[0]
        path_case, = [r for r in results[kernel]
                      if re.match(re.escape(case_start) + r"(\D|$)",
                                  r["case"])]
        check(count > 0, f"{name}: no launch on its path")
        src, replaces = sources[kernel]
        kernels_line.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            path=path_name, launches=count,
            **{key: path_case[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "share_of_bound", "case",
                "nonzero_bound_ms", "share_of_nonzero_bound",
                "padded_bound_ms", "sliced_bytes", "slice_s")
                if key in path_case}))
        if name == kernel:  # every case of the kernel, once
            kernels_line[-1].update(
                launches_ground_state_path=launches[kernel],
                launches_spectral_path=spectral_launches[kernel],
                launches_flat_models=flat_count(kernel, ""),
                launches_phase_10=sum(
                    run["counts"][kernel] for run in factored_runs.values()),
                launches_phase_11=sum(counts[kernel]
                                      for _, counts in sym_runs.values()),
                launches_phase_12=sum(counts[kernel]
                                      for counts in est_runs.values()),
                launches_phase_13=sum(counts[kernel]
                                      for counts in cli_runs.values()),
                launches_phase_14=sum(n for form, n in low_forms.items()
                                      if form.split(" ")[0] == kernel),
                launches_phase_15={form: n for form, n in f32_forms.items()
                                   if form.split(" ")[0] == kernel},
                launches_phase_16={form: n for form, n
                                   in dist16["forms"].items()
                                   if form.split(" ")[0] == kernel},
                cases=results[kernel])
        if kernel == "perm_gather":
            kernels_line[-1].update(
                design="(b, r) pairs a thread, their sums in registers; a "
                       "column's tables read once for them")
        if name == "perm_gather":
            kernels_line[-1].update(cross_term_cases=cross)
        if name.startswith("ell_spmv (row shard"):
            kernels_line[-1].update(
                ms_4_processes_sharing_one_card=dist16["shard_ell_ms"])
    say(f"phases 1-16 done at {time.perf_counter() - started:.1f} s")
    print(json.dumps({"native": native_line}))
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)  # checked == 1


if __name__ == "__main__":
    main()
