#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lanczosplusplus_tpu_torch) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one line with its numbers:

1. environment: the card, its power limit, torch and CUDA versions;
2. build: both hand-written CUDA kernels compiled from csrc/, with each
   kernel's registers, shared memory and spills (which must be 0) and the
   count of FP64 tensor-core instructions (DMMA) in the machine code;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (TF32 off): factor_matmul at 3432^3 (14 sites) and
   924^3 (12 sites) in float64, each also in its transposed accumulate
   form, at 3432^3 in float32, and a ragged 300x257 . 123x257 whose odd
   pitch takes the 8-byte copies; the batched forms of the spectral
   path, a block of 14 states of the 14-site N_up = 8 sector (3432 x 3003
   each) and a block of 23 of the 12-site N_up = 7 sector (924 x 792
   each, the TSPCenter fleet's): the up product with the batch folded
   into its rows and the dn product over the transposed views in one
   launch, and a ragged batch of 3; ell_spmv on the 12-site
   SuperHubbardExtended J-ELL for one vector and for a block of 14, on
   the N_up = 7 sector's J-ELL for the fleet's block of 23, and on a
   random ELL with dim 1 000 003, K 7, for one vector and a block of 14.
   A batch of one must give the unbatched result bit for bit.  Each case
   is timed beside its bound (the least time the card could take:
   operations over 67 TFLOP/s or bytes over 3.35 TB/s) and, for
   factor_matmul, beside the library call for the same
   product (torch.matmul / addmm_, in the turns library, kernel, kernel,
   library), which the port itself never calls.  The times are the card's
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
   against the CPU.

Every check raises on failure, so the exit code is non-zero.  Without a
card, or without the package beside this script, it exits non-zero and
prints no result.  The last lines are a JSON object with the kernels'
numbers (one entry for each kernel and form of a path, with the launches
that path counted), the card's name and power limit, and the result
object.
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

import numpy as np
import torch

SEED = 7239443
TOL_F64 = 1e-12       # factor_matmul float64, relative to max|y|
TOL_F32 = 1e-5        # float32 kernels, relative to max|y|
TOL_ELL_F64 = 1e-13   # ell_spmv float64, relative to max|y|
TOL_E0 = 1e-10        # relative energy agreement
PEAK_FLOPS = 67e12    # H100 SXM data sheet: FP64 tensor cores, and float32
PEAK_BYTES = 3.35e12  # H100 SXM data sheet: device memory bytes per second
SPIN_CYCLES = 2_000_000  # about 1.1 ms at the H100's 1.75 GHz
E0_INPUT0 = -4.472135954999581  # benchmarks/goldens.json e0_input0

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


def hubbard_chain_text(nsite: int, u: float) -> str:
    """Half-filled periodic one-band Hubbard chain, t = -1."""
    return f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU {nsite} {" ".join([str(u)] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nsite // 2}
TargetElectronsDown={nsite // 2}
IsPeriodicX=1
"""


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


class PlainOperator:
    """A port Hamiltonian's tensors applied with the plain PyTorch
    versions of the two kernels, to one state or a batch-major block: the
    reference the kernel path is held against on the card."""

    def __init__(self, ham):
        self.ham = ham
        self.dim, self.dtype, self.device = ham.dim, ham.dtype, ham.device

    def matmat_t(self, xk):
        from lanczosplusplus_tpu_torch.ops import kernels as K
        h, f = self.ham, self.ham.factorized
        if h.ell is not None:
            y = K.ell_spmv_ref(h.diag, h.ell.cols, h.ell.vals, xk)
        else:
            y = h.diag * xk
        shape = (*xk.shape[:-1], *h.spin_shape)
        x3, y3 = xk.view(shape), y.view(shape)
        y3 += K.factor_matmul_ref(x3, f.up_dense)
        y3 += K.factor_matmul_ref(x3.transpose(-1, -2),
                                  f.dn_dense).transpose(-1, -2)
        return y

    matvec = matmat_t


class CheckedOperator(PlainOperator):
    """Applies through the kernels and, to the same block, through the
    plain versions, keeps the worst difference (of max |y|) and hands on
    the kernels' result: every apply of a recurrence is held at the very
    inputs the recurrence gives the kernels."""

    worst = 0.0

    def matmat_t(self, xk):
        y = self.ham.matmat_t(xk)
        self.worst = max(self.worst,
                         rel_err(y, PlainOperator.matmat_t(self, xk))[1])
        return y


def spectral_density(coll, omegas, delta):
    """-Im G(omega + i delta) / pi of a continued-fraction collection."""
    return -coll.evaluate(omegas, delta).imag / np.pi


def recurrence_both_ways(lz, K, ham, v0s, steps):
    """tridiagonalize_plain_batched from the rows of `v0s`, in the turns
    plain, kernel, kernel, plain, and then 20 steps with every apply done
    both ways on the same block: (results through the kernels, results
    through the plain versions, wall seconds by path, worst difference of
    one apply of max |y|).  A plain turn must launch no kernel, a kernel
    turn one batched launch a step of each factor_matmul form and, where
    the operator has an ELL part, of ell_spmv."""
    results, walls = {}, {"kernel": [], "plain": []}
    both = CheckedOperator(ham)
    for label in ("plain", "kernel", "kernel", "plain", "both"):
        op = {"kernel": ham, "plain": PlainOperator(ham), "both": both}[label]
        count = steps if label != "both" else min(steps, 20)
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[label] = lz.tridiagonalize_plain_batched(op, v0s, count)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append(time.perf_counter() - t)
        went = {n: K.LAUNCHES[n] - before[n] for n in before}
        expect = {"factor_matmul": 2 * count,
                  "ell_spmv": count if ham.ell is not None else 0}
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
                engine = lanczos_main.run(["-f", path, "-p", "17",
                                           "--device", "cuda", *args])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            combs = []
            while os.path.exists(f"input.inp{len(combs)}.comb"):
                combs.append(read_collection(f"input.inp{len(combs)}.comb"))
        finally:
            os.chdir(cwd)
    return engine, out.getvalue(), err.getvalue(), combs, wall


def phase_seconds(stderr_text, label):
    """Seconds of the Engine's timed phases whose line holds `label`."""
    return [float(x) for x in re.findall(
        rf"{re.escape(label)}.* done in ([0-9.]+)s", stderr_text)]


def main() -> None:
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
    for r in build.kernel_resources(build.build_log()):
        # template arguments of a float64 factor_matmul instantiation:
        # BM, BN, X k-major, A k-major
        found = re.search(r"dmma_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)",
                          r["name"])
        if found:
            bm, bn, xk, ak = map(int, found.groups())
            bits = K.MatmulPlan(bool(xk), False, bool(ak), False, False,
                                bm).bits
            label = (f"factor_matmul f64 {bm}x{bn} tile, X "
                     f"{'k' if xk else 'row'}-major, A "
                     f"{'k' if ak else 'row'}-major, dynamic smem "
                     f"{lib_c.lpp_factor_matmul_f64_smem_bytes(bits)} B")
        else:
            kind = re.search(r"(factor_matmul_simt|ell_spmv)_kernelI(\w)"
                             r"(?:Li(\d+)E)?", r["name"])
            label = (f"{kind.group(1)} "
                     f"{'f64' if kind.group(2) == 'd' else 'f32'}"
                     + (f", {kind.group(3)} entries at a time"
                        if kind.group(3) else "")
                     + f", static smem {r['static_smem_bytes']} B")
        say(f"  {label}: {r['registers']} registers, spill stores "
            f"{r['spill_store_bytes']} B, loads {r['spill_load_bytes']} B")
        check(r["spill_store_bytes"] == 0 and r["spill_load_bytes"] == 0,
              f"{r['name']} spills registers")
    dmma = build.sass_opcode_counts(lib, "DMMA")
    say(f"  DMMA instructions in the library's machine code: {dmma} "
        f"(None: no cuobjdump)")
    check(dmma is None or sum(dmma.values()) > 0,
          "the float64 factor_matmul holds no DMMA instruction")

    # -- 3. kernels against their plain versions ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("phase 3 kernels: torch.backends.cuda.matmul.allow_tf32 = False")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"factor_matmul": [], "ell_spmv": []}

    def record(kernel, case, got, ref, tol, times, bound_ms, bound_by):
        """`times`: kernel, plain and (or None) library callables."""
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
            f"{bound_ms:.4f} ms by {bound_by} (share {bound_ms / ms:.3f}), "
            f"library "
            + ("none" if library_ms is None else
               f"{library_ms:.4f} ms (turns {turns['library'][0]:.4f}, "
               f"{turns['library'][1]:.4f})")
            + f", plain {plain_ms:.4f} ms, kernel from an idle card "
              f"{from_idle_ms:.4f} ms")
        results[kernel].append(dict(
            case=case, max_abs_err=abs_err, max_rel_err=rel, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, library_ms=library_ms,
            from_idle_ms=from_idle_ms))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt, tol, shapes in (
            (torch.float64, TOL_F64, ((3432, 3432, 3432), (924, 924, 924),
                                      (300, 123, 257))),
            (torch.float32, TOL_F32, ((3432, 3432, 3432), (300, 123, 257)))):
        tag = "f64" if dt == torch.float64 else "f32"
        for m, n, k in shapes:
            x = torch.randn(m, k, generator=gen, device=dev, dtype=dt)
            a = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
            bound_ms = 1e3 * 2 * m * n * k / PEAK_FLOPS
            out = torch.empty(m, n, device=dev, dtype=dt)
            plan = K.factor_matmul_plan(
                x.data_ptr(), x.stride(), a.data_ptr(), a.stride(),
                out.data_ptr(), out.stride(), m, n, sms)
            path = "SIMT"
            if dt == torch.float64:
                wide = plan.x_vec16 and plan.a_vec16
                path = f"{plan.tile}-tile, {16 if wide else 8}-byte copies"
                check(wide == (k % 2 == 0),
                      f"{m}x{k}: 16-byte copies planned: {wide}")
            got = K.factor_matmul(x, a)
            ref = K.factor_matmul_ref(x, a)
            torch.cuda.synchronize()
            record("factor_matmul", f"{tag} {m}x{k}.{n}x{k}^T ({path})", got,
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
            record("factor_matmul",
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
        wide = szu % 2 == 0
        copies = "16-byte copies" if wide else "8-byte copies: odd pitch"
        xb = torch.randn(rows, szd, szu, generator=gen, device=dev,
                         dtype=torch.float64)
        yb = torch.randn(rows, szd, szu, generator=gen, device=dev,
                         dtype=torch.float64)
        a_up = torch.randn(szu, szu, generator=gen, device=dev,
                           dtype=torch.float64)
        a_dn = torch.randn(szd, szd, generator=gen, device=dev,
                           dtype=torch.float64)
        xf, yf = xb.view(rows * szd, szu), yb.view(rows * szd, szu)
        plan = K.factor_matmul_plan(
            xf.data_ptr(), xf.stride(), a_up.data_ptr(), a_up.stride(),
            yf.data_ptr(), yf.stride(), rows * szd, szu, sms)
        check(plan.tile == 128 and plan.x_vec16 == plan.a_vec16 == wide,
              f"up form of the batch: plan {plan}")
        got = K.factor_matmul(xf, a_up)
        ref = K.factor_matmul_ref(xf, a_up)
        torch.cuda.synchronize()
        out = torch.empty_like(xf)
        record("factor_matmul",
               f"f64 batched up form ({rows}*{szd})x{szu}.{szu}x{szu}^T, "
               f"batch folded into the rows (128-tile, {copies})",
               got, ref, TOL_F64,
               (lambda: K.factor_matmul(xf, a_up, out=out),
                lambda: K.factor_matmul_ref(xf, a_up),
                lambda: torch.matmul(xf, a_up.T, out=out)),
               1e3 * 2 * rows * szd * szu * szu / PEAK_FLOPS, "operations")
        del got, ref, out
        xt, yt = xb.transpose(1, 2), yb.transpose(1, 2)
        plan = K.factor_matmul_plan(
            xt.data_ptr(), xt.stride(), a_dn.data_ptr(), a_dn.stride(),
            yt.data_ptr(), yt.stride(), szu, szd, sms, rows)
        check(plan.tile == 128 and not plan.x_kmajor
              and plan.x_vec16 == wide and plan.a_vec16,
              f"dn form of the batch: plan {plan}")
        got = yb.clone()
        K.factor_matmul(xt, a_dn, out=got.transpose(1, 2), accumulate=True)
        ref = yb + torch.matmul(a_dn, xb)
        torch.cuda.synchronize()
        y1 = yb.clone()
        record("factor_matmul",
               f"f64 batched dn form R={rows}: Y[b]+=A.X[b], {szd}^2 factor "
               f"on ({szu}x{szd})^T views, one launch (128-tile, X {copies})",
               got, ref, TOL_F64,
               (lambda: K.factor_matmul(xt, a_dn, out=y1.transpose(1, 2),
                                        accumulate=True),
                lambda: y1.transpose(1, 2).add_(
                    K.factor_matmul_ref(xt, a_dn)),
                lambda: y1.baddbmm_(a_dn.expand(rows, szd, szd), xb)),
               1e3 * 2 * rows * szd * szd * szu / PEAK_FLOPS, "operations")
        del got, ref, y1, xb, yb, xf, yf, xt, yt, a_up, a_dn
    xr = torch.randn(3, 300, 257, generator=gen, device=dev,
                     dtype=torch.float64)
    ar = torch.randn(123, 257, generator=gen, device=dev, dtype=torch.float64)
    got = K.factor_matmul(xr, ar)
    ref = K.factor_matmul_ref(xr, ar)
    torch.cuda.synchronize()
    out = torch.empty_like(got)
    record("factor_matmul", "f64 ragged batch R=3 of 300x257.123x257^T "
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
    dim, kk = 1_000_003, 7
    for dt, tol, shape in ((torch.float64, TOL_ELL_F64, (dim,)),
                           (torch.float32, TOL_F32, (dim,)),
                           (torch.float64, TOL_ELL_F64, (14, dim))):
        ell_cases.append((
            f"{'f64' if dt == torch.float64 else 'f32'} random dim {dim} "
            f"K {kk}" + (f", R={shape[0]}" if len(shape) == 2 else ""),
            torch.randn(dim, generator=gen, device=dev, dtype=dt),
            torch.randint(0, dim, (dim, kk), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randn(dim, kk, generator=gen, device=dev, dtype=dt),
            shape, tol))
    for case, diag, cols, vals, shape, tol in ell_cases:
        x = torch.randn(shape, generator=gen, device=dev, dtype=diag.dtype)
        got = K.ell_spmv(diag, cols, vals, x)
        ref = K.ell_spmv_ref(diag, cols, vals, x)
        torch.cuda.synchronize()
        if len(shape) == 2:
            check(torch.equal(K.ell_spmv(diag, cols, vals, x[:1])[0],
                              K.ell_spmv(diag, cols, vals, x[0])),
                  "ell_spmv: a batch of one differs from the 1-D call")
            # an even member, an odd one and the last
            for b in (2, 3, shape[0] - 1):
                check(torch.equal(got[b],
                                  K.ell_spmv(diag, cols, vals, x[b])),
                      f"ell_spmv: row {b} of the batch differs from its 1-D "
                      f"call")
        # per row: K indices and K values and diag read once; per batch
        # member x read and y written
        size = x.element_size()
        row_bytes = cols.shape[1] * (4 + size) + size \
            + 2 * size * (shape[0] if len(shape) == 2 else 1)
        record("ell_spmv", case, got, ref, tol,
               (lambda: K.ell_spmv(diag, cols, vals, x),
                lambda: K.ell_spmv_ref(diag, cols, vals, x), None),
               1e3 * row_bytes * diag.shape[0] / PEAK_BYTES, "bytes")
    say("  ell_spmv: a batch of one, and rows of every batch, equal the 1-D "
        "call bit for bit")
    del ell_cases, she_ham, fleet_ham, jc, jv

    # -- 4-6. the main path through the kernels ---------------------------
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
    check(K.LAUNCHES["factor_matmul"] > 0, "factor_matmul never launched")

    v0_she = lz.random_start_vector(she_basis.size, SEED, torch.float64,
                                    dev)
    eng_she, wall_she, mv_she = solve(she_text, v0=v0_she)
    say(f"phase 6 12-site SuperHubbardExtended: dim {eng_she.basis.size}, "
        f"J bonds {eng_she.hamiltonian.ell.cols.shape[1]}, steps "
        f"{eng_she.solve_info.steps}, matvecs {mv_she}, E0 "
        f"{eng_she.ground_energy!r}, wall {wall_she:.3f} s")
    check(eng_she.solve_info.converged, "SuperHubbardExtended unconverged")

    launches = dict(K.LAUNCHES)
    say(f"main path kernel launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    # -- 7. the same solves with the plain versions ------------------------
    for label, eng, v0 in (("14-site U=4", eng_u4, v0_u4),
                           ("12-site SuperHubbardExtended", eng_she,
                            v0_she)):
        t = time.perf_counter()
        evals, _ = lz.lowest_states(PlainOperator(eng.hamiltonian),
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
    plain = PlainOperator(ham14)
    mv_plain_ms = median_ms(lambda: plain.matvec(x), 10)
    say(f"phase 7 14-site matvec: kernels {mv_ms:.4f} ms, plain versions "
        f"{mv_plain_ms:.4f} ms")

    # -- 8. the spectral slice through the CLI ---------------------------
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
        check(counts == {"factor_matmul": expect, "ell_spmv": 0},
              f"U={u} DOS launches {counts}, predicted factor_matmul "
              f"{expect}, ell_spmv 0")
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
            f"step (turns plain, kernel, kernel, plain); kernel against "
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
    eng8, out8, err8, combs, wall = run_cli(
        lanczos_main, she_text + f"TSPCenter=0\nSpectralSteps={steps_she}\n",
        ["-g", "c"])
    counts = dict(K.LAUNCHES)
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
              "ell_spmv": mv_she + 2 * steps_she}
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
            f"per step (turns plain, kernel, kernel, plain); kernel against "
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
    for name, count in spectral_launches.items():
        check(count > 0, f"{name} was not launched on the spectral path")

    sources = {"factor_matmul": ("lanczosplusplus_tpu_torch/csrc/"
                                 "factor_matmul.cu",
                                 "lanczosplusplus_tpu/ops/pallas_kernels.py:47"),
               "ell_spmv": ("lanczosplusplus_tpu_torch/csrc/ell_spmv.cu",
                            "lanczosplusplus_tpu/ops/pallas_kernels.py:102")}
    # One entry for each kernel and form of a path.  The counts of the
    # spectral runs were checked against the code's prediction above, so
    # their batched share is known: two DOS runs and the fleet, two sectors
    # each, one launch a step of the up form, the dn form and (the fleet's)
    # ell_spmv; the rest of those runs' launches are their ground states'
    # and the serial spectral_function's, at the ground-state path's shapes.
    batched = {"factor_matmul": 2 * (2 * 2 * steps8 + 2 * steps_she),
               "ell_spmv": 2 * steps_she}
    unbatched = "ground state, and the unbatched launches of the spectral runs"
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
         batched["ell_spmv"]))
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
                "library_ms", "share_of_bound", "case")}))
        if name == kernel:  # every case of the kernel, once
            kernels_line[-1].update(
                launches_ground_state_path=launches[kernel],
                launches_spectral_path=spectral_launches[kernel],
                cases=results[kernel])
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)  # checked == 1


if __name__ == "__main__":
    main()
