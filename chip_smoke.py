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
   pitch takes the 8-byte copies; ell_spmv on the 12-site
   SuperHubbardExtended J-ELL in the K-major layout the path runs and in
   the contiguous (dim, K) layout, and on a random ELL with dim
   1 000 003, K 7.  Each case is timed beside its bound (the least time
   the card could take: operations over 67 TFLOP/s or bytes over 3.35
   TB/s) and, for factor_matmul, beside the library call for the same
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
   from the same start vector, and the 14-site matvec timed both ways.

Every check raises on failure, so the exit code is non-zero.  Without a
card, or without the package beside this script, it exits non-zero and
prints no result.  The last lines are a JSON object with the kernels'
numbers, the card's name and power limit, and the result object.
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
    versions of the two kernels: the reference the kernel path is held
    against on the card."""

    def __init__(self, ham):
        self.ham = ham
        self.dim, self.dtype, self.device = ham.dim, ham.dtype, ham.device

    def matvec(self, x):
        from lanczosplusplus_tpu_torch.ops import kernels as K
        h, f = self.ham, self.ham.factorized
        if h.ell is not None:
            y = K.ell_spmv_ref(h.diag, h.ell.cols, h.ell.vals, x)
        else:
            y = h.diag * x
        x2, y2 = x.view(h.spin_shape), y.view(h.spin_shape)
        y2 += K.factor_matmul_ref(x2, f.up_dense)
        y2 += K.factor_matmul_ref(x2.T, f.dn_dense).T
        return y


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
        reps = 20 if bound_ms > 0.2 else 100
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

    she_text = super_hubbard_text(12)
    she_inp = parse_input(she_text)
    she_model = build_model(she_inp, Geometry(she_inp))
    she_basis = she_model.create_basis(she_model.default_parts(she_inp))
    she_ham = she_model.hamiltonian(she_basis, dtype=torch.float64,
                                    device=dev)
    jc, jv = she_ham.ell.cols, she_ham.ell.vals
    check(jc.stride() == (1, jc.shape[0]) and jv.stride() == jc.stride(),
          f"the model's J-ELL is not K-major: strides {jc.stride()}")
    ell_cases = [("f64 12-site SuperHubbardExtended J-ELL, K-major",
                  she_ham.diag, jc, jv, TOL_ELL_F64),
                 ("f64 12-site SuperHubbardExtended J-ELL, contiguous",
                  she_ham.diag, jc.contiguous(), jv.contiguous(),
                  TOL_ELL_F64)]
    for dt, tol in ((torch.float64, TOL_ELL_F64), (torch.float32, TOL_F32)):
        dim, kk = 1_000_003, 7
        ell_cases.append((
            f"{'f64' if dt == torch.float64 else 'f32'} random dim {dim} "
            f"K {kk}, contiguous",
            torch.randn(dim, generator=gen, device=dev, dtype=dt),
            torch.randint(0, dim, (dim, kk), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randn(dim, kk, generator=gen, device=dev, dtype=dt), tol))
    for case, diag, cols, vals, tol in ell_cases:
        x = torch.randn(diag.shape[0], generator=gen, device=dev,
                        dtype=diag.dtype)
        got = K.ell_spmv(diag, cols, vals, x)
        ref = K.ell_spmv_ref(diag, cols, vals, x)
        torch.cuda.synchronize()
        # per row: K indices and K values, diag and x read, y written
        row_bytes = cols.shape[1] * (4 + x.element_size()) \
            + 3 * x.element_size()
        record("ell_spmv", case, got, ref, tol,
               (lambda: K.ell_spmv(diag, cols, vals, x),
                lambda: K.ell_spmv_ref(diag, cols, vals, x), None),
               1e3 * row_bytes * diag.shape[0] / PEAK_BYTES, "bytes")
    del ell_cases, she_ham, jc, jv

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

    sources = {"factor_matmul": ("lanczosplusplus_tpu_torch/csrc/"
                                 "factor_matmul.cu",
                                 "lanczosplusplus_tpu/ops/pallas_kernels.py:47"),
               "ell_spmv": ("lanczosplusplus_tpu_torch/csrc/ell_spmv.cu",
                            "lanczosplusplus_tpu/ops/pallas_kernels.py:102")}
    kernels_line = []
    for name, (src, replaces) in sources.items():
        path_case = results[name][0]  # float64 at the main path's shape
        kernels_line.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            **{key: path_case[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "share_of_bound", "case")},
            cases=results[name]))
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)  # checked == 1


if __name__ == "__main__":
    main()
