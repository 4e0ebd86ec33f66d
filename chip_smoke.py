#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lanczosplusplus_tpu_torch) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one line with its numbers:

1. environment: the card, its power limit, torch and CUDA versions;
2. build: both hand-written CUDA kernels compiled from csrc/;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (TF32 off): factor_matmul at 3432^3 in float64 and
   float32, its transposed accumulate form, a ragged 300x257 . 123x257;
   ell_spmv on the 12-site SuperHubbardExtended J-ELL and on a random
   ELL with dim 1 000 003, K 7;
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


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
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
    build.load_library()
    regs = re.findall(r"Used (\d+) registers", build.build_log())
    say(f"phase 2 build: {time.perf_counter() - t0:.3f} s, {lib.name}, "
        f"registers per kernel {regs}")

    # -- 3. kernels against their plain versions ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("phase 3 kernels: torch.backends.cuda.matmul.allow_tf32 = False")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"factor_matmul": [], "ell_spmv": []}

    def record(kernel, case, got, ref, tol, ms, plain_ms):
        abs_err, rel = rel_err(got, ref)
        say(f"  {kernel} {case}: max rel err {rel:.3e} (tol {tol:g}), "
            f"max abs err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        check(rel <= tol, f"{kernel} {case}: rel err {rel:.3e} > {tol:g}")
        results[kernel].append(dict(case=case, max_abs_err=abs_err,
                                    max_rel_err=rel, ms=ms,
                                    plain_ms=plain_ms))

    for dt, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        tag = "f64" if dt == torch.float64 else "f32"
        for m, n, k in ((3432, 3432, 3432), (300, 123, 257)):
            x = torch.randn(m, k, generator=gen, device=dev, dtype=dt)
            a = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
            got = K.factor_matmul(x, a)
            ref = K.factor_matmul_ref(x, a)
            torch.cuda.synchronize()
            reps = 20 if m > 1000 else 100
            record("factor_matmul", f"{tag} {m}x{k}.{n}x{k}^T", got, ref,
                   tol, median_ms(lambda: K.factor_matmul(x, a), reps),
                   median_ms(lambda: K.factor_matmul_ref(x, a), reps))
            if m != 3432:
                continue
            # the dn-factor form of the path: Y += A . X on transposed views
            y0 = torch.randn(m, m, generator=gen, device=dev, dtype=dt)
            got = y0.clone()
            K.factor_matmul(x.T, a, out=got.T, accumulate=True)
            ref = y0 + a @ x
            torch.cuda.synchronize()
            y1 = y0.clone()
            record("factor_matmul", f"{tag} Y+=A.X transposed views", got,
                   ref, tol,
                   median_ms(lambda: K.factor_matmul(
                       x.T, a, out=y1.T, accumulate=True), reps),
                   median_ms(lambda: y1.T.add_(
                       K.factor_matmul_ref(x.T, a)), reps))
            del x, a, y0, y1, got, ref

    she_text = super_hubbard_text(12)
    she_inp = parse_input(she_text)
    she_model = build_model(she_inp, Geometry(she_inp))
    she_basis = she_model.create_basis(she_model.default_parts(she_inp))
    she_ham = she_model.hamiltonian(she_basis, dtype=torch.float64,
                                    device=dev)
    ell_cases = [("f64 12-site SuperHubbardExtended J-ELL", she_ham.diag,
                  she_ham.ell.cols, she_ham.ell.vals, TOL_ELL_F64)]
    for dt, tol in ((torch.float64, TOL_ELL_F64), (torch.float32, TOL_F32)):
        dim, kk = 1_000_003, 7
        ell_cases.append((
            f"{'f64' if dt == torch.float64 else 'f32'} random dim {dim} "
            f"K {kk}",
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
        record("ell_spmv", case, got, ref, tol,
               median_ms(lambda: K.ell_spmv(diag, cols, vals, x), 100),
               median_ms(lambda: K.ell_spmv_ref(diag, cols, vals, x), 100))
    del ell_cases, she_ham

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
            launches=launches[name], max_abs_err=path_case["max_abs_err"],
            ms=path_case["ms"], plain_ms=path_case["plain_ms"],
            case=path_case["case"], cases=results[name]))
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)  # checked == 1


if __name__ == "__main__":
    main()
