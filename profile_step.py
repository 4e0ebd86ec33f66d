#!/usr/bin/env python3
"""Where a Lanczos step of the port's 14-site Hubbard sector, or of one of
its flat models, spends its time on one GPU.

Run from the repository root, with one CUDA card:

    python3 profile_step.py [--spectral | --ftlm | --flat MODEL | --gather |
                             --sym] [--trace-dir DIR]

It builds the half-filled 14-site periodic HubbardOneBand chain at U=4
(dim 11 778 624, two dense 3432 x 3432 float64 one-spin factors) on the
card, then traces 40 selective-reorthogonalization Lanczos steps
(``solver.lanczos.tridiagonalize``) with ``torch.profiler``, once through
the hand-written kernels and once through their plain PyTorch versions
(``chip_smoke.PlainForm``), in the turns plain, kernel, kernel, plain.
Each turn runs 5 untraced warm-up steps first.

With ``--spectral`` it traces the batched step of the spectral path
instead: the N_up = 8, N_down = 7 sector of the same chain (dim
10 306 296, factors 3003 x 3003 and 3432 x 3432), a block of 14 random unit
rows, 10 steps of ``solver.lanczos.tridiagonalize_plain_batched`` after 2
warm-up steps, in the same turns.

With ``--ftlm`` it traces the batched recurrence of the FTLM estimator
instead, as ``chip_smoke.py`` phase 12a runs it (``ed --ftlm``): the same
14-site sector, a block of 16 random unit rows drawn on the card
(``random_start_block``, the ed schedule's seed), 10 steps of
``engine.ftlm._ftlm_recurrence`` after 2 warm-up steps, in the same turns.

With ``--flat MODEL`` it traces the ground-state step of a flat model at
full width instead, built as ``chip_smoke.py`` phase 9 builds it:
``heisenberg24`` (24-site ring, dim 2 704 156, ELL K = 48), ``tj18``
(18-site t-J ring, 8 up 8 down, dim 1 969 110, K = 54), ``rashba12`` and
``rashba13`` (Rashba rings at one electron a site in complex128, dim
2 704 156 with K = 96 and dim 10 400 600 with K = 104) and ``feas8`` (the
8-site two-orbital FeAs sector, dim 3 312 400, two 1820 x 1820 factors and
an ELL of K = 16).  The host's build of the arrays is timed apart.  Where
the plain version's gather intermediates (four times the ELL's values)
would not fit the card's free memory, only the kernel turns run.  The
names ending in ``f`` trace the factored form that SolverOptions=factored
solves instead (``chip_smoke.py`` phase 10), in its inner block order:
``tj18f`` and ``rashba13f`` (half-cut block-Kronecker forms: within-block
and tier products through ``factor_matmul``, the cut-crossing terms one
``perm_gather`` each), ``heis24f`` (half-cut Sz blocks) and ``kitaev24f``
(the 24-site Kitaev ring of bench.py, dim 16 777 216, two 4096-wide
halves); their plain turns run the same form through the kernels' plain
versions, and the launches of one matvec are printed.

With ``--gather`` it times the ``perm_gather`` cases of ``chip_smoke.py``
phase 10 and nothing else, through ``chip_smoke.perm_gather_case`` (each
case bit-equal to the plain version, then kernel, cuSPARSE ``csr @ x``,
plain version and bound): the 14-site one-spin up and dn forms at R = 1
and R = 14, and the largest PermCrossTerm of the 18-site t-J, 13-site
Rashba, 8-site FeAs and 7-site FeAs spin-orbit factored forms.  It takes about a minute of command time.

With ``--sym`` it runs the momentum-projected Kitaev path of bench.py's
symmetry section (bench.py:643-697) and nothing else: the 24-site Kitaev
ring (dim 16 777 216, 13 momentum sectors, two 4096-wide halves) built on
the card as the Engine builds it, its E0 without symmetry (plain two-pass
Lanczos, 160 steps), 160 plain steps of P_k H from each sector's projected
start vector, the winning sector solved again for its vector and purity,
and the times of one matvec of the factored form and of one projection
P_k.  It prints bench.py's ``sym_*`` fields.  Then the 22-site ring's
momentum sectors both ways in the same run, by projection and as orbit
blocks through ``ell_spmv`` (the CPU's route), each part timed.  It
takes about five minutes of command time.

For each turn it prints the host wall time of the traced steps (ending
in ``torch.cuda.synchronize()``), the device busy time and the device time
of the top kernels.  Device busy time is the length of the union of the
intervals of the trace's device events (kernels, copies, memsets), read
from ``export_chrome_trace``, so overlapping events count once; the idle
share is 1 - busy / wall.  The last line is one JSON object with every
turn's numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# --flat MODEL -> (function of chip_smoke.py that writes its input, arguments)
FLAT_MODELS = {"heisenberg24": ("heisenberg_ring_text", (24,)),
               "tj18": ("tj_ring_text", (18, 8, 8)),
               "rashba12": ("rashba_ring_text", (12, 12)),
               "rashba13": ("rashba_ring_text", (13, 13)),
               "feas8": ("feas_ring_text", (8, 4, 4)),
               # factored forms (SolverOptions=factored)
               "tj18f": ("tj_ring_text", (18, 8, 8)),
               "heis24f": ("heisenberg_ring_text", (24,)),
               "rashba13f": ("rashba_ring_text", (13, 13, "0.5", "none")),
               "kitaev24f": ("kitaev_ring_text", (24,))}
# --gather: the factored forms whose largest PermCrossTerm is timed, as
# chip_smoke.py phase 10 names them (label, function writing the input,
# its arguments)
GATHER_FORMS = (("18-site t-J", "tj_ring_text", (18, 8, 8)),
                ("13-site Rashba half-cut", "rashba_ring_text",
                 (13, 13, "0.5", "none")),
                ("8-site FeAs interaction", "feas_ring_text", (8, 4, 4)),
                ("7-site FeAs spin-orbit", "feas_spinorbit_chain_text",
                 (7, 4, 3)))
STEPS = 40
WARMUP_STEPS = 5
SPECTRAL_STEPS = 10
SPECTRAL_WARMUP_STEPS = 2
SPECTRAL_ROWS = 14
FTLM_ROWS = 16
FTLM_SEED = 982451653   # the seed of ftlm_schedule, chip_smoke.py phase 12a


def device_events(trace_path: str) -> list[dict]:
    """The device-side events (kernels, copies, memsets) of a chrome
    trace written by ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(events: list[dict]) -> float:
    """Length in microseconds of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def by_name_ms(events: list[dict], top: int) -> dict[str, float]:
    """Device milliseconds per event name, the `top` largest."""
    sums: dict[str, float] = {}
    for e in events:
        sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e3
    return dict(sorted(sums.items(), key=lambda kv: -kv[1])[:top])


def profile_turn(run, steps: int, warmup: int, trace_path: str) -> dict:
    """Trace ``run(steps)`` after an untraced ``run(warmup)``."""
    from torch.profiler import ProfilerActivity, profile

    run(warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    prof.export_chrome_trace(trace_path)
    events = device_events(trace_path)
    if not events:
        raise RuntimeError("the trace holds no device events")
    busy_ms = busy_us(events) / 1e3
    idle = 1.0 - busy_ms / wall_ms
    if not 0.0 <= idle <= 1.0:
        raise RuntimeError(f"idle share {idle} outside [0, 1]: busy "
                           f"{busy_ms} ms, wall {wall_ms} ms")
    return dict(steps=steps, wall_ms=wall_ms, ms_per_step=wall_ms / steps,
                device_busy_ms=busy_ms, idle_share=idle,
                device_events=len(events),
                top_device_ms=by_name_ms(events, 8))


def ftlm_recurrence(op, v0: torch.Tensor, steps: int):
    """`steps` of the FTLM estimator's batched recurrence from the rows of
    v0 (R, dim), with no operator dots: (alphas, betas, dots) on the
    device."""
    from lanczosplusplus_tpu_torch.engine.ftlm import _ftlm_recurrence
    return _ftlm_recurrence(op, v0, v0.new_zeros((0, *v0.shape)), steps)


def gather_cases(dev) -> list:
    """(case label, x, y0, tables) of every ``perm_gather`` case of
    ``--gather``, on random blocks from the script's seed."""
    import chip_smoke
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    inp = parse_input(chip_smoke.hubbard_chain_text(14, 4))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            dtype=torch.float64, device=dev)
    cases = list(chip_smoke.one_spin_gather_cases(
        gen, ham.densify_factors(max_bytes=0), "14-site"))
    for name, writer, numbers in GATHER_FORMS:
        t = time.perf_counter()
        form = factored_form(getattr(chip_smoke, writer)(*numbers), dev)
        case, src, dst, tables = chip_smoke.largest_cross_term(form, name)
        print(f"{name}: factored build {time.perf_counter() - t:.3f} s",
              flush=True)
        cases.append((case, torch.randn(src, generator=gen, device=dev,
                                        dtype=form.dtype),
                      torch.randn(dst, generator=gen, device=dev,
                                  dtype=form.dtype), tables))
        del form
    return cases


def gather_main(smi: str) -> None:
    """--gather: time perm_gather on phase 10's cases; the last line is
    one JSON object."""
    import chip_smoke

    dev = torch.device("cuda:0")
    results = {"perm_gather": []}
    for case, x, y0, tables in gather_cases(dev):
        amps = [t for t in (tables.get("a"), tables.get("beta"))
                if t is not None]
        live = [float((t != 0).double().mean()) for t in amps]
        print(f"{case}: share of nonzero amplitudes in the row and column "
              f"tables {live}", flush=True)
        chip_smoke.perm_gather_case(results, case, x, y0, tables)
    print(json.dumps({"card": smi, "gather": results["perm_gather"]}),
          flush=True)


def sym_main(smi: str) -> None:
    """--sym: bench.py's projected-translation section on the port, at its
    24-site size; the last line is one JSON object."""
    import chip_smoke
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    from lanczosplusplus_tpu_torch.symmetry.projected import (
        ProjectedTranslationSolver)

    dev = torch.device("cuda:0")
    nsite, steps_k = 24, 160
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ham = factored_form(chip_smoke.kitaev_ring_text(nsite), dev)
    proj = ProjectedTranslationSolver(ham, nsite)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"factored build: {build_s:.3f} s, dim {ham.dim}", flush=True)
    t0 = time.perf_counter()
    e_plain, _ = lz.lowest_states(ham, max_steps=steps_k,
                                  krylov_budget_bytes=7 << 30)
    print(f"E0 without symmetry {float(e_plain[0])!r}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    v = lz.random_start_vector(ham.dim, chip_smoke.SEED, ham.dtype, dev)
    pk = proj.projected(1)
    matvec_ms = chip_smoke.median_ms(lambda: ham.matvec(v), 5)
    project_ms = chip_smoke.median_ms(lambda: pk.project(v), 5)
    print(f"one matvec of the factored form {matvec_ms:.4f} ms, one "
          f"projection P_k ({nsite} weighted transposes) {project_ms:.4f} "
          f"ms", flush=True)
    e_ks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(proj.sectors()):
        res = lz.tridiagonalize_plain(proj.projected(s),
                                      proj.start_vector(s), steps_k)
        ev, _ = lz.tridiag_eigh(res.alphas, res.betas)
        e_ks.append(float(ev[0]))
        print(f"k={proj.momentum(s)}: E0 {e_ks[-1]!r}", flush=True)
    torch.cuda.synchronize()
    t_ks = time.perf_counter() - t0
    kwin = min(range(len(e_ks)), key=e_ks.__getitem__)
    t0 = time.perf_counter()
    e_win, v_win, info = proj.solve_sector(kwin, max_steps=steps_k)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    sym = {"sym_model": f"kitaev{nsite}_translation_projected",
           "sym_dim": ham.dim, "sym_sectors": proj.sectors(),
           "sym_build_s": build_s,
           "sym_k_iters_per_s": proj.sectors() * steps_k / t_ks,
           "sym_min_k": proj.momentum(kwin),
           "sym_min_k_e0_rel_err": abs(float(e_win[0]) - float(e_plain[0]))
           / abs(float(e_plain[0])),
           "sym_winner_purity": proj.purity(kwin, v_win[0])}
    print(f"winner k={proj.momentum(kwin)} solved in {win_s:.3f} s "
          f"({info.steps} steps), E0 {float(e_win[0])!r}", flush=True)
    del ham, proj, pk, v, v_win
    torch.cuda.empty_cache()
    both = blocks_against_projection(dev, 22)
    print(json.dumps({"card": smi, "sym": sym, "e_ks": e_ks,
                      "sectors_s": t_ks, "matvec_ms": matvec_ms,
                      "project_ms": project_ms,
                      "blocks_against_projection": both,
                      "peak_device_gb":
                          torch.cuda.max_memory_allocated(dev) / 1e9}),
          flush=True)


def blocks_against_projection(dev, nsite: int) -> dict:
    """The Kitaev ring's momentum sectors both ways on the card, in one
    run: by projection in the full space (the Engine's route on the card)
    and as orbit blocks through ell_spmv (its route on the CPU), each
    sector solved by ``lowest_states`` from its own start; the seconds of
    each part and the E0 of each sector."""
    import chip_smoke
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        build_factored_kitaev)
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    from lanczosplusplus_tpu_torch.symmetry import TranslationSymmetry
    from lanczosplusplus_tpu_torch.symmetry.projected import (
        ProjectedTranslationSolver)

    inp = parse_input(chip_smoke.kitaev_ring_text(nsite))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        made = fn()
        torch.cuda.synchronize()
        return made, time.perf_counter() - t
    out = {"nsite": nsite, "dim": basis.size}
    proj, out["projection_build_s"] = timed(lambda: ProjectedTranslationSolver(
        build_factored_kitaev(model, basis, device=dev), nsite))
    e_proj, solve_s = {}, 0.0
    for s in range(proj.sectors()):
        (evals, _, _), sec = timed(lambda: proj.solve_sector(s))
        e_proj[proj.momentum(s)] = float(evals[0])
        solve_s += sec
    out.update(projection_solve_s=solve_s, projection_e0=e_proj)
    del proj
    torch.cuda.empty_cache()
    sym, out["blocks_setup_s"] = timed(lambda: TranslationSymmetry(
        basis, model.geometry, model, fermionic=False, device=dev))
    e_blocks, build_s, solve_s, dims = {}, 0.0, 0.0, []
    for s in range(sym.sectors()):
        blk, sec = timed(lambda: sym.block_hamiltonian(s))
        build_s += sec
        if blk is None:
            continue
        dims.append((blk.dim, str(blk.dtype), blk.ell.cols.shape[1]))
        (evals, _), sec = timed(lambda: lz.lowest_states(blk))
        solve_s += sec
        e_blocks[sym._momenta[s][0]] = float(evals[0])
    out.update(blocks_build_s=build_s, blocks_solve_s=solve_s,
               blocks_e0=e_blocks, blocks_dim_dtype_k=dims)
    low_p, low_b = min(e_proj.values()), min(e_blocks.values())
    out["min_e0_rel_diff"] = abs(low_p - low_b) / abs(low_b)
    print(f"{nsite}-site Kitaev ring, dim {basis.size}: projection build "
          f"{out['projection_build_s']:.3f} s + {len(e_proj)} sector solves "
          f"{out['projection_solve_s']:.3f} s; blocks set-up "
          f"{out['blocks_setup_s']:.3f} s + {len(e_blocks)} block builds "
          f"{build_s:.3f} s + solves {solve_s:.3f} s; min E0 {low_p!r} "
          f"against {low_b!r} (rel diff {out['min_e0_rel_diff']:.3e})",
          flush=True)
    return out


def factored_form(text: str, dev):
    """The factored form SolverOptions=factored solves for an input, in
    its inner block order, built on `dev` as the Engine builds it."""
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.models.factored import (
        factored_hamiltonian_or_none)
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    ham = factored_hamiltonian_or_none(
        model, model.create_basis(parts), parts,
        Config.from_input(inp, device=dev).scalar_dtype, device=dev)
    return getattr(ham, "inner", ham)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--spectral", action="store_true",
                       help="trace the batched step of the spectral path")
    which.add_argument("--ftlm", action="store_true",
                       help="trace the batched FTLM recurrence (R = 16) of "
                            "chip_smoke.py phase 12a")
    which.add_argument("--flat", choices=sorted(FLAT_MODELS), default=None,
                       help="trace the ground-state step of this flat model")
    which.add_argument("--gather", action="store_true",
                       help="time perm_gather on chip_smoke.py phase 10's "
                            "cases")
    which.add_argument("--sym", action="store_true",
                       help="run bench.py's projected Kitaev translation at "
                            "24 sites")
    parser.add_argument("--trace-dir", default=None,
                        help="keep the chrome traces here")
    return parser.parse_args(argv)


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    import chip_smoke
    from chip_smoke import SEED, PlainForm, hubbard_chain_text
    from lanczosplusplus_tpu_torch import Config
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model
    from lanczosplusplus_tpu_torch.ops import kernels
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.gather:
        gather_main(smi)
        return
    if args.sym:
        sym_main(smi)
        return

    t = time.perf_counter()
    text = hubbard_chain_text(14, 4)
    if args.flat:
        writer, numbers = FLAT_MODELS[args.flat]
        text = getattr(chip_smoke, writer)(*numbers)
    factored = bool(args.flat) and args.flat.endswith("f")
    if factored:
        ham = factored_form(text, dev)   # solved in its block order
    else:
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        parts = (8, 7) if args.spectral else model.default_parts(inp)
        ham = model.hamiltonian(
            model.create_basis(parts), device=dev,
            dtype=Config.from_input(inp, device=dev).scalar_dtype)
        ham = ham.densify_factors()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    ell = getattr(ham, "ell", None)
    width = ell.cols.shape[1] if ell is not None else 0
    print(f"Hamiltonian build{'' if factored else ' and densify'}: "
          f"{build_s:.3f} s, dim {ham.dim}, {ham.dtype}, "
          + (type(ham).__name__ if factored else f"ELL K {width}"),
          flush=True)
    kernels.reset_launches()
    ham.matvec(torch.zeros(ham.dim, dtype=ham.dtype, device=dev))
    launches = dict(kernels.LAUNCHES)
    print(f"launches of one matvec: {launches}", flush=True)
    ops = {"kernel": ham, "plain": PlainForm(ham)}
    paths = ("plain", "kernel", "kernel", "plain")
    if ell is not None and 4 * ell.vals.numel() \
            * ell.vals.element_size() > torch.cuda.mem_get_info(dev)[0]:
        paths = ("kernel", "kernel")
        print("the plain version's intermediates do not fit: kernel turns "
              "only", flush=True)
    if args.spectral:
        v0 = torch.stack([
            lz.random_start_vector(ham.dim, SEED + r, torch.float64, dev)
            for r in range(SPECTRAL_ROWS)])
        steps, warmup = SPECTRAL_STEPS, SPECTRAL_WARMUP_STEPS
        recurrence = lz.tridiagonalize_plain_batched
    elif args.ftlm:
        v0 = lz.random_start_block(ham.dim, FTLM_ROWS, FTLM_SEED, ham.dtype,
                                   dev).T.contiguous()
        steps, warmup = SPECTRAL_STEPS, SPECTRAL_WARMUP_STEPS
        recurrence = ftlm_recurrence
    else:
        v0 = lz.random_start_vector(ham.dim, SEED, ham.dtype, dev)
        steps, warmup = STEPS, WARMUP_STEPS
        recurrence = lz.tridiagonalize

    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for i, path in enumerate(paths):
            r = profile_turn(
                lambda n, op=ops[path]: recurrence(op, v0, n), steps, warmup,
                os.path.join(trace_dir, f"turn{i}_{path}.json"))
            r["path"] = path
            turns.append(r)
            print(f"{path}: {r['steps']} steps, wall {r['wall_ms']:.3f} ms, "
                  f"{r['ms_per_step']:.3f} ms/step, device busy "
                  f"{r['device_busy_ms']:.3f} ms, idle share "
                  f"{r['idle_share']:.4f}", flush=True)
            for name, ms in r["top_device_ms"].items():
                print(f"  {ms:10.3f} ms  {name[:100]}", flush=True)
    print(json.dumps({"card": smi, "spectral": args.spectral,
                      "ftlm": args.ftlm, "flat": args.flat, "dim": ham.dim,
                      "build_s": build_s,
                      "launches_per_matvec": launches,
                      "peak_device_gb":
                          torch.cuda.max_memory_allocated(dev) / 1e9,
                      "turns": turns}),
          flush=True)


if __name__ == "__main__":
    main()
