"""One step of every distributed path on a mesh, each held against the
single-device port on the same rank (counterpart of the JAX package's
multi-chip dry run, ``dryrun_multichip``): the flat ELL Lanczos step, the
Kronecker step, a batched step on the Kronecker form, the halo SpMV, the
Kronecker halo with a spin-coupled remainder, the column-sharded
block-Kronecker apply, LTLM, the double-Krylov FTLM dynamics, the
grand-canonical FTLM sweep and a scatter-plan sector change.  Every rank
calls ``dryrun(mesh)``; it raises on the first disagreement and returns
the largest deviation of each path.  The single-device references run
under ``kernels.uncounted()``, so the kernel launches counted over a dry
run are those of its distributed paths alone."""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
from lanczosplusplus_tpu_torch.solver import lanczos as lz

TOL = 1e-12      # relative to the largest entry compared


def _chain_block(value) -> str:
    return ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            f"GeometryOptions=ConstantValues\nConnectors 1 {value}\n")


def hubbard_text(nsite: int, nup: int, ndn: int, u: float = 4.0,
                 periodic: int = 1) -> str:
    """One-orbital Hubbard chain, t = -1."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=1\n"
            + _chain_block(-1.0) + "Model=HubbardOneBand\n"
            f"hubbardU {nsite} {' '.join([str(u)] * nsite)}\n"
            f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            f"SolverOptions=none\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndn}\nIsPeriodicX={periodic}\n")


def super_hubbard_text(nsite: int, nup: int, ndn: int) -> str:
    """SuperHubbardExtended ring: hopping -1, n_i n_j 0.4, J 1.1, U 3 (a
    Kronecker hopping part and a spin-coupled ELL remainder)."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + _chain_block(-1.0) + _chain_block(0.4) + _chain_block(1.1)
            + "Model=SuperHubbardExtended\n"
            f"hubbardU {nsite} {' '.join(['3'] * nsite)}\n"
            f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            f"SolverOptions=none\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndn}\nIsPeriodicX=1\n")


def tj_text(nsite: int, nup: int, ndn: int) -> str:
    """t-J ring, t = -1, J = 0.3."""
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + _chain_block(-1.0) + _chain_block(0.3) + _chain_block(0.3)
            + _chain_block(0.0) + "Model=TjMultiOrb\nOrbitals=1\n"
            f"SolverOptions=none\nTargetElectronsUp={nup}\n"
            f"TargetElectronsDown={ndn}\nIsPeriodicX=1\n")


def build(text: str):
    """(model, input) of an input text."""
    from lanczosplusplus_tpu_torch.geometry import Geometry
    from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
    from lanczosplusplus_tpu_torch.models import build_model

    inp = parse_input(text)
    return build_model(inp, Geometry(inp)), inp


def rel_diff(got, want) -> float:
    """max |got - want| over max |want|."""
    got = torch.as_tensor(got).detach().cpu()
    want = torch.as_tensor(want).detach().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


def _check(errs: dict, name: str, err: float, tol: float) -> None:
    errs[name] = float(err)
    if not err <= tol:
        raise AssertionError(f"dryrun {name}: deviation {err:.3e} > {tol:g}")


def dryrun(mesh: pmesh.Mesh) -> dict:
    """Run one step of every distributed path on `mesh`, each against the
    single-device port on this rank's device; returns {path: deviation}."""
    from lanczosplusplus_tpu_torch.core.sparse import apply_block_t
    from lanczosplusplus_tpu_torch.engine.engine import apply_operator_map
    from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import ftlm_dynamic
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    from lanczosplusplus_tpu_torch.engine.thermal import GrandCanonicalFTLM
    from lanczosplusplus_tpu_torch.models.tj_factored import \
        build_factored_tj
    from lanczosplusplus_tpu_torch.parallel.blockkron_dist import \
        shard_blockkron
    from lanczosplusplus_tpu_torch.parallel.halo import (HaloPlan,
                                                         KronHaloPlan)
    from lanczosplusplus_tpu_torch.parallel.kron import \
        shard_kron_hamiltonian

    dev, f64 = mesh.device, torch.float64
    errs: dict = {}
    model, _ = build(hubbard_text(8, 4, 4))
    basis = model.create_basis((4, 4))
    ham = model.hamiltonian(basis, dtype=f64, device=dev)
    dim0 = ham.dim
    v0 = torch.ones(dim0, dtype=f64, device=dev) / np.sqrt(dim0)
    zero = torch.zeros(dim0, dtype=f64, device=dev)

    # 1. the flat ELL step (the state all-gathered each matvec)
    with kernels.uncounted():
        _, _, alpha, beta = pmesh.lanczos_step(ham, v0, zero, 0.0)
    sham = pmesh.shard_hamiltonian(ham, mesh)
    v = mesh.local_rows(v0, sham.dim)
    _, _, s_alpha, s_beta = pmesh.lanczos_step(sham, v, torch.zeros_like(v),
                                               0.0)
    _check(errs, "flat ELL step", rel_diff(torch.stack([s_alpha, s_beta]),
                                           torch.stack([alpha, beta])), TOL)

    # 2. the Kronecker step (shard-local up GEMM, one all-gather for dn)
    kham, _ = shard_kron_hamiltonian(ham, mesh)
    kv = mesh.local_rows(v0, kham.dim)
    _, _, k_alpha, k_beta = pmesh.lanczos_step(kham, kv,
                                               torch.zeros_like(kv), 0.0)
    _check(errs, "Kronecker step", rel_diff(torch.stack([k_alpha, k_beta]),
                                            torch.stack([alpha, beta])), TOL)

    # 3. a batched step (the estimators' and fleets' SpMM) on it
    block = torch.randn(4, dim0, dtype=f64, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
    got = mesh.gather_rows(apply_block_t(kham, mesh.local_rows(block,
                                                               kham.dim)))
    with kernels.uncounted():
        want = apply_block_t(ham, block)
    _check(errs, "Kronecker batched apply", rel_diff(got[:, :dim0], want),
           TOL)

    # 4. the halo SpMV, against the single-device matvec
    hham = HaloPlan(ham, mesh.size).hamiltonian(mesh)
    got = mesh.gather_rows(hham.matvec(mesh.local_rows(block[0], hham.dim)))
    with kernels.uncounted():
        want = ham.matvec(block[0])
    _check(errs, "halo SpMV", rel_diff(got[:dim0], want), TOL)

    # 4b. the Kronecker halo with a spin-coupled ELL remainder
    rmodel, _ = build(super_hubbard_text(6, 3, 3))
    rham = rmodel.hamiltonian(rmodel.create_basis((3, 3)), dtype=f64,
                              device=dev)
    rplan = KronHaloPlan(rham, mesh.size)
    if rplan.rem_cols is None:
        raise AssertionError("dryrun: the SuperHubbardExtended sector has "
                             "no remainder")
    rsham = rplan.hamiltonian(mesh)
    rx = torch.randn(rham.dim, dtype=f64, device=dev,
                     generator=torch.Generator(dev).manual_seed(6))
    got = mesh.gather_rows(rsham.matvec(mesh.local_rows(rx, rsham.dim)))
    with kernels.uncounted():
        want = rham.matvec(rx)
    _check(errs, "Kronecker halo with remainder",
           rel_diff(got[:rham.dim], want), TOL)

    # 4c. the column-sharded block-Kronecker apply (factored t-J)
    tmodel, _ = build(tj_text(8, 3, 3))
    tfact = build_factored_tj(tmodel, tmodel.create_basis((3, 3)),
                              dtype=f64, device=dev)
    bsham = shard_blockkron(tfact.inner, mesh)
    bx = torch.randn(tfact.dim, dtype=f64, device=dev,
                     generator=torch.Generator(dev).manual_seed(7))
    got = mesh.gather_rows(bsham.matvec(mesh.local_rows(bx, bsham.dim)))
    with kernels.uncounted():
        want = tfact.inner.matvec(bx)
    _check(errs, "block-Kronecker apply", rel_diff(got[:tfact.dim], want),
           TOL)

    # 4d. LTLM: stored-V runs and operator projections on the shards
    from lanczosplusplus_tpu_torch.engine.ftlm import ltlm
    betas = np.asarray([0.5, 4.0])
    lres = pmesh.distributed_ltlm(ham, mesh, betas, {"energy": ham},
                                  num_vectors=2, steps=8, seed=3)
    with kernels.uncounted():
        sres = ltlm(ham, betas, {"energy": ham}, steps=8,
                    start_vectors=lz.random_start_block(dim0, 2, 3, f64,
                                                        dev))
    _check(errs, "LTLM", rel_diff(lres["energy"], sres["energy"]), 1e-10)

    # 4e. FTLM double-Krylov dynamics, both sectors sharded
    diag_op = torch.linspace(-1.0, 1.0, dim0, dtype=f64, device=dev)
    Vd = torch.randn(dim0, 2, dtype=f64, device=dev,
                     generator=torch.Generator(dev).manual_seed(8))
    Vd = Vd / torch.linalg.vector_norm(Vd, dim=0)
    dyn_d = pmesh.distributed_ftlm_dynamic(
        ham, ham, lambda x: diag_op * x, mesh, steps=6, start_vectors=Vd)
    with kernels.uncounted():
        dyn_s = ftlm_dynamic(ham, ham, lambda x: diag_op * x, steps=6,
                             start_vectors=Vd)
    om_d, wt_d = dyn_d.poles(1.0)
    om_s, wt_s = dyn_s.poles(1.0)
    _check(errs, "FTLM dynamics", abs((wt_d * om_d).sum()
                                      - (wt_s * om_s).sum()), 1e-10)

    # 4f. the grand-canonical FTLM sweep, each large sector sharded
    gmodel, _ = build(hubbard_text(4, 2, 2, periodic=0))
    args = dict(nsite=4, beta_grid=[1.0], dense_cutoff=8, num_vectors=4,
                steps=12, device=dev)
    gf_d = GrandCanonicalFTLM(gmodel, mesh=mesh, **args)
    with kernels.uncounted():
        gf_s = GrandCanonicalFTLM(gmodel, **args)
    _check(errs, "grand-canonical FTLM",
           max(abs(gf_d.energy(1.0, 0.5) - gf_s.energy(1.0, 0.5)),
               abs(gf_d.specific_heat(1.0, 0.5)
                   - gf_s.specific_heat(1.0, 0.5))), 1e-10)

    # 5. a scatter-plan sector change: c_up(site 0), (4, 4) -> (3, 4)
    from lanczosplusplus_tpu_torch.parallel.scatter_plan import \
        distributed_apply_operator_map
    dst_basis = model.create_basis((3, 4))
    tgt, amp, dst_dim = model.operator_map(LabeledOperator("c"), 0, 0, 0,
                                           basis, dst_basis)
    got = distributed_apply_operator_map(tgt, amp, dst_dim, block[1], mesh)
    with kernels.uncounted():
        want = apply_operator_map(tgt, amp, dst_dim, block[1])
    _check(errs, "scatter plan", rel_diff(got, want), TOL)
    return errs

