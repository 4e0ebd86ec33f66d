"""The distributed paths the ``test_torch_parallel_*`` files run on every
rank of a gloo world (``torch_world.run_world``).  It imports the port
alone, never jax, so a rank starts in seconds; each function returns
numpy arrays keyed by case, the whole vectors gathered from every rank,
which the tests hold against the single-process port and the JAX
package's sharded runs in the test process.

The sectors (``CASES``): the JAX package's own distributed cases (an
8-site half-filled Hubbard ring, a 6-site SuperHubbardExtended ring with
its spin-coupled remainder, a 4-site two-orbital FeAs ring, an 8-site t-J
ring and a 6-site Rashba ring in factored form, an 8-site Heisenberg
chain), and two whose flat dimension and size_down are no multiple of 2
or 4 (an open 7-site Hubbard chain with 4 up and 3 down, dim 1225, and an
open 7-site SuperHubbardExtended chain, the same sector; open, so that
their ground states are not degenerate), so every padding runs."""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
from lanczosplusplus_tpu_torch.parallel.dryrun import (build, hubbard_text,
                                                       super_hubbard_text,
                                                       tj_text)

FEAS4 = """TotalNumberOfSites=4
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom=2
Orbitals=2
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 2 2
-1.0 0.0
0.0 -1.0
hubbardU 4 4.0 3.0 -0.8 -0.4
potentialV 16 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=1
"""

RASHBA6 = """TotalNumberOfSites=6
NumberOfTerms=2
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 0.5
Model=HubbardOneBandRashbaSOC
hubbardU 6 4 4 4 4 4 4
potentialV 12 0 0 0 0 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsTotal=6
IsPeriodicX=1
"""


def heisenberg_text(nsite: int) -> str:
    """Open S = 1/2 Heisenberg chain, J_pm = J_zz = 1, Sz = 0, factored."""
    block = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
             "GeometryOptions=ConstantValues\nConnectors 1 1.0\n")
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n" + block + block
            + "Model=Heisenberg\nHeisenbergTwiceS=1\n"
              f"TargetSzPlusConst={nsite // 2}\nSolverOptions=factored\n"
              "IsPeriodicX=0\n")


# name: (input text, parts); the flat ones have one-spin factors
CASES = {
    "hubbard8": (hubbard_text(8, 4, 4), (4, 4)),
    "hubbard7": (hubbard_text(7, 4, 3, periodic=0), (4, 3)),
    "she6": (super_hubbard_text(6, 3, 3), (3, 3)),
    "she7": (super_hubbard_text(7, 4, 3).replace("IsPeriodicX=1",
                                                 "IsPeriodicX=0"), (4, 3)),
    "feas4": (FEAS4, (2, 2)),
    "tj8": (tj_text(8, 3, 3), (3, 3)),
    "rashba6": (RASHBA6, ("ne", 6)),
    "heisenberg8": (heisenberg_text(8), None),
}
FLAT = ("hubbard8", "hubbard7", "she6", "she7", "feas4")
FACTORED = ("tj8", "rashba6")
FORMS = ("flat", "kron", "halo", "kronhalo")


def port_case(name: str, device="cpu"):
    """(model, basis, Hamiltonian) of a case on `device`: the flat
    ``Hamiltonian`` of a flat case, the factored ``PermutedHamiltonian``
    (with the flat one as a fourth item) of a factored one."""
    from lanczosplusplus_tpu_torch.models.factored import \
        factored_hamiltonian_or_none
    from lanczosplusplus_tpu_torch.models.rashba_halfcut import \
        build_halfcut_rashba
    from lanczosplusplus_tpu_torch.models.tj_factored import \
        build_factored_tj

    text, parts = CASES[name]
    model, inp = build(text)
    parts = parts or model.default_parts(inp)
    basis = model.create_basis(parts)
    flat = model.hamiltonian(basis, dtype=torch.float64, device=device)
    if name == "tj8":
        return model, basis, build_factored_tj(model, basis, device=device), \
            flat
    if name == "rashba6":
        return model, basis, build_halfcut_rashba(model, basis,
                                                  device=device), flat
    if name == "heisenberg8":
        return model, basis, factored_hamiltonian_or_none(
            model, basis, parts, torch.float64, device=device), flat
    return model, basis, flat


def inputs(dim: int, seed: int, rows: int | None = None) -> torch.Tensor:
    """A numpy-seeded state (dim,) or block (rows, dim)."""
    rng = np.random.default_rng(seed)
    shape = (dim,) if rows is None else (rows, dim)
    return torch.from_numpy(rng.standard_normal(shape))


def sharded_form(ham, form: str, mesh):
    """(sharded form, halo fraction or None) of a flat case."""
    from lanczosplusplus_tpu_torch.parallel.halo import (HaloPlan,
                                                         KronHaloPlan)
    from lanczosplusplus_tpu_torch.parallel.kron import \
        shard_kron_hamiltonian

    if form == "flat":
        return pmesh.shard_hamiltonian(ham, mesh), None
    if form == "kron":
        return shard_kron_hamiltonian(ham, mesh)[0], None
    plan = (HaloPlan if form == "halo" else KronHaloPlan)(ham, mesh.size)
    return plan.hamiltonian(mesh), plan.halo_fraction


def _apply(mesh, sham, x):
    return mesh.gather_rows(sham.matmat_t(mesh.local_rows(x, sham.dim)))


def forms(mesh) -> dict:
    """Every form's apply to one state and to a block of 3 (the whole
    result, unpadded), for every flat case and form and for the factored
    cases' column-sharded block form (in block order)."""
    from lanczosplusplus_tpu_torch.parallel.blockkron_dist import \
        shard_blockkron
    from lanczosplusplus_tpu_torch.parallel.halo import HaloPlan

    out = {}
    for name in FLAT:
        _, _, ham = port_case(name)
        x, X = inputs(ham.dim, 1), inputs(ham.dim, 2, 3)
        for form in FORMS:
            sham, fraction = sharded_form(ham, form, mesh)
            out[name, form] = (_apply(mesh, sham, x)[:ham.dim].numpy(),
                               _apply(mesh, sham, X)[:, :ham.dim].numpy(),
                               fraction)
        # the halo plan's functional form on its device arrays
        plan = HaloPlan(ham, mesh.size)
        y = plan.matvec_fn(mesh)(**plan.device_arrays(mesh),
                                 x=pmesh.sharded_vector(x, mesh, plan.dim))
        out[name, "halo matvec_fn"] = mesh.gather_rows(y)[:ham.dim].numpy()
    for name in FACTORED:
        _, _, fact, _ = port_case(name)
        x, X = inputs(fact.dim, 1), inputs(fact.dim, 2, 3)
        sham = shard_blockkron(fact.inner, mesh)
        out[name, "blockkron"] = (_apply(mesh, sham, x)[:fact.dim].numpy(),
                                  _apply(mesh, sham, X)[:, :fact.dim].numpy(),
                                  None)
    return out


def _state(res) -> tuple:
    """(E0, ground state) of a distributed solve."""
    return float(res[0][0]), res[1][0].numpy()


def solves(mesh) -> dict:
    """Every distributed solver on its cases: (E0, ground state); the
    halo form's plain tridiagonal from a given start vector; the budget,
    unconvergence, restart and keyword paths."""
    from lanczosplusplus_tpu_torch.parallel.halo import (
        HaloPlan, _halo_lowest_states_flat, halo_lowest_states)
    from lanczosplusplus_tpu_torch.parallel.kron import kron_lowest_states
    from lanczosplusplus_tpu_torch.solver import lanczos as lz

    out = {}
    for name in ("hubbard8", "hubbard7", "she7", "feas4"):
        _, _, ham = port_case(name)
        out[name, "distributed"] = _state(pmesh.distributed_lowest_states(
            ham, mesh, max_steps=120))
        out[name, "halo"] = _state(halo_lowest_states(ham, mesh,
                                                      max_steps=120))
    _, _, ham = port_case("hubbard8")
    out["hubbard8", "flat"] = _state(pmesh.distributed_lowest_states(
        ham, mesh, max_steps=120, prefer_kron=False))
    out["hubbard8", "halo flat"] = _state(_halo_lowest_states_flat(
        ham, mesh, max_steps=120))
    out["hubbard8", "kron"] = _state(kron_lowest_states(ham, mesh,
                                                        max_steps=120))
    for name in FACTORED:
        _, _, fact, _ = port_case(name)
        out[name, "distributed"] = _state(pmesh.distributed_lowest_states(
            fact, mesh, max_steps=160))

    # the halo form's plain tridiagonal from a given start vector
    plan = HaloPlan(ham, mesh.size)
    sham = plan.hamiltonian(mesh)
    v0 = inputs(ham.dim, 5)
    v0 = v0 / torch.linalg.vector_norm(v0)
    res = lz.tridiagonalize_plain(sham, mesh.local_rows(v0, sham.dim), 60)
    out["halo plain"] = (res.alphas, res.betas)

    # the budget: half the stored basis forces the plain two-pass solver
    steps = 80
    budget = steps * ham.dim * 8 // 2
    e, v, info = pmesh.distributed_lowest_states(
        ham, mesh, max_steps=steps, krylov_budget_bytes=budget,
        return_info=True)
    out["two-pass"] = (float(e[0]), v[0].numpy(), np.isnan(info.residual),
                       info.steps)
    # two steps cannot converge: the flag, and strict raises
    e, _, info = pmesh.distributed_lowest_states(ham, mesh, max_steps=2,
                                                 tol=1e-14, return_info=True)
    try:
        pmesh.distributed_lowest_states(ham, mesh, max_steps=2, tol=1e-14,
                                        strict=True)
        raised = False
    except RuntimeError:
        raised = True
    out["unconverged"] = (info.converged, raised)
    # the budget fits 40 steps of the padded basis but not 80: restarts
    budget = int(1.5 * 40 * sham.dim * 8)
    e, _, info = pmesh.distributed_lowest_states(
        ham, mesh, max_steps=40, krylov_budget_bytes=budget,
        return_info=True)
    out["restart"] = (float(e[0]), info.converged, info.steps)
    # the solve keywords through the halo and Kronecker solvers
    e_h, _, info_h = halo_lowest_states(ham, mesh, max_steps=120,
                                        return_info=True, tol=1e-11)
    e_k, _, info_k = kron_lowest_states(ham, mesh, max_steps=120,
                                        return_info=True, tol=1e-11)
    out["keywords"] = (float(e_h[0]), info_h.converged, float(e_k[0]),
                       info_k.converged)
    return out


def estimators(mesh) -> dict:
    """Every sharded estimator, from the same start blocks as the
    single-process port (the seeds of the tests), and the
    grand-canonical sweep and a scatter plan."""
    from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
    from lanczosplusplus_tpu_torch.engine.thermal import (GrandCanonicalFTLM,
                                                          operator_matrix)
    from lanczosplusplus_tpu_torch.parallel.scatter_plan import (
        SectorScatterPlan, distributed_apply_operator_map)

    out = {}
    betas = np.asarray([0.5, 2.0])
    model, basis, ham = port_case("hubbard8")
    dim = ham.dim
    res = pmesh.distributed_ftlm(ham, mesh, betas, num_vectors=12, steps=40,
                                 seed=5, operators={"one": np.ones(dim)})
    out["ftlm"] = (res.energy, res.specific_heat, res.log_z,
                   res.observables["one"])
    lres = pmesh.distributed_ltlm(ham, mesh, betas,
                                  {"obs": np.linspace(0.0, 1.0, dim),
                                   "energy": ham},
                                  num_vectors=4, steps=30, seed=9)
    out["ltlm"] = (lres["obs"], lres["energy"], lres["_log_z"])
    kres = pmesh.distributed_kpm_dos(ham, mesh, num_moments=32,
                                     num_vectors=8, seed=3,
                                     bounds=(-30.0, 30.0))
    out["kpm"] = kres.moments
    # bounds from the sharded form's own short Lanczos run
    kres = pmesh.distributed_kpm_dos(ham, mesh, num_moments=32,
                                     num_vectors=8, seed=3)
    out["kpm auto"] = (kres.moments, kres.a, kres.b)
    v0s = inputs(dim, 3, 3)
    v0s = v0s / torch.linalg.vector_norm(v0s, dim=1, keepdim=True)
    out["fleet"] = [(r.alphas, r.betas) for r in
                    pmesh.distributed_spectral_fleet(ham, mesh, v0s, 40)]

    # FTLM dynamics across sectors: c^dag_up at site 0, (2, 2) -> (3, 2)
    dmodel, _ = build(hubbard_text(4, 2, 2, periodic=0))
    src, dst = dmodel.create_basis((2, 2)), dmodel.create_basis((3, 2))
    ham_s = dmodel.hamiltonian(src, dtype=torch.float64, device="cpu")
    ham_d = dmodel.hamiltonian(dst, dtype=torch.float64, device="cpu")
    bmat = torch.from_numpy(operator_matrix(dmodel, "cdagger", 0, 0, 0, src,
                                            dst))
    V0 = inputs(ham_s.dim, 11, 6).T
    V0 = V0 / torch.linalg.vector_norm(V0, dim=0)
    dyn = pmesh.distributed_ftlm_dynamic(ham_s, ham_d, lambda v: v @ bmat,
                                         mesh, steps=20, start_vectors=V0)
    out["dynamic"] = [dyn.poles(b) for b in (0.5, 2.0)]

    # the factored forms: FTLM with a flat-order diagonal, a fleet, the
    # FTLM dynamics of a factored Heisenberg chain
    _, _, fact, _ = port_case("tj8")
    res = pmesh.distributed_ftlm(fact, mesh, betas, num_vectors=8, steps=30,
                                 seed=7, operators={
                                     "idx": np.arange(fact.dim, dtype=float)})
    out["ftlm tj8"] = (res.energy, res.observables["idx"])
    f0s = inputs(fact.dim, 4, 2)
    f0s = f0s / torch.linalg.vector_norm(f0s, dim=1, keepdim=True)
    out["fleet tj8"] = [(r.alphas, r.betas) for r in
                        pmesh.distributed_spectral_fleet(fact, mesh, f0s, 30)]
    _, _, hfact, _ = port_case("heisenberg8")
    diag = torch.linspace(-1.0, 1.0, hfact.dim, dtype=torch.float64)
    V0 = inputs(hfact.dim, 3, 4).T
    V0 = V0 / torch.linalg.vector_norm(V0, dim=0)
    dyn = pmesh.distributed_ftlm_dynamic(hfact, hfact, lambda v: diag * v,
                                         mesh, steps=16, start_vectors=V0)
    out["dynamic heisenberg8"] = [dyn.poles(b) for b in (0.5, 3.0)]

    # the grand-canonical FTLM sweep, each large sector sharded
    gmodel, _ = build(hubbard_text(4, 2, 2, periodic=0))
    gf = GrandCanonicalFTLM(gmodel, nsite=4, beta_grid=[0.5, 2.0],
                            dense_cutoff=8, num_vectors=8, steps=24,
                            mesh=mesh, device="cpu")
    out["grand canonical"] = np.asarray([
        [getattr(gf, q)(b, mu) for q in ("energy", "density",
                                         "log_partition", "specific_heat")]
        for b in (0.5, 2.0) for mu in (0.0, 0.8)])

    # scatter plans: c_up at site 0, (4, 4) -> (3, 4), and a random map
    dst_basis = model.create_basis((3, 4))
    tgt, amp, dst_dim = model.operator_map(LabeledOperator("c"), 0, 0, 0,
                                           basis, dst_basis)
    x = inputs(dim, 8)
    out["scatter c"] = distributed_apply_operator_map(
        tgt, amp, dst_dim, x, mesh).numpy()
    rng = np.random.default_rng(0)
    n_src, n_dst = 1001, 777
    rtgt = rng.integers(-1, n_dst, n_src)
    ramp = rng.standard_normal(n_src)
    rx = rng.standard_normal(n_src)
    plan = SectorScatterPlan(rtgt, ramp, n_src, n_dst, mesh.size)
    z = plan.apply(mesh, mesh.local_rows(torch.from_numpy(rx), plan.src_pad),
                   factor=0.5)
    out["scatter random"] = mesh.gather_rows(z)[:n_dst].numpy()
    return out


def grand_canonical(mesh) -> dict:
    """The grand-canonical FTLM sweep of the 4-site open Hubbard chain on
    the mesh (test_torch_thermal's case): {(beta, mu): {quantity:
    value}}."""
    from lanczosplusplus_tpu_torch.engine.thermal import GrandCanonicalFTLM

    model, _ = build(hubbard_text(4, 2, 2, periodic=0))
    gf = GrandCanonicalFTLM(model, 4, [0.5, 2.0], dense_cutoff=8,
                            num_vectors=8, steps=24, mesh=mesh,
                            device="cpu")
    return {(b, mu): {q: getattr(gf, q)(b, mu) for q in (
        "energy", "density", "log_partition", "specific_heat")}
        for b in (0.5, 2.0) for mu in (0.0, 0.8)}


def dryrun_no_jax(mesh) -> tuple:
    """``dryrun(mesh)``'s deviations and the jax modules this rank's
    interpreter holds after it (none)."""
    import sys

    from lanczosplusplus_tpu_torch.parallel.dryrun import dryrun

    errs = dryrun(mesh)
    return errs, sorted(m for m in sys.modules if m.split(".")[0] == "jax"), \
        mesh.transport
