"""The port's distribution (``lanczosplusplus_tpu_torch/parallel``) on the
CPU: its host plans against the JAX package's and its dry run on gloo
worlds.

- ``HaloPlan`` (send_idx, new_cols, vals, diag, halo_fraction) and
  ``KronHaloPlan`` (ncd, vd, send_rows, diag2d, the remainder's tables,
  halo_fraction) from the same sector equal the JAX package's host arrays
  exactly, for ndev 1, 2, 3, 4 and 8, on the flat cases of
  ``torch_parallel_paths`` (padding included); ``SectorScatterPlan``'s
  tables equal the JAX package's for an operator map and a random map,
  through the native runtime and through the numpy bucketing.
- ``parallel.dryrun.dryrun(mesh)`` on gloo worlds of 1, 2, 3 and 4 ranks
  (one step of every path, each against the single-device port to 1e-12,
  the estimators to 1e-10), every rank on the ``gloo`` transport; a mesh
  refuses to be made without a process group, and on CUDA without a card.
"""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.parallel import halo as jhalo
from lanczosplusplus_tpu.parallel import scatter_plan as jscatter
from lanczosplusplus_tpu_torch import native
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.parallel import halo, scatter_plan
from lanczosplusplus_tpu_torch.parallel import mesh as pmesh
from torch_parallel_paths import CASES, FLAT, port_case
from torch_world import run_world

torch.set_num_threads(2)

NDEVS = (1, 2, 3, 4, 8)


def jax_case(name):
    """The JAX package's flat Hamiltonian of a case, in float64."""
    text, parts = CASES[name]
    inp = jax_parse(text)
    model = jax_build_model(inp, JaxGeometry(inp))
    return model.hamiltonian(model.create_basis(parts), dtype=np.float64)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", FLAT)
def test_halo_plan_equals_jax(name):
    _, _, ham = port_case(name)
    jham = jax_case(name)
    for ndev in NDEVS:
        plan, jplan = halo.HaloPlan(ham, ndev), jhalo.HaloPlan(jham, ndev)
        for field in ("send_idx", "new_cols", "vals", "diag"):
            assert _same(getattr(plan, field), getattr(jplan, field)), \
                (ndev, field)
        assert (plan.maxcount, plan.shard, plan.dim, plan.orig_dim) == \
            (jplan.maxcount, jplan.shard, jplan.dim, jplan.orig_dim)
        assert plan.halo_fraction == jplan.halo_fraction
        assert (plan.halo_fraction < 1.0) or ndev == 1


@pytest.mark.parametrize("name", FLAT)
def test_kron_halo_plan_equals_jax(name):
    _, _, ham = port_case(name)
    jham = jax_case(name)
    for ndev in NDEVS:
        plan = halo.KronHaloPlan(ham, ndev)
        jplan = jhalo.KronHaloPlan(jham, ndev)
        for field in ("ncd", "vd", "send_rows", "diag2d", "rem_cols",
                      "rem_vals", "rem_send", "up_cols", "up_vals"):
            assert _same(getattr(plan, field), getattr(jplan, field)), \
                (ndev, field)
        assert (plan.spin_shape, plan.d_shard, plan.max_rows, plan.dim) == \
            (tuple(jplan.spin_shape), jplan.d_shard, jplan.max_rows,
             jplan.dim)
        assert plan.halo_fraction == jplan.halo_fraction
    # the remainder rides its own exchange exactly where JAX's does
    assert (plan.rem_cols is None) == (name not in ("she6", "she7",
                                                    "feas4"))


def _scatter_maps():
    model, basis, _ = port_case("hubbard8")
    dst = model.create_basis((3, 4))
    tgt, amp, dst_dim = model.operator_map(LabeledOperator("c"), 0, 0, 0,
                                           basis, dst)
    rng = np.random.default_rng(0)
    return {"c_up site 0": (tgt, amp, basis.size, dst_dim),
            "random": (rng.integers(-1, 777, 1001),
                       rng.standard_normal(1001), 1001, 777)}


@pytest.mark.parametrize("which", ["c_up site 0", "random"])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_scatter_plan_equals_jax(which, path, monkeypatch):
    tgt, amp, src_dim, dst_dim = _scatter_maps()[which]
    if path == "numpy":
        monkeypatch.setattr(native, "scatter_plan_tables",
                            lambda *a, **k: None)
    else:
        assert native.available()
    for ndev in NDEVS:
        plan = scatter_plan.SectorScatterPlan(tgt, amp, src_dim, dst_dim,
                                              ndev)
        jplan = jscatter.SectorScatterPlan(tgt, amp, src_dim, dst_dim, ndev)
        for field in ("send_src", "send_amp", "dst_idx"):
            assert _same(getattr(plan, field), getattr(jplan, field)), \
                (ndev, field)
        assert (plan.maxcount, plan.s_src, plan.s_dst) == \
            (jplan.maxcount, jplan.s_src, jplan.s_dst)


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """dryrun(mesh) on gloo worlds of 1 to 4 ranks, every rank's result."""
    work = tmp_path_factory.mktemp("dryrun")
    return {size: run_world(size, "torch_parallel_paths:dryrun_no_jax", work)
            for size in (1, 2, 3, 4)}


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_dryrun_every_path(dryruns, size):
    """Each path's deviation from the single-device port is inside the
    dry run's own bars (it raised otherwise) and the same on every
    rank; the transport is gloo's on CPU tensors."""
    ranks = dryruns[size]
    assert len(ranks) == size
    errs, _, transport = ranks[0]
    assert transport == "gloo"
    assert set(errs) == {
        "flat ELL step", "Kronecker step", "Kronecker batched apply",
        "halo SpMV", "Kronecker halo with remainder",
        "block-Kronecker apply", "LTLM", "FTLM dynamics",
        "grand-canonical FTLM", "scatter plan"}
    for name, err in errs.items():
        assert err <= (1e-12 if name not in ("LTLM", "FTLM dynamics",
                                             "grand-canonical FTLM")
                       else 1e-10), name
    for other in ranks[1:]:
        assert other[0] == errs


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(device="cpu")


def test_make_mesh_defaults_to_the_card(tmp_path, monkeypatch):
    """In a one-rank gloo group of this process: without a card the
    default device raises (it never falls back to the CPU), the CPU named
    gives the gloo transport, and a one-rank mesh's sums are the
    values."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="cpu"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh(device="cuda")
        mesh = pmesh.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.transport) == (0, 1, "gloo")
        t = torch.randn(5, dtype=torch.complex128)
        assert torch.equal(mesh.sum(t), t)
        assert torch.equal(mesh.norm(t), torch.linalg.vector_norm(t))
        assert torch.equal(mesh.gather_rows(t), t)
    finally:
        dist.destroy_process_group()
