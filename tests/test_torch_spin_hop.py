"""spin_hop on the CPU (its plain version): the one-spin hops of a
Hubbard-family sector in gather form, compacted to their nonzero entries
(``kernels.compact_hops``), held bit for bit against the padded maps'
channel loop that the gather form ran before (``perm_gather_ref`` over the
maps' transposes) and against the dense form to 1e-13; the tables' layout;
the card's choice of form in ``densify_factors`` and its
``build.hop_form`` counter; and the checks the wrapper makes before it
dispatches.  The CUDA kernel runs on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu_torch.core import sparse
from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.utils import progress
from chip_smoke import hubbard_chain_text, super_hubbard_text

torch.set_num_threads(2)

# Hubbard rings with no ELL part, t-U-J rings with one (the
# exchange), and a sector with size_down 120 and size_up 210
SECTORS = {"hubbard8": hubbard_chain_text(8, 4.0),
           "hubbard10": hubbard_chain_text(10, 4.0),
           "hubbard12": hubbard_chain_text(12, 4.0),
           "tuj8": super_hubbard_text(8),
           "tuj10": super_hubbard_text(10),
           "tuj12": super_hubbard_text(12),
           "hubbard10_6_3": hubbard_chain_text(10, 4.0, 6, 3)}
_BUILT = {}


def _sector(name, dtype=torch.float64):
    """The sector's Hamiltonian on the CPU, in gather form (built once a
    module run)."""
    if (name, dtype) not in _BUILT:
        inp = parse_input(SECTORS[name])
        model = build_model(inp, Geometry(inp))
        basis = model.create_basis(model.default_parts(inp))
        _BUILT[name, dtype] = model.hamiltonian(basis, dtype=dtype)
    return _BUILT[name, dtype]


def _fresh(name):
    """The sector's Hamiltonian with a part of its own, whose form no
    ``densify_factors`` has counted yet."""
    ham = _sector(name)
    return dataclasses.replace(ham, factorized=dataclasses.replace(
        ham.factorized))


def _padded_gather_form(ham, xk):
    """H xk as the gather form ran it before the maps were compacted: the
    diagonal (or ell_spmv), then perm_gather's plain version over each
    padded map's every bond channel, up then dn."""
    f = ham.factorized
    if ham.ell is not None:
        y = kernels.ell_spmv(ham.diag, ham.ell.cols, ham.ell.vals, xk)
    else:
        y = ham.diag * xk
    shape = (*xk.shape[:-1], *ham.spin_shape)
    x3, y3 = xk.view(shape), y.view(shape)
    kernels.perm_gather_ref(x3, y3, cs=f.up_cols.T.contiguous(),
                            beta=f.up_vals.T.contiguous())
    kernels.perm_gather_ref(x3, y3, rs=f.dn_cols.T.contiguous(),
                            a=f.dn_vals.T.contiguous())
    return y


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("name", sorted(SECTORS))
def test_plain_version_equals_gather_form(name, rows):
    """The compacted maps give the padded gather form's H x bit for bit,
    the diagonal fused in where there is no ELL part, and the dense form's
    to 1e-13; one state alone equals its row of a block."""
    ham = _sector(name)
    f = ham.factorized
    assert f.up_hop is not None and f.dn_hop is not None
    assert f.up_gather is None and f.dn_gather is None
    assert f.takes_diagonal
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, ham.dim)))
    got = ham.matmat_t(x)
    assert torch.equal(got, _padded_gather_form(ham, x))
    assert torch.equal(ham.matvec(x[-1]), got[-1])
    dense = ham.densify_factors()
    assert dense.factorized.up_dense is not None
    want = dense.matmat_t(x)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    assert kernels.LAUNCHES["spin_hop"] == 0


@pytest.mark.parametrize("name", ["hubbard10_6_3", "tuj10"])
def test_plain_version_equals_gather_form_float32(name):
    """The same in float32, each product and sum rounded in float32."""
    ham = _sector(name, torch.float32)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, ham.dim))).float()
    assert torch.equal(ham.matmat_t(x), _padded_gather_form(ham, x))


def test_compact_hops_keeps_nonzeros_in_bond_order():
    """Each row's nonzero entries in their k order at its first slots, its
    count beside them, the other slots the row's own index and 0."""
    cols = torch.tensor([[3, 0, 2, 1], [1, 1, 1, 1], [0, 2, 3, 2],
                         [1, 3, 0, 2]], dtype=torch.int32)
    vals = torch.tensor([[0.5, 0.0, -1.0, 2.0], [0.0, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 3.0, 0.0], [4.0, 5.0, 6.0, 7.0]])
    hop = kernels.compact_hops(cols, vals)
    assert hop.counts.tolist() == [3, 0, 1, 4]
    assert hop.nnz == 8
    assert hop.cols.shape == hop.vals.shape == (4, 4)
    assert hop.cols.dtype == hop.counts.dtype == torch.int32
    assert hop.cols.T.tolist() == [[3, 2, 1, 0], [1, 1, 1, 1], [3, 2, 2, 2],
                                   [1, 3, 0, 2]]
    assert hop.vals.T.tolist() == [[0.5, -1.0, 2.0, 0.0], [0.0] * 4,
                                   [3.0, 0.0, 0.0, 0.0], [4.0, 5.0, 6.0, 7.0]]


def _hop_factor(nsite, npart):
    """The compacted one-spin hop map of npart particles on an nsite ring,
    built from the one-spin words alone (no product basis)."""
    b = OneSpinBasis(nsite, npart)
    bonds = [(i, (i + 1) % nsite, -1.0) for i in range(nsite)]
    bonds += [(j, i, t) for i, j, t in bonds]
    cols, vals = sparse.one_spin_ell(b.words, b.rank, bonds, np.float64)
    return kernels.compact_hops(torch.from_numpy(cols),
                                torch.from_numpy(vals))


@pytest.mark.parametrize("nsite,npart", [(12, 6), (14, 7), (4, 2)])
def test_hop_factor_tables_of_the_cells(nsite, npart):
    """The compacted tables of the cells' 924^2 and 3432^2 factors (and a
    4-site one): every bond whose two sites differ in occupancy, 2 C(n-2,
    k-1) words a bond, and no more slots a row than the ring has bonds."""
    hop = _hop_factor(nsite, npart)
    size = math.comb(nsite, npart)
    assert hop.counts.shape == (size,)
    assert hop.nnz == nsite * 2 * math.comb(nsite - 2, npart - 1)
    assert hop.nnz == int(hop.counts.sum())
    assert hop.cols.shape[0] == int(hop.counts.max()) <= nsite


@pytest.mark.parametrize("szu,elem,has_up,plan", [
    (3432, 8, True, (2, True)), (3432, 4, True, (2, True)),
    (12870, 8, True, (1, True)), (184756, 8, True, (1, False)),
    (3432, 8, False, (1, False))])
def test_spin_hop_plan(szu, elem, has_up, plan):
    """Two rows a block where two fit the staging budget (the 14-site
    chain's), one where one does (16 sites), none staged past it (the
    20-site chain's 184 756-long rows) or without an up map."""
    assert tuple(kernels.spin_hop_plan(szu, elem, has_up)) == plan


@pytest.fixture
def on_the_card(monkeypatch):
    """``densify_factors`` deciding as on the card: the Hamiltonian says
    it lies on a CUDA device with 80 GB free; its tensors stay on the
    CPU."""
    monkeypatch.setattr(sparse.Hamiltonian, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 << 30, 80 << 30))


@pytest.mark.parametrize("name,kwargs,dense,hop_form", [
    ("hubbard12", {}, None, 2),
    ("tuj12", {}, None, 2),
    ("hubbard10_6_3", {}, None, 2),
    ("hubbard12", {"factor_dtype": torch.bfloat16}, torch.bfloat16, 0),
    ("hubbard12", {"max_bytes": 1 << 30}, torch.float64, 0),
    ("hubbard12", {"max_bytes": 0}, None, 2),
    ("hubbard10_6_3", {"max_bytes": 0}, None, 2),
    ("hubbard10_6_3", {"max_bytes": 120 * 120 * 8}, "dn", 1)])
def test_densify_factors_on_the_card(on_the_card, name, kwargs, dense,
                                     hop_form):
    """On the card the default keeps both real factors in the hop form and
    counts 2 in ``build.hop_form`` (the 12-site sectors' 924^2, the
    10-site sector's 210^2 and 120^2); bf16 factors and an explicit budget
    decide by bytes alone (the dn factor alone within the last one)."""
    ham = _fresh(name)
    before = progress.COUNTS.get("build.hop_form", 0)
    f = ham.densify_factors(**kwargs).factorized
    assert progress.COUNTS.get("build.hop_form", 0) - before == hop_form
    if dense is None:
        assert f.up_dense is None and f.dn_dense is None
    elif dense == "dn":
        assert f.up_dense is None and f.up_hop is not None
        assert f.dn_dense.dtype == torch.float64 and f.dn_hop is None
    else:
        assert f.up_dense.dtype == f.dn_dense.dtype == dense
        assert f.up_hop is None and f.dn_hop is None


@pytest.mark.parametrize("sites,dtype,hops", [
    (4, torch.float64, 2), (8, torch.float64, 2), (8, torch.complex128, 0)])
def test_densify_factors_on_the_card_by_dtype(on_the_card, sites, dtype,
                                              hops):
    """On the card a real factor takes the hop form at every size, the
    4-site sector's 6^2 (2.7 nonzeros a row) as the 8-site one's 70^2; a
    complex sector's factors are made dense within the budget, counting
    nothing."""
    inp = parse_input(hubbard_chain_text(sites, 4.0))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            dtype=dtype)
    before = progress.COUNTS.get("build.hop_form", 0)
    f = ham.densify_factors().factorized
    assert progress.COUNTS.get("build.hop_form", 0) - before == hops
    assert (f.up_dense is None and f.dn_dense is None) == bool(hops)
    assert (f.up_hop is not None and f.dn_hop is not None) == bool(hops)


@pytest.mark.parametrize("calls", [
    ({}, {}), ({"max_bytes": 0}, {}), ({}, {"max_bytes": 0})])
def test_hop_form_counted_once_a_part(on_the_card, calls):
    """A second ``densify_factors`` on a Hamiltonian already in the hop
    form (as the Engine's batched form, thermal, dynamics and refine call
    it) counts nothing more: 2 a sector."""
    ham = _fresh("hubbard10_6_3")
    before = progress.COUNTS.get("build.hop_form", 0)
    for kwargs in calls:
        ham = ham.densify_factors(**kwargs)
    assert progress.COUNTS.get("build.hop_form", 0) - before == 2
    assert ham.factorized.up_hop is not None


def test_mixed_form_adds_in_the_gather_form_order():
    """Up in hop form beside a dense dn factor (an explicit budget): the
    diagonal and the up sum in spin_hop's plain version, then the GEMM, as
    the gather form with a dense dn factor ran them."""
    ham = _sector("hubbard10_6_3")
    mixed = ham.densify_factors(max_bytes=120 * 120 * 8)
    f = mixed.factorized
    assert f.dn_dense is not None and f.up_hop is not None
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, ham.dim)))
    want = ham.diag * x
    shape = (2, *ham.spin_shape)
    kernels.perm_gather_ref(x.view(shape), want.view(shape),
                            cs=f.up_cols.T.contiguous(),
                            beta=f.up_vals.T.contiguous())
    kernels.factor_matmul(x.view(shape).transpose(-1, -2), f.dn_dense,
                          out=want.view(shape).transpose(-1, -2),
                          accumulate=True)
    assert torch.equal(mixed.matmat_t(x), want)


@pytest.mark.parametrize("case", ["no_maps", "shape", "table_shape",
                                  "index_dtype", "count_shape", "diag_shape",
                                  "strided", "no_kernel_device"])
def test_spin_hop_rejects_bad_operands(case):
    """The wrapper refuses what the kernel does not take, before it
    dispatches (so on the CPU as on the card)."""
    x = torch.zeros(2, 5, 6, dtype=torch.float64)
    y = torch.zeros(2, 5, 6, dtype=torch.float64)
    up = kernels.HopTables(torch.zeros(3, 6, dtype=torch.int32),
                           torch.zeros(3, 6, dtype=torch.float64),
                           torch.zeros(6, dtype=torch.int32))
    dn = kernels.HopTables(torch.zeros(2, 5, dtype=torch.int32),
                           torch.zeros(2, 5, dtype=torch.float64),
                           torch.zeros(5, dtype=torch.int32))
    kw = dict(up=up, dn=dn)
    if case == "no_maps":
        kw = {}
    elif case == "shape":
        y = torch.zeros(2, 6, 5, dtype=torch.float64)
    elif case == "table_shape":
        kw["up"] = dn
    elif case == "index_dtype":
        kw["dn"] = dn._replace(cols=dn.cols.long())
    elif case == "count_shape":
        kw["up"] = up._replace(counts=torch.zeros(5, dtype=torch.int32))
    elif case == "diag_shape":
        kw["diag"] = torch.zeros(31, dtype=torch.float64)
    elif case == "strided":
        x = torch.zeros(2, 6, 5, dtype=torch.float64).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        if case == "no_kernel_device":
            kernels.spin_hop(x.to("meta"), y.to("meta"),
                             **{k: kernels.HopTables(*(t.to("meta")
                                                       for t in v))
                                for k, v in kw.items()})
        else:
            kernels.spin_hop(x, y, **kw)
