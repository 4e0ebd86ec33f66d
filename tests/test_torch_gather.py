"""The port's perm_gather on the CPU (its plain version) held against the
JAX package's gathers: the PermCrossTerm bond loop (``_perm_cross_apply``
and ``_perm_cross_apply_batched``, with shared row maps and shared column
groups) and the one-spin gather form of ``SpinFactorizedPart.apply``
(spin_hop's plain version in float64), in float64 and complex128 to
1e-13; the gather form kept by
``densify_factors``, alone and beside a dense factor; and the checks the
wrapper makes before it dispatches.  The CUDA kernel runs on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.core import blockkron as jax_blockkron
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.core.blockkron import make_perm_cross
from lanczosplusplus_tpu_torch.core.sparse import SpinFactorizedPart
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.ops import kernels
from test_torch_host import hubbard_chain_text

torch.set_num_threads(2)

TOL = 1e-13


def _random_channels(rng, dtype, nb=6, rows=(23, 19), cols=(31, 27)):
    """Host tables of nb channels from a (rows[0], cols[0]) source block to
    a (rows[1], cols[1]) destination, with repeated row maps (channels
    0 and 3, 1 and 4) and repeated (column map, amplitude) pairs (2 and 5)
    so both of the JAX package's groupings are exercised; some
    destinations unreached (amplitude 0, index 0)."""
    (rs_, rd), (cs_, cd) = rows, cols
    row_src = rng.integers(0, rs_, (nb, rd)).astype(np.int32)
    col_src = rng.integers(0, cs_, (nb, cd)).astype(np.int32)
    row_src[3], row_src[4] = row_src[0], row_src[1]

    def amps(shape):
        a = rng.standard_normal(shape)
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.standard_normal(shape)
        a[:, ::5] = 0.0
        return a.astype(dtype)
    row_amp, col_amp = amps((nb, rd)), amps((nb, cd))
    col_src[5], col_amp[5] = col_src[2], col_amp[2]
    row_src[:, ::5] = 0
    return row_src, row_amp, col_src, col_amp


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("batch", [None, 4])
def test_perm_gather_ref_matches_jax_bond_loop(dtype, batch):
    """The port's PermCrossTerm tables, groups included, give the JAX
    package's ``_perm_cross_apply(_batched)`` result to 1e-13."""
    rng = np.random.default_rng(3 if batch is None else 4)
    tables = _random_channels(rng, dtype)
    jterm = jax_blockkron.make_perm_cross(*tables, 0, 1, dtype)
    term = make_perm_cross(*tables, 0, 1,
                           torch.complex128 if dtype == np.complex128
                           else torch.float64)
    assert term.groups == jterm.groups
    assert term.col_groups == jterm.col_groups
    assert any(len(g) > 1 for g in term.groups)
    assert any(len(g) > 1 for g in term.col_groups)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal((*lead, 23, 31)).astype(dtype)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(x.shape)
    apply = (jax_blockkron._perm_cross_apply if batch is None
             else jax_blockkron._perm_cross_apply_batched)
    expect = np.asarray(apply(jterm, jnp.asarray(x)))
    out = torch.zeros((*lead, 19, 27), dtype=term.row_amp.dtype)
    for groups in ((term.groups, term.col_groups), (None, None)):
        got = kernels.perm_gather(
            torch.from_numpy(x), out.clone(), rs=term.row_src,
            a=term.row_amp, cs=term.col_src, beta=term.col_amp,
            groups=groups[0], col_groups=groups[1]).numpy()
        assert np.abs(got - expect).max() <= TOL * np.abs(expect).max()


def _both_hubbard(nsite, nup, ndown, u=4.0):
    text = hubbard_chain_text(nsite).replace(
        f"TargetElectronsDown={nsite // 2}", f"TargetElectronsDown={ndown}"
    ).replace(f"TargetElectronsUp={nsite // 2}", f"TargetElectronsUp={nup}")
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    basis, jbasis = model.create_basis(parts), jmodel.create_basis(parts)
    return (model.hamiltonian(basis, dtype=torch.float64),
            jmodel.hamiltonian(jbasis, dtype=np.float64))


@pytest.mark.parametrize("batch", [None, 3])
def test_one_spin_gather_form_matches_jax(batch):
    """The one-spin gather form of a real sector, through spin_hop's
    tables (each map's nonzero entries, ``kernels.compact_hops``), against
    the JAX package's ``SpinFactorizedPart.apply``; a complex sector's
    maps keep perm_gather's (K, size) tables, the maps transposed."""
    ham, jham = _both_hubbard(8, 3, 2)
    f, jf = ham.factorized, jham.factorized
    assert f.up_dense is None and f.dn_dense is None
    # the tables are made when the part is built
    for side in ("up", "dn"):
        cols, vals = getattr(f, f"{side}_cols"), getattr(f, f"{side}_vals")
        assert getattr(f, f"{side}_gather") is None
        hop, want = getattr(f, f"{side}_hop"), kernels.compact_hops(cols,
                                                                   vals)
        assert all(torch.equal(a, b) for a, b in zip(hop, want))
        fc = SpinFactorizedPart(up_cols=cols, up_vals=vals.to(
            torch.complex128), dn_cols=None, dn_vals=None)
        tab, amp = fc.up_gather
        assert fc.up_hop is None
        assert tab.is_contiguous() and amp.is_contiguous()
        assert torch.equal(tab, cols.T) and torch.equal(amp, vals.T)
    szd, szu = ham.spin_shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal((batch or 1, szd, szu))
    y = torch.zeros(x.shape, dtype=torch.float64)
    f.apply_(torch.from_numpy(x), y)
    for b in range(x.shape[0]):
        expect = np.asarray(jf.apply(jnp.asarray(x[b])))
        assert np.abs(y[b].numpy() - expect).max() <= \
            TOL * np.abs(expect).max()


@pytest.mark.parametrize("max_bytes,dense_sides", [(0, ()), (8 * 28 * 28,
                                                              ("dn",)),
                                                   (None, ("up", "dn"))])
def test_gather_form_kept_by_densify_factors(max_bytes, dense_sides):
    """``densify_factors`` keeps a factor over its budget in gather form
    (every device: no raise), so a sector may mix the two forms; every
    mix gives the JAX package's matvec."""
    ham, jham = _both_hubbard(8, 3, 2)      # size_up 56, size_down 28
    form = ham.densify_factors() if max_bytes is None else \
        ham.densify_factors(max_bytes=max_bytes)
    f = form.factorized
    assert {s for s in ("up", "dn")
            if getattr(f, f"{s}_dense") is not None} == set(dense_sides)
    # a dense factor keeps no gather tables
    assert {s for s in ("up", "dn")
            if getattr(f, f"{s}_hop") is None} == set(dense_sides)
    x = np.random.default_rng(2).standard_normal(ham.dim)
    expect = np.asarray(jham.matvec(jnp.asarray(x)))
    got = form.matvec(torch.from_numpy(x)).numpy()
    assert np.abs(got - expect).max() <= 1e-12 * np.abs(expect).max()
    assert kernels.LAUNCHES["perm_gather"] == 0


def test_engine_on_gather_form_reaches_dense_energy():
    """A CPU solve runs the gather form through spin_hop's plain version
    and reaches the dense energy."""
    inp = parse_input(hubbard_chain_text(6))
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config(device="cpu"))
    assert engine.hamiltonian.factorized.up_hop is not None
    dense = np.linalg.eigvalsh(engine.hamiltonian.to_dense())
    assert abs(engine.ground_energy - dense[0]) <= 1e-10 * abs(dense[0])


@pytest.mark.parametrize("case", ["no_tables", "row_length", "col_length",
                                  "index_dtype", "strided_table",
                                  "identity_mismatch", "batch_mismatch",
                                  "channels_differ", "no_kernel_device"])
def test_perm_gather_rejects_bad_operands(case):
    """The wrapper refuses what the kernel does not take, before it
    dispatches (so on the CPU as on the card)."""
    x = torch.zeros(2, 5, 6, dtype=torch.float64)
    out = torch.zeros(2, 4, 7, dtype=torch.float64)
    rs = torch.zeros(3, 4, dtype=torch.int32)
    cs = torch.zeros(3, 7, dtype=torch.int32)
    kw = dict(rs=rs, cs=cs)
    if case == "no_tables":
        kw = {}
    elif case == "row_length":
        kw["rs"] = torch.zeros(3, 5, dtype=torch.int32)
    elif case == "col_length":
        kw["beta"] = torch.zeros(3, 6, dtype=torch.float64)
    elif case == "index_dtype":
        kw["cs"] = cs.long()
    elif case == "strided_table":
        kw["cs"] = torch.zeros(7, 3, dtype=torch.int32).T
    elif case == "identity_mismatch":
        kw.pop("rs")
    elif case == "batch_mismatch":
        out = torch.zeros(3, 4, 7, dtype=torch.float64)
    elif case == "channels_differ":
        kw["a"] = torch.zeros(2, 4, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        if case == "no_kernel_device":
            kernels.perm_gather(x.to("meta"), out.to("meta"), **kw)
        else:
            kernels.perm_gather(x, out, **kw)
