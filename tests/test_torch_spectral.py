"""The port's spectral slice held against the JAX package on the CPU in
float64, at 6 sites: operator index maps, the batched Hamiltonian applies
and ELL helpers, the plain (batched) tridiagonalizations, and the
continued fractions of ``spectral_function`` and
``spectral_functions_batched``, which are also held against the dense
Lehmann sum.  Inputs come from a numpy seed; both engines are given the
same ground state, so coefficients compare and not only functions."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lanczosplusplus_tpu.core import sparse as jsparse
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine.operators import \
    LabeledOperator as JaxLabeledOperator
from lanczosplusplus_tpu.engine.spectral import \
    read_collection as jax_read_collection
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.core import sparse
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFractionCollection, read_collection)
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_spectral import lehmann_g
from test_torch_host import hubbard_chain_text, super_hubbard_text

torch.set_num_threads(2)

# 6-site HubbardOneBand PBC chain U = 4 (dim 400) and 6-site
# SuperHubbardExtended open chain (dim 400, J-ELL)
CASES = {"chain6": hubbard_chain_text(6) + "SpectralSteps=300\n",
         "super6": super_hubbard_text(6) + "SpectralSteps=300\n"}
OPERATORS = ["c", "cdagger", "n", "sz", "splus", "sminus"]
OMEGAS = np.linspace(-8, 8, 81)


def _models(name):
    inp, jinp = parse_input(CASES[name]), jax_parse(CASES[name])
    return (inp, build_model(inp, Geometry(inp)),
            jinp, jax_build_model(jinp, JaxGeometry(jinp)))


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    """(port Engine on the CPU, JAX Engine) holding one ground state."""
    inp, model, jinp, jmodel = _models(request.param)
    jengine = JaxEngine(jmodel, jinp)
    engine = Engine(model, inp, config=Config.from_input(inp, device="cpu"))
    assert abs(engine.ground_energy - jengine.ground_energy) <= 1e-10
    engine._energies = np.asarray(jengine._energies)
    engine._vectors = torch.as_tensor(
        np.stack([np.asarray(v) for v in jengine._vectors]))
    return engine, jengine


def _hams(name, parts=None):
    inp, model, jinp, jmodel = _models(name)
    parts = parts or model.default_parts(inp)
    ham = model.hamiltonian(model.create_basis(parts), device="cpu")
    jham = jmodel.hamiltonian(jmodel.create_basis(parts), dtype=np.float64)
    return ham, jham


# -- operator maps --------------------------------------------------------

@pytest.mark.parametrize("op_name", OPERATORS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_maps_equal(name, op_name):
    """``has_new_parts`` and ``operator_map`` for every site and spin."""
    inp, model, jinp, jmodel = _models(name)
    parts = model.default_parts(inp)
    src, jsrc = model.create_basis(parts), jmodel.create_basis(parts)
    op, jop = LabeledOperator(op_name), JaxLabeledOperator(op_name)
    assert op.needs_new_basis == jop.needs_new_basis
    for spin in (0, 1):
        new = model.has_new_parts(parts, op, spin, 0)
        assert new == jmodel.has_new_parts(parts, jop, spin, 0)
        dst, jdst = model.create_basis(new), jmodel.create_basis(new)
        for site in range(6):
            tgt, amp, dim = model.operator_map(op, site, spin, 0, src, dst)
            jtgt, jamp, jdim = jmodel.operator_map(jop, site, spin, 0, jsrc,
                                                   jdst)
            assert dim == jdim
            np.testing.assert_array_equal(tgt, jtgt)
            np.testing.assert_array_equal(amp, jamp)


def test_has_new_parts_leaves_the_hilbert_space():
    inp, model, _, jmodel = _models("chain6")
    for parts, op_name in (((6, 3), "cdagger"), ((0, 3), "c"),
                           ((6, 0), "splus"), ((0, 6), "sminus")):
        assert model.has_new_parts(parts, LabeledOperator(op_name), 0,
                                   0) is None
        assert jmodel.has_new_parts(parts, JaxLabeledOperator(op_name), 0,
                                    0) is None


# -- batched applies and ELL helpers --------------------------------------

@pytest.mark.parametrize("form", ["gather", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matmat_t_and_matmat_equal(name, form):
    ham, jham = _hams(name, parts=(4, 3))
    if form == "dense":
        ham, jham = ham.densify_factors(), jham.densify_factors()
    xk = np.random.default_rng(11).standard_normal((5, ham.dim))
    got = ham.matmat_t(torch.from_numpy(xk)).numpy()
    np.testing.assert_allclose(got, np.asarray(jham.matmat_t(jnp.asarray(xk))),
                               rtol=0, atol=1e-13)
    # every row of the block is a matvec
    np.testing.assert_allclose(
        got[2], ham.matvec(torch.from_numpy(xk[2])).numpy(), rtol=0,
        atol=1e-13)
    cols = np.ascontiguousarray(xk.T)
    np.testing.assert_allclose(
        ham.matmat(torch.from_numpy(cols)).numpy(),
        np.asarray(jham.matmat(jnp.asarray(cols))), rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        sparse.apply_block_t(ham, torch.from_numpy(xk)).numpy(), got,
        rtol=0, atol=0)


def test_apply_block_t_without_matmat_t():
    """An operator that only has ``matvec`` is applied row by row."""
    ham, _ = _hams("chain6")

    class OnlyMatvec:
        matvec = staticmethod(ham.matvec)

    xk = torch.from_numpy(
        np.random.default_rng(12).standard_normal((3, ham.dim)))
    np.testing.assert_allclose(
        sparse.apply_block_t(OnlyMatvec(), xk).numpy(),
        ham.matmat_t(xk).numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flatten_padded_equal(name):
    ham, jham = _hams(name)
    x = np.random.default_rng(13).standard_normal(ham.dim)
    for got, ref in ((ham.flatten_to_ell(), jham.flatten_to_ell()),
                     (ham.padded(64), jham.padded(64)),
                     (ham.padded(100), jham.padded(100))):
        assert got.factorized is None and got.spin_shape is None
        assert got.ell.cols.dtype == torch.int32
        assert got.ell.cols.is_contiguous() and got.ell.vals.is_contiguous()
        np.testing.assert_array_equal(got.ell.cols.numpy(),
                                      np.asarray(ref.ell.cols))
        np.testing.assert_allclose(got.ell.vals.numpy(),
                                   np.asarray(ref.ell.vals), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(got.diag.numpy(), np.asarray(ref.diag),
                                   rtol=0, atol=1e-13)
        xp = np.concatenate([x, np.zeros(got.dim - ham.dim)])
        np.testing.assert_allclose(
            got.matvec(torch.from_numpy(xp)).numpy()[:ham.dim],
            ham.matvec(torch.from_numpy(x)).numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("multiple", [1, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flatten_to_ell_host_equal(name, multiple):
    ham, jham = _hams(name)
    got = sparse.flatten_to_ell_host(ham, multiple)
    ref = jsparse.flatten_to_ell_host(jham, multiple)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-13)


def test_ell_spgemm_equal():
    rng = np.random.default_rng(14)
    n, ka, kb = 50, 3, 4
    a_cols = rng.integers(0, n, (n, ka)).astype(np.int32)
    b_cols = rng.integers(0, n, (n, kb)).astype(np.int32)
    a_vals, b_vals = rng.standard_normal((n, ka)), rng.standard_normal((n, kb))
    c_cols, c_vals = sparse.ell_spgemm(*map(torch.from_numpy,
                                            (a_cols, a_vals, b_cols, b_vals)))
    j_cols, j_vals = jsparse.ell_spgemm(*map(jnp.asarray,
                                             (a_cols, a_vals, b_cols, b_vals)))
    np.testing.assert_array_equal(c_cols.numpy(), np.asarray(j_cols))
    np.testing.assert_allclose(c_vals.numpy(), np.asarray(j_vals), rtol=0,
                               atol=1e-13)
    # the product applied to a vector is A (B x)
    x = rng.standard_normal(n)
    dense = lambda c, v: (v * x[c]).sum(-1)  # noqa: E731
    bx = (b_vals * x[b_cols]).sum(-1)
    np.testing.assert_allclose(dense(c_cols.numpy(), c_vals.numpy()),
                               (a_vals * bx[a_cols]).sum(-1), atol=1e-12)


# -- plain tridiagonalizations ---------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_tridiagonalize_plain_equal(name):
    ham, jham = _hams(name, parts=(4, 3))
    v0 = np.random.default_rng(15).standard_normal(ham.dim)
    v0 /= np.linalg.norm(v0)
    res = lz.tridiagonalize_plain(ham, v0, 40)
    jres = jlz.tridiagonalize_plain(jham, jnp.asarray(v0), 40)
    assert res.m == jres.m and res.V is None
    np.testing.assert_allclose(res.alphas[:10], jres.alphas[:10], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.betas[:10], jres.betas[:10], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("form", ["gather", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tridiagonalize_plain_batched_equal(name, form):
    """Rows 0-2 random; row 3 an eigenvector (breaks down at once: m = 1)
    and row 4 a sum of three (m = 3), so rows carry zeros past their
    breakdown and each is trimmed on its own."""
    ham, jham = _hams(name, parts=(4, 3))
    evecs = np.linalg.eigh(ham.to_dense())[1]
    v0s = np.random.default_rng(16).standard_normal((5, ham.dim))
    v0s[3] = evecs[:, 7]
    v0s[4] = evecs[:, 1] + 2 * evecs[:, 30] - evecs[:, 99]
    v0s /= np.linalg.norm(v0s, axis=1, keepdims=True)
    if form == "dense":
        ham, jham = ham.densify_factors(), jham.densify_factors()
    ress = lz.tridiagonalize_plain_batched(ham, v0s, 40)
    jress = jlz.tridiagonalize_plain_batched(jham, jnp.asarray(v0s), 40)
    assert [r.m for r in ress] == [r.m for r in jress]
    assert ress[3].m == 1 and ress[4].m == 3
    for res, jres in zip(ress, jress):
        assert res.V is None
        np.testing.assert_allclose(res.alphas[:10], jres.alphas[:10],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(res.betas[:10], jres.betas[:10], rtol=0,
                                   atol=1e-10)
    # a batched row is the serial recurrence of that row
    one = lz.tridiagonalize_plain(ham, v0s[1], 40)
    np.testing.assert_allclose(ress[1].alphas[:10], one.alphas[:10], rtol=0,
                               atol=1e-10)


def test_tridiagonalize_plain_batched_stops_when_all_rows_broke_down():
    """Exact zeros: a diagonal operator's basis vectors break down with
    beta = 0, after which no step runs."""
    calls = []

    class Diagonal:
        dim, dtype, device = 8, torch.float64, torch.device("cpu")

        def matmat_t(self, xk):
            calls.append(1)
            return xk * torch.arange(1.0, 9.0, dtype=torch.float64)

    ress = lz.tridiagonalize_plain_batched(Diagonal(), np.eye(8)[:3], 6)
    assert len(calls) == 1
    for r, res in enumerate(ress):
        assert res.m == 1 and res.alphas[0] == r + 1.0


# -- continued fractions ----------------------------------------------------

def _assert_cf_equal(cf, jcf, delta=0.1):
    assert cf.sigma == jcf.sigma and cf.meta == jcf.meta
    assert abs(cf.weight - jcf.weight) <= 1e-12
    assert abs(cf.e0 - jcf.e0) <= 1e-12
    np.testing.assert_allclose(cf.evaluate(OMEGAS, delta),
                               jcf.evaluate(OMEGAS, delta), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("op_name,i,j,spin", [("c", 0, 0, 0), ("c", 1, 4, 0),
                                              ("c", 2, 2, 1), ("sz", 0, 3, 0),
                                              ("splus", 1, 1, 0)])
def test_spectral_function_equal(engines, op_name, i, j, spin):
    engine, jengine = engines
    coll, labels = engine.spectral_function(op_name, i, j, spin=spin)
    jcoll, jlabels = jengine.spectral_function(op_name, i, j, spin=spin)
    assert labels == jlabels and len(coll.items) == len(jcoll.items)
    for cf, jcf in zip(coll.items, jcoll.items):
        _assert_cf_equal(cf, jcf)


@pytest.mark.parametrize("op_name", ["c", "sz"])
def test_spectral_functions_batched_equal(engines, op_name):
    engine, jengine = engines
    pairs = [(0, 0), (0, 2), (3, 3), (1, 5), (5, 5)]
    outs = engine.spectral_functions_batched(op_name, pairs, spin=0)
    jouts = jengine.spectral_functions_batched(op_name, pairs, spin=0)
    assert len(outs) == len(pairs)
    for (i, j), (coll, labels), (jcoll, jlabels) in zip(pairs, outs, jouts):
        assert labels == jlabels
        for cf, jcf in zip(coll.items, jcoll.items):
            _assert_cf_equal(cf, jcf)
            assert len(cf.alphas) == len(jcf.alphas)
            np.testing.assert_allclose(cf.alphas[:10], jcf.alphas[:10],
                                       rtol=0, atol=1e-9)
        serial, serial_labels = engine.spectral_function(op_name, i, j,
                                                         spin=0)
        assert labels == serial_labels
        np.testing.assert_allclose(coll.evaluate(OMEGAS, 0.12),
                                   serial.evaluate(OMEGAS, 0.12), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("i,j,spin", [(0, 0, 0), (0, 2, 0), (1, 1, 1)])
def test_spectral_functions_match_lehmann(engines, i, j, spin):
    """Against the dense Lehmann sum over the N+-1 sectors' full spectra,
    as the JAX package's own spectral tests do."""
    engine, jengine = engines
    expect = lehmann_g(jengine.model, 6, engine.parts, i, j, spin, OMEGAS,
                       0.1)
    coll, _ = engine.spectral_function("c", i, j, spin=spin)
    np.testing.assert_allclose(coll.evaluate(OMEGAS, 0.1), expect, rtol=0,
                               atol=1e-8)
    (bcoll, _), = engine.spectral_functions_batched("c", [(i, j)], spin=spin)
    np.testing.assert_allclose(bcoll.evaluate(OMEGAS, 0.1), expect, rtol=0,
                               atol=1e-8)


def test_diagonal_sum_rule_and_poles(engines):
    """w_add + w_rem = <{c, c^dag}> = 1, and the explicit poles carry the
    same weight."""
    engine, _ = engines
    (coll, _), = engine.spectral_functions_batched("c", [(2, 2)], spin=0)
    assert abs(sum(cf.weight for cf in coll.items) - 1.0) <= 1e-10
    for cf in coll.items:
        poles, weights = cf.poles_and_weights()
        assert abs(weights.sum() - cf.weight) <= 1e-10
        assert len(poles) == len(cf.alphas)


def test_spectral_batched_complex_scalar_on_cpu():
    """A complex ground state (useComplex) runs through the plain versions
    on the CPU; batched and serial fractions agree."""
    text = CASES["chain6"].replace("SolverOptions=none",
                                   "SolverOptions=useComplex")
    inp = parse_input(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device="cpu"))
    assert engine.eigenvector(0).dtype == torch.complex128
    pairs = [(0, 1), (2, 2)]
    outs = engine.spectral_functions_batched("c", pairs, spin=0)
    omegas = np.linspace(-6, 6, 41)
    for (i, j), (coll, _) in zip(pairs, outs):
        serial, _ = engine.spectral_function("c", i, j, spin=0)
        np.testing.assert_allclose(coll.evaluate(omegas, 0.1),
                                   serial.evaluate(omegas, 0.1), rtol=0,
                                   atol=1e-8)
    jinp = jax_parse(text)
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    jouts = jengine.spectral_functions_batched("c", pairs, spin=0)
    for (coll, labels), (jcoll, jlabels) in zip(outs, jouts):
        assert labels == jlabels
        np.testing.assert_allclose(coll.evaluate(omegas, 0.1),
                                   jcoll.evaluate(omegas, 0.1), rtol=0,
                                   atol=1e-8)


def test_calc_spectral_takes_the_plain_recurrence_over_budget(engines,
                                                              monkeypatch):
    """A Krylov basis over ``default_krylov_budget`` makes the serial
    fraction come from ``tridiagonalize_plain``; the function is the
    same."""
    engine, _ = engines
    stored, _ = engine.spectral_function("c", 1, 1)
    used = []
    plain = lz.tridiagonalize_plain
    monkeypatch.setattr(lz, "default_krylov_budget", lambda device: 1000)
    monkeypatch.setattr(lz, "tridiagonalize_plain",
                        lambda *a: used.append(1) or plain(*a))
    light, _ = engine.spectral_function("c", 1, 1)
    assert len(used) == 2
    np.testing.assert_allclose(light.evaluate(OMEGAS, 0.1),
                               stored.evaluate(OMEGAS, 0.1), rtol=0,
                               atol=1e-8)


def test_comb_text_read_back_by_the_jax_package(engines, tmp_path):
    engine, _ = engines
    coll, labels = engine.spectral_function("c", 0, 3)
    path = str(tmp_path / "pair.comb")
    with open(path, "w") as f:
        f.write("Site0=0\nSite1=3\n")
        coll.write(f, index_to_cf=labels)
    text = open(path).read()
    assert f"#INDEXTOCF {' '.join(labels)}\n" in text
    assert f"#CONTINUEDFRACTIONCOLLECTION={len(coll.items)}\n" in text
    assert "#CFMeta=0,3,0,0\n" in text
    for back in (jax_read_collection(path), read_collection(path)):
        assert len(back.items) == len(coll.items)
        for cf, got in zip(coll.items, back.items):
            assert (got.sigma, got.meta, got.weight, got.e0) == \
                (cf.sigma, cf.meta, cf.weight, cf.e0)
            np.testing.assert_array_equal(got.alphas, cf.alphas)
            np.testing.assert_array_equal(got.betas, cf.betas)
    assert isinstance(back, ContinuedFractionCollection)
