"""chip_smoke.py's helpers that need no card, on the CPU: the CSR forms its
library times run compute the kernels' functions, the plain-kernel swap
restores the wrappers, the launch count it predicts for a factored
form's matvec is the count of wrapper calls one matvec makes, the
launches it counts at each form's call sites split as predicted,
phase 12's CLI runner, beta schedule and Lanczos-tridiagonal moments, and
phase 13's Ainur text (the legacy input's labels), native call counter and
switch to the numpy paths."""

import numpy as np
import pytest
import torch

import chip_smoke
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from lanczosplusplus_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ell_csr_is_ell_spmv(dtype):
    g = torch.Generator().manual_seed(3)
    dim, k = 500, 9
    cols = torch.randint(0, dim, (dim, k), generator=g, dtype=torch.int32)
    vals = torch.randn(dim, k, generator=g, dtype=torch.float64).to(dtype)
    vals[::5, 3] = 0.0                     # padding-like zeros
    diag = torch.randn(dim, generator=g, dtype=torch.float64)
    x = torch.randn(4, dim, generator=g, dtype=torch.float64).to(dtype)
    csr = chip_smoke.ell_csr(diag, cols, vals)
    want = kernels.ell_spmv_ref(diag, cols, vals, x)
    np.testing.assert_allclose((csr @ x.T).T.numpy(), want.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose((csr @ x[1]).numpy(), want[1].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("sides", ["both", "rows_identity", "cols_identity"])
def test_perm_csr_is_perm_gather(sides):
    g = torch.Generator().manual_seed(4)
    nb, src, dst = 3, (7, 11), (5, 11 if sides == "cols_identity" else 6)
    if sides == "rows_identity":
        dst = (7, 6)
    tables = {}
    if sides != "rows_identity":
        tables["rs"] = torch.randint(0, src[0], (nb, dst[0]), generator=g,
                                     dtype=torch.int32)
        tables["a"] = torch.randn(nb, dst[0], generator=g,
                                  dtype=torch.float64)
    if sides != "cols_identity":
        tables["cs"] = torch.randint(0, src[1], (nb, dst[1]), generator=g,
                                     dtype=torch.int32)
        tables["beta"] = torch.randn(nb, dst[1], generator=g,
                                     dtype=torch.float64)
    x = torch.randn(src, generator=g, dtype=torch.float64)
    want = kernels.perm_gather_ref(x, torch.zeros(dst, dtype=torch.float64),
                                   **tables)
    csr = chip_smoke.perm_csr(tables, src, dst, torch.float64, "cpu")
    np.testing.assert_allclose((csr @ x.reshape(-1)).view(dst).numpy(),
                               want.numpy(), rtol=0, atol=1e-12)


def test_plain_kernels_swaps_and_restores():
    wrappers = (kernels.factor_matmul, kernels.ell_spmv, kernels.perm_gather)
    with chip_smoke.plain_kernels():
        assert kernels.perm_gather is kernels.perm_gather_ref
        x = torch.randn(3, 4, dtype=torch.float64)
        a = torch.randn(5, 4, dtype=torch.float64)
        out = torch.ones(3, 5, dtype=torch.float64)
        kernels.factor_matmul(x, a, out=out, accumulate=True)
        np.testing.assert_allclose(out.numpy(), (1 + x @ a.T).numpy())
    assert (kernels.factor_matmul, kernels.ell_spmv,
            kernels.perm_gather) == wrappers


@pytest.mark.parametrize("text", [
    chip_smoke.tj_ring_text(8, 3, 3),
    chip_smoke.heisenberg_ring_text(10),
    chip_smoke.rashba_ring_text(5, 5),
    chip_smoke.kitaev_ring_text(8),
], ids=["tj", "heisenberg", "rashba_complex", "kitaev"])
def test_form_launches_counts_one_matvec(text):
    """On the CPU every product reaches the plain versions; counting the
    wrapper calls of one matvec, with a complex state's factor_matmul
    calls weighted as the card's planes wrapper launches them, gives
    form_launches' prediction."""
    inp = parse_input(chip_smoke.factored(text))
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    dtype = torch.complex128 if "useComplex" in text else torch.float64
    ham = factored_hamiltonian_or_none(model, model.create_basis(parts),
                                       parts, dtype)
    form = getattr(ham, "inner", ham)
    calls = {"factor_matmul": 0, "perm_gather": 0}
    real = (kernels.factor_matmul, kernels.perm_gather)

    def gemm(x, a, **kw):
        planes = 1
        if x.is_complex():
            planes = (1 if a.dim() == 2 else 2) + 2 * a.is_complex()
        calls["factor_matmul"] += planes
        return real[0](x, a, **kw)

    def gather(*args, **kw):
        calls["perm_gather"] += 1
        return real[1](*args, **kw)
    kernels.factor_matmul, kernels.perm_gather = gemm, gather
    try:
        form.matvec(torch.ones(form.dim, dtype=form.dtype))
    finally:
        kernels.factor_matmul, kernels.perm_gather = real
    per = chip_smoke.form_launches(form)
    assert calls == {"factor_matmul": sum(n for k, n in per.items()
                                          if k != "cross term"),
                     "perm_gather": per.get("cross term", 0)}


def _card_like_launches():
    """Wrappers that count launches as the card's do (a complex
    state's factor_matmul as its planes), around the plain versions.  A
    test that installs them puts the counts back when it ends, since
    other tests read them."""
    real = (kernels.factor_matmul, kernels.perm_gather)

    def gemm(x, a, **kw):
        planes = 1
        if x.is_complex():
            planes = (1 if a.dim() == 2 else 2) + 2 * a.is_complex()
        for _ in range(planes):
            kernels._launched("factor_matmul", "f64")
        return real[0](x, a, **kw)

    def gather(*args, **kw):
        kernels._launched("perm_gather", "f64")
        return real[1](*args, **kw)
    return real, (gemm, gather)


@pytest.mark.parametrize("text", [
    chip_smoke.tj_ring_text(8, 3, 3),
    chip_smoke.heisenberg_ring_text(10),
    chip_smoke.rashba_ring_text(5, 5),
    chip_smoke.kitaev_ring_text(8),
], ids=["tj", "heisenberg", "rashba_complex", "kitaev"])
def test_launches_by_site_measures_each_form(text):
    """Counted at their call sites over two applies, a factored form's
    launches split by form as form_launches predicts for each, and the
    applies are counted apart from the launches."""
    inp = parse_input(chip_smoke.factored(text))
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    dtype = torch.complex128 if "useComplex" in text else torch.float64
    ham = factored_hamiltonian_or_none(model, model.create_basis(parts),
                                       parts, dtype)
    form = getattr(ham, "inner", ham)
    real, fakes = _card_like_launches()
    counts = dict(kernels.FORM_LAUNCHES)
    kernels.factor_matmul, kernels.perm_gather = fakes
    try:
        with chip_smoke.launches_by_site() as (forms, applies):
            for _ in range(2):
                ham.matvec(torch.ones(ham.dim, dtype=ham.dtype))
        assert (kernels.factor_matmul, kernels.perm_gather) == fakes
    finally:
        kernels.factor_matmul, kernels.perm_gather = real
        kernels.FORM_LAUNCHES.clear()
        kernels.FORM_LAUNCHES.update(counts)
    site = "blockkron" if hasattr(form, "shapes") else "kitaev"
    assert applies[site] == 2
    want = {k: 2 * n for k, n in chip_smoke.form_launches(form).items() if n}
    assert {k: n for k, n in forms.items() if n} == want


@pytest.mark.parametrize("max_bytes", [0, 2000], ids=["gather", "mixed"])
def test_launches_by_site_one_spin_forms(max_bytes):
    """A one-spin apply's spin_hop counts as 'one-spin hop', one launch
    for the factors in gather form, a dense factor as 'one-spin
    dense'."""
    inp = parse_input(chip_smoke.hubbard_chain_text(6, 4, 3, 2))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    ham = model.hamiltonian(basis, dtype=torch.float64,
                            device="cpu").densify_factors(max_bytes)
    f = ham.factorized
    real, fakes = _card_like_launches()
    real_hop = kernels.spin_hop

    def hop(*args, **kw):
        kernels._launched("spin_hop", "f64")
        return real_hop(*args, **kw)
    counts = dict(kernels.FORM_LAUNCHES)
    kernels.factor_matmul, kernels.perm_gather = fakes
    kernels.spin_hop = hop
    try:
        with chip_smoke.launches_by_site() as (forms, applies):
            ham.matvec(torch.ones(ham.dim, dtype=torch.float64))
    finally:
        kernels.factor_matmul, kernels.perm_gather = real
        kernels.spin_hop = real_hop
        kernels.FORM_LAUNCHES.clear()
        kernels.FORM_LAUNCHES.update(counts)
    assert applies == {"one-spin": 1}
    assert (f.up_dense is None, f.dn_dense is None) == (
        (True, True) if max_bytes == 0 else (True, False))
    want = {"one-spin hop": 1}
    if f.dn_dense is not None:
        want["one-spin dense"] = 1
    assert {k: n for k, n in forms.items() if n} == want


def test_run_tool_and_beta_schedule(tmp_path, monkeypatch):
    """chip_smoke.run_tool runs a CLI on an input text in a directory of
    its own and hands back what it wrote (.comb files read); the schedule
    text gives the ed schedule's beta grid."""
    from lanczosplusplus_tpu_torch.cli import ed_main, lanczos_main
    from test_torch_host import INPUT0
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.chdir(tmp_path)
    engine, out, _, files, wall = chip_smoke.run_tool(
        lanczos_main, INPUT0 + "TSPSites 2 1 1\nKPMMoments=64\n",
        ["-g", "c", "--kpm"], "cpu")
    assert sorted(files) == ["input.inp0.comb", "input.inp0.kpmdos"]
    assert len(files["input.inp0.comb"].items) == 2
    assert "Energy=" in out and wall > 0 and engine.basis.size == 36
    assert not list(tmp_path.iterdir())
    res, out, _, _, _ = chip_smoke.run_tool(
        ed_main, INPUT0 + chip_smoke.beta_schedule((0.5, 20.0, 4)), [],
        "cpu")
    betas = [float(line.split()[0]) for line in out.splitlines()[2:]]
    np.testing.assert_allclose(betas, [0.5, 7.0, 13.5, 20.0])


def test_tridiagonal_moments_are_the_chebyshev_moments():
    """chip_smoke.tridiagonal_moments: the moments of a continued
    fraction's tridiagonal are those of its start vector for k < 2m
    (here to 1e-12 of mu_0: the recurrences are exact in that range)."""
    from lanczosplusplus_tpu_torch.engine.kpm import (chebyshev_moments,
                                                      spectral_bounds)
    from lanczosplusplus_tpu_torch.engine.spectral import ContinuedFraction
    from lanczosplusplus_tpu_torch.solver import lanczos as lz
    inp = parse_input(chip_smoke.hubbard_chain_text(6, 4))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis((3, 3)))
    phi = lz.random_start_vector(ham.dim, 3, torch.float64, "cpu") * 0.7
    res = lz.tridiagonalize(ham, phi, 30)
    cf = ContinuedFraction(alphas=res.alphas, betas=res.betas, e0=0.0,
                           weight=0.49, sigma=1)
    got = chebyshev_moments(ham, phi, 60, bounds=spectral_bounds(ham))
    want = chip_smoke.tridiagonal_moments(cf, got.a, got.b, 60)
    assert np.abs(got.moments - want).max() <= 1e-12 * got.moments[0]


@pytest.mark.parametrize("nsite,u", [(6, 4), (14, 4)])
def test_ainur_text_is_the_legacy_input(nsite, u):
    ainur = chip_smoke.ainur_text(nsite, u)
    assert ainur.startswith("##Ainur")
    assert parse_input(ainur).entries == parse_input(
        chip_smoke.hubbard_chain_text(nsite, u)).entries


def test_native_calls_and_numpy_host_paths():
    """The counter sees the native entry points a basis build calls, and
    inside numpy_host_paths none is taken (and the words are the same);
    both restore the module."""
    from lanczosplusplus_tpu_torch import native
    from lanczosplusplus_tpu_torch.core.basis import OneSpinBasis
    saved = (native.load, native.enumerate_combinations)
    with chip_smoke.native_calls() as calls:
        words = OneSpinBasis(19, 9).words
        with chip_smoke.numpy_host_paths():
            words_np = OneSpinBasis(19, 9).words
    assert calls == {"enumerate_combinations": 1}
    np.testing.assert_array_equal(words, words_np)
    assert (native.load, native.enumerate_combinations) == saved
