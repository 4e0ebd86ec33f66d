"""The port's kernel polynomial method (engine/kpm.py) and
Engine.kpm_local_dos held against the JAX package's on the CPU, and
against dense oracles.  Tolerances: moments to 1e-10 of mu_0 against the
JAX package's and against Tr T_k of the dense spectrum (the Chebyshev
recurrence is stable, |T_k| <= 1); densities to 1e-10 of their maximum
where both packages get the same bounds, and to 1e-8 where each draws its
own start vector for spectral_bounds (a sector of dim <= 64, where the 64
plain Lanczos steps reach the extreme eigenvalues to rounding)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.engine import kpm as jkpm
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.engine import kpm as tkpm
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from test_torch_ftlm import jax_block, sector
from test_torch_host import INPUT0, hubbard_chain_text
from test_torch_inputs import heisenberg_text, rashba_text, tj_text

torch.set_num_threads(2)


def dense_trace_moments(dense, n, emin, emax):
    """Tr T_k(Ht) from the dense spectrum."""
    evals = np.linalg.eigvalsh(dense)
    a, b = 0.5 * (emax - emin), 0.5 * (emax + emin)
    theta = np.arccos(np.clip((evals - b) / a, -1, 1))
    return np.asarray([np.cos(k * theta).sum() for k in range(n)])


def test_jackson_kernel_equal():
    np.testing.assert_array_equal(tkpm.jackson_kernel(64),
                                  jkpm.jackson_kernel(64))


def test_kpm_dos_moments_are_the_dense_trace():
    """kpm_dos with a complete orthonormal start set: the moments are
    Tr T_k(Ht) of the dense spectrum."""
    ham, _, _, basis = sector(hubbard_chain_text(6, periodic=False))
    dense = ham.to_dense()
    evals = np.linalg.eigvalsh(dense)
    bounds = (evals[0] - 0.5, evals[-1] + 0.5)
    res = tkpm.kpm_dos(ham, num_moments=80, bounds=bounds,
                       start_vectors=np.eye(basis.size))
    exact = dense_trace_moments(dense, 80, *bounds)
    assert np.abs(res.moments - exact).max() <= 1e-10 * basis.size


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_chebyshev_moments_match_jax(dtype):
    """Moments of one block and its density, both packages given the same
    bounds; the port's own spectral_bounds enclose the spectrum."""
    text = hubbard_chain_text(6, periodic=False) if not dtype.is_complex \
        else rashba_text(5, 4, periodic=1)
    ham, jham, _, basis = sector(text, dtype=dtype)
    evals = np.linalg.eigvalsh(ham.to_dense())
    lo, hi = tkpm.spectral_bounds(ham)
    assert lo < evals[0] and hi > evals[-1]
    V = jax_block(basis.size, 3, 17, dtype)
    res = tkpm.chebyshev_moments(ham, V, 101, bounds=(lo, hi))
    jres = jkpm.chebyshev_moments(jham, jnp.asarray(V), 101,
                                  bounds=(lo, hi))
    assert len(res.moments) == 101
    assert np.abs(res.moments - jres.moments).max() <= \
        1e-10 * jres.moments[0]
    grid = np.linspace(lo, hi, 301)
    want = jres.density(grid)
    assert np.abs(res.density(grid) - want).max() <= 1e-10 * want.max()
    # one vector, (dim,)
    one = tkpm.chebyshev_moments(ham, V[:, 0], 20, bounds=(lo, hi))
    jone = jkpm.chebyshev_moments(jham, jnp.asarray(V[:, 0]), 20,
                                  bounds=(lo, hi))
    assert np.abs(one.moments - jone.moments).max() <= 1e-10


def test_moment_bound_guard_raises_in_both():
    """Bounds that do not enclose the spectrum: |mu_k| outgrows 2 mu_0 and
    both packages raise."""
    ham, jham, _, basis = sector(hubbard_chain_text(6, periodic=False))
    V = jax_block(basis.size, 2, 1, torch.float64)
    narrow = (-1.0, 1.0)
    with pytest.raises(ValueError, match="do not enclose"):
        tkpm.chebyshev_moments(ham, V, 64, bounds=narrow)
    with pytest.raises(ValueError, match="do not enclose"):
        jkpm.chebyshev_moments(jham, jnp.asarray(V), 64, bounds=narrow)


def test_kpm_dos_matches_jax_and_inner_branch():
    """kpm_dos from the JAX block, and a factored t-J sector
    (PermutedHamiltonian) whose flat-order block is converted and run in
    inner order: the trace of the flat form."""
    text = tj_text(6, 2, 2, j=0.4, w=0.3, periodic=1)
    ham, jham, model, basis = sector(text)
    form = factored_hamiltonian_or_none(model, basis, basis.parts,
                                        torch.float64)
    assert type(form).__name__ == "PermutedHamiltonian"
    V = jax_block(basis.size, 4, 23, torch.float64)
    bounds = (-8.0, 8.0)
    flat = tkpm.kpm_dos(ham, 64, bounds=bounds, start_vectors=V)
    inner = tkpm.kpm_dos(form, 64, bounds=bounds, start_vectors=V)
    jres = jkpm.chebyshev_moments(jham, jnp.asarray(V), 64, bounds=bounds)
    want = jres.moments * basis.size / 4
    for got in (flat.moments, inner.moments):
        assert np.abs(got - want).max() <= 1e-10 * want[0]


def test_kpm_spectral_matches_jax():
    ham, jham, _, basis = sector(hubbard_chain_text(6, periodic=False))
    phi = jax_block(basis.size, 1, 29, torch.float64)[:, 0]
    evals = np.linalg.eigvalsh(ham.to_dense())
    bounds = (evals[0] - 1.0, evals[-1] + 1.0)
    omegas = np.linspace(-3.0, 12.0, 151)
    got = tkpm.kpm_spectral(ham, phi, omegas, -2.0, num_moments=128,
                            bounds=bounds, weight=0.7)
    want = jkpm.kpm_spectral(jham, jnp.asarray(phi), omegas, -2.0,
                             num_moments=128, bounds=bounds, weight=0.7)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("op_name,text", [
    ("c", INPUT0),
    ("sz", heisenberg_text(6, 1, 3)),
    ("splus", heisenberg_text(6, 1, 3))], ids=["c", "sz", "splus"])
def test_engine_kpm_local_dos_matches_jax(op_name, text):
    """Engine.kpm_local_dos of a fermionic and two spin operators (the
    non-fermionic removal branch carries the negative sign) against the
    JAX Engine's: every destination sector has dim <= 64, so both
    packages' bounds are the extreme eigenvalues to rounding."""
    inp, jinp = parse_input(text), jax_parse(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device="cpu"))
    jengine = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)), jinp)
    omegas = np.linspace(-8.0, 8.0, 161)
    got = engine.kpm_local_dos(op_name, 1, omegas, num_moments=96)
    want = jengine.kpm_local_dos(op_name, 1, omegas, num_moments=96)
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
