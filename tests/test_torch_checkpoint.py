"""Checkpointed, resumable Lanczos and the low-precision Krylov basis
(``solver/lanczos.tridiagonalize(checkpoint=, chunk=, reorth_dtype=)``)
held against the JAX package on the CPU: the cases of
tests/test_checkpoint.py on the port, the same ``.npz`` keys and resume
rule (a checkpoint the JAX package wrote resumes in the port), and the
tridiagonal from one numpy start vector against the JAX run's to 1e-10.
A resumed run restores the basis, the vector and the selective
recurrence's state exactly, so on one device it is bit-equal to an
uninterrupted one."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.solver import lanczos as jlz
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_host import hubbard_chain_text

torch.set_num_threads(2)

TEXT = hubbard_chain_text(8)


def build_ham(dtype=torch.float64):
    """tests/test_checkpoint.py's 8-site U = 4 ring, (4, 4) sector."""
    inp = parse_input(TEXT)
    model = build_model(inp, Geometry(inp))
    return model.hamiltonian(model.create_basis((4, 4)), dtype=dtype)


def build_jax_ham(dtype=np.float64):
    inp = jax_parse(TEXT)
    model = jax_build_model(inp, JaxGeometry(inp))
    return model.hamiltonian(model.create_basis((4, 4)), dtype=dtype)


def start(dim, seed, dtype=torch.float64):
    v = np.random.default_rng(seed).standard_normal(dim)
    return torch.from_numpy(v / np.linalg.norm(v)).to(dtype)


class Interrupt(Exception):
    pass


def interrupted_after(monkeypatch, chunks):
    """Make the chunk runner raise once `chunks` chunks have run."""
    calls = {"n": 0}
    orig = lz._lanczos_chunk

    def limited(*args, **kwargs):
        if calls["n"] >= chunks:
            raise Interrupt
        calls["n"] += 1
        return orig(*args, **kwargs)
    monkeypatch.setattr(lz, "_lanczos_chunk", limited)


def test_checkpoint_resume_identical(tmp_path):
    ham = build_ham()
    v0 = start(ham.dim, 123)
    ref = lz.tridiagonalize(ham, v0, 60)
    ck = str(tmp_path / "lz.npz")
    # the start vector as tridiagonalize normalizes it
    lz._lanczos_scan(ham, lz._normalized(ham, v0), 60, checkpoint=ck,
                     chunk=13)
    res = lz.tridiagonalize(ham, v0, 60, checkpoint=ck, chunk=13)
    assert np.array_equal(res.alphas, ref.alphas)
    assert np.array_equal(res.betas, ref.betas)


@pytest.mark.parametrize("reorth", ["selective", "full"])
def test_checkpoint_partial_then_resume(tmp_path, monkeypatch, reorth):
    """Interrupted after two chunks, resumed from the file: equal to an
    uninterrupted run bit for bit, basis and all."""
    ham = build_ham()
    v0 = start(ham.dim, 5)
    ck = str(tmp_path / "lz2.npz")
    with monkeypatch.context() as m:
        interrupted_after(m, 2)
        with pytest.raises(Interrupt):
            lz.tridiagonalize(ham, v0, 60, checkpoint=ck, chunk=10,
                              reorth=reorth)
    saved = np.load(ck)
    assert int(saved["next_step"]) == 20 and str(saved["mode"]) == reorth
    res = lz.tridiagonalize(ham, v0, 60, checkpoint=ck, chunk=10,
                            reorth=reorth)
    ref = lz.tridiagonalize(ham, v0, 60, reorth=reorth)
    assert np.array_equal(res.alphas, ref.alphas)
    assert np.array_equal(res.betas, ref.betas)
    assert torch.equal(res.V, ref.V)


def test_default_chunk_is_an_eighth(tmp_path, monkeypatch):
    ham = build_ham()
    ck = str(tmp_path / "lz3.npz")
    with monkeypatch.context() as m:
        interrupted_after(m, 1)
        with pytest.raises(Interrupt):
            lz.tridiagonalize(ham, start(ham.dim, 2), 64, checkpoint=ck)
    assert int(np.load(ck)["next_step"]) == 8


def test_resume_rule_steps_dim_mode(tmp_path):
    """A checkpoint resumes only a run of its steps, dim and mode; any
    other run starts afresh (and overwrites it)."""
    ham = build_ham()
    v0 = start(ham.dim, 9)
    ck = str(tmp_path / "lz4.npz")
    lz.tridiagonalize(ham, v0, 40, checkpoint=ck, chunk=10)
    for steps, reorth in ((30, "selective"), (40, "full")):
        res = lz.tridiagonalize(ham, v0, steps, checkpoint=ck, chunk=10,
                                reorth=reorth)
        ref = lz.tridiagonalize(ham, v0, steps, reorth=reorth)
        assert np.array_equal(res.alphas, ref.alphas)
    assert str(np.load(ck)["mode"]) == "full"


def test_npz_keys_match_jax_and_a_jax_checkpoint_resumes(tmp_path,
                                                         monkeypatch):
    """The port writes the JAX package's keys, and resumes a checkpoint the
    JAX package wrote after two chunks (its selective state included) to
    the port's own uninterrupted tridiagonal, 1e-10; the uninterrupted
    runs of both packages agree to 1e-10."""
    ham, jham = build_ham(), build_jax_ham()
    v0 = start(ham.dim, 21)
    ck_port, ck_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lz.tridiagonalize(ham, v0, 50, checkpoint=ck_port, chunk=10)
    jlz._lanczos_scan(jham, v0.numpy(), 50, checkpoint=ck_jax, chunk=10)
    assert sorted(np.load(ck_port).files) == sorted(np.load(ck_jax).files)

    jref = jlz.tridiagonalize(jham, v0.numpy(), 50)
    calls = {"n": 0}
    orig = jlz._lanczos_chunk_selective

    def limited(*args):
        if calls["n"] >= 2:
            raise Interrupt
        calls["n"] += 1
        return orig(*args)
    ck = str(tmp_path / "from_jax.npz")
    with monkeypatch.context() as m:
        m.setattr(jlz, "_lanczos_chunk_selective", limited)
        with pytest.raises(Interrupt):
            jlz._lanczos_scan(jham, v0.numpy(), 50, checkpoint=ck, chunk=10)
    assert int(np.load(ck)["next_step"]) == 20
    res = lz.tridiagonalize(ham, v0, 50, checkpoint=ck, chunk=10)
    ref = lz.tridiagonalize(ham, v0, 50)
    np.testing.assert_allclose(res.alphas, ref.alphas, atol=1e-10)
    np.testing.assert_allclose(res.betas, ref.betas, atol=1e-10)
    np.testing.assert_allclose(ref.alphas, jref.alphas, atol=1e-10)
    np.testing.assert_allclose(ref.betas, jref.betas, atol=1e-10)


def test_adaptive_convergence_extends_steps():
    """With a tiny first step budget the solve extends its steps until the
    Ritz residual converges, to the energy of a 200-step solve."""
    ham = build_ham()
    evals, _, info = lz.lowest_states(ham, num_states=1, max_steps=30,
                                      return_info=True, dense_fallback_dim=0)
    assert info.steps > 30 and info.converged
    assert evals[0] == pytest.approx(lz.lowest_states(ham)[0][0], abs=1e-8)


def test_bf16_krylov_basis_accuracy():
    """A bfloat16 basis: the lowest Ritz value within 2e-3 (relative) of
    the float32 run's (tests/test_checkpoint.py), the JAX package's bf16
    run's within the same bar, the Ritz vectors in the compute type."""
    import jax.numpy as jnp
    ham = build_ham(torch.float32)
    v0 = start(ham.dim, 11, torch.float32)
    res32 = lz.tridiagonalize(ham, v0, 80)
    res16 = lz.tridiagonalize(ham, v0, 80, reorth_dtype=torch.bfloat16)
    assert res16.V.dtype == torch.bfloat16
    e32 = lz.tridiag_eigh(res32.alphas, res32.betas)[0][0]
    e16 = lz.tridiag_eigh(res16.alphas, res16.betas)[0][0]
    assert abs(e32 - e16) / abs(e32) < 2e-3
    jres = jlz.tridiagonalize(build_jax_ham(np.float32),
                              jnp.asarray(v0.numpy()), 80,
                              reorth_dtype=jnp.bfloat16)
    je16 = jlz.tridiag_eigh(jres.alphas, jres.betas)[0][0]
    assert abs(je16 - e16) / abs(e32) < 2e-3
    vec = lz.ritz_vectors(res16, np.ones((res16.m, 1)))
    assert vec.dtype == torch.float32


def test_reorth_pass_below_the_compute_type_chunks(monkeypatch):
    """The two GEMVs against a bf16 basis widen it a column chunk at a
    time: the same result with chunks of a few columns as in one piece,
    in the compute type."""
    g = torch.Generator().manual_seed(4)
    V = torch.randn(6, 1000, generator=g).to(torch.bfloat16)
    w = torch.randn(1000, generator=g)
    whole = lz._reorth_pass(V, w)
    monkeypatch.setattr(lz, "WIDEN_CHUNK_ELEMENTS", 6 * 37)
    assert len(lz._column_chunks(V)) == 28
    chunked = lz._reorth_pass(V, w)
    assert chunked.dtype == torch.float32
    assert torch.allclose(chunked, whole, rtol=0, atol=1e-5)


def test_bf16_basis_checkpoint_resumes(tmp_path, monkeypatch):
    """A bf16 basis is saved widened to float32 (exactly) and restored
    bit for bit."""
    ham = build_ham(torch.float32)
    v0 = start(ham.dim, 13, torch.float32)
    ck = str(tmp_path / "bf16.npz")
    with monkeypatch.context() as m:
        interrupted_after(m, 2)
        with pytest.raises(Interrupt):
            lz.tridiagonalize(ham, v0, 48, checkpoint=ck, chunk=12,
                              reorth_dtype=torch.bfloat16)
    res = lz.tridiagonalize(ham, v0, 48, checkpoint=ck, chunk=12,
                            reorth_dtype=torch.bfloat16)
    ref = lz.tridiagonalize(ham, v0, 48, reorth_dtype=torch.bfloat16)
    assert np.array_equal(res.alphas, ref.alphas)
    assert torch.equal(res.V, ref.V)


def test_selective_reorth_accuracy_and_sparsity():
    ham = build_ham()
    v0 = start(ham.dim, 123)
    V, a, b, nre = lz._lanczos_scan(ham, v0, 120, reorth="selective")
    dense = np.linalg.eigvalsh(ham.to_dense())[:4]
    es = lz.tridiag_eigh(np.asarray(a), np.asarray(b))[0][:4]
    np.testing.assert_allclose(es, dense, atol=1e-10)
    assert 0 < nre < 120 // 3, f"reorth on {nre}/120 steps"
    G = (V @ V.T).numpy()
    assert np.abs(G - np.eye(120)).max() < 1e-10


def test_selective_reorth_checkpoint_resume(tmp_path):
    ham = build_ham()
    v0 = start(ham.dim, 9)
    ref = lz.tridiagonalize(ham, v0, 60)
    ck = str(tmp_path / "sel.npz")
    lz._lanczos_scan(ham, v0, 60, checkpoint=ck, chunk=17)
    res = lz.tridiagonalize(ham, v0, 60, checkpoint=ck, chunk=17)
    np.testing.assert_allclose(res.alphas, ref.alphas, atol=1e-9)
    np.testing.assert_allclose(res.betas, ref.betas, atol=1e-9)
