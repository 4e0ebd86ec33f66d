"""The port's hand-written CUDA kernels on the card, held against their
plain PyTorch versions, and the port's solve on the card held against the
same solve on the CPU.  Marked ``cuda``: without a card every test skips.
This file imports no jax, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.solver import lanczos as lz

pytestmark = pytest.mark.cuda

# 6-site open SuperHubbardExtended chain (dim 400): hopping, n_i n_j, J
SUPER6 = """
TotalNumberOfSites=6
NumberOfTerms=3
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 0.7
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 1.3
Model=SuperHubbardExtended
hubbardU 6 2 2 2 2 2 2
potentialV 12 0.1 -0.2 0.3 0 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=3
TargetElectronsDown=3
IsPeriodicX=0
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m,n,k", [(300, 123, 257), (64, 64, 16),
                                   (1, 70, 5), (129, 1, 300)])
def test_factor_matmul_kernel(cuda, dtype, tol, m, n, k):
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    a = torch.randn(n, k, generator=g, device=cuda, dtype=dtype)
    before = kernels.LAUNCHES["factor_matmul"]
    got = kernels.factor_matmul(x, a)
    assert kernels.LAUNCHES["factor_matmul"] == before + 1
    assert _rel(got, kernels.factor_matmul_ref(x, a)) <= tol
    # accumulate through transposed views of every operand
    y0 = torch.randn(n, m, generator=g, device=cuda, dtype=dtype)
    y = y0.clone()
    kernels.factor_matmul(x.T.contiguous().T, a, out=y.T, accumulate=True)
    assert _rel(y, y0 + a @ x.T) <= tol
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_ell_spmv_kernel(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    dim, k = 5003, 7
    diag = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    cols = torch.randint(0, dim, (dim, k), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(dim, k, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    before = kernels.LAUNCHES["ell_spmv"]
    got = kernels.ell_spmv(diag, cols, vals, x)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert _rel(got, kernels.ell_spmv_ref(diag, cols, vals, x)) <= tol
    torch.cuda.synchronize()


def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(8, 4, device=cuda, dtype=torch.complex128)
    with pytest.raises(TypeError):
        kernels.factor_matmul(z, z)
    with pytest.raises(TypeError):
        kernels.factor_matmul(torch.zeros(8, 4, device=cuda),
                              torch.zeros(4, 4, device=cuda,
                                          dtype=torch.float64))
    x = torch.zeros(8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="overlaps"):
        kernels.factor_matmul(x, x, out=x, accumulate=True)
    cols = torch.zeros(8, 2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.ell_spmv(z[:, 0], cols, z[:, :2], z[:, 0])
    v = torch.zeros(16, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ell_spmv(v[::2, 0], cols, v[::2], v[::2, 1])


def test_gather_form_on_card_raises(cuda):
    """A one-spin factor that cannot be densified is refused on the card,
    never applied by plain PyTorch there."""
    inp = parse_input(SUPER6)
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        ham.densify_factors(max_bytes=0)
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        ham.matvec(torch.zeros(ham.dim, dtype=torch.float64, device=cuda))
    assert ham.densify_factors().factorized.up_dense is not None


def test_solve_on_card_matches_cpu(cuda):
    """The densified kernel path on the card gives the CPU gather path's
    matvec and ground energy from the same start vector."""
    inp = parse_input(SUPER6)
    model = build_model(inp, Geometry(inp))
    v0 = np.random.default_rng(0).standard_normal(400)
    cpu = Engine(model, inp, config=Config(device="cpu"), v0=v0)
    kernels.reset_launches()
    gpu = Engine(model, inp, config=Config(device=cuda), v0=v0)
    assert gpu.hamiltonian.factorized.up_dense is not None
    assert kernels.LAUNCHES["factor_matmul"] > 0
    assert kernels.LAUNCHES["ell_spmv"] > 0
    x = torch.from_numpy(v0)
    np.testing.assert_allclose(
        gpu.hamiltonian.matvec(x.to(cuda)).cpu().numpy(),
        cpu.hamiltonian.matvec(x).numpy(), rtol=0, atol=1e-12)
    assert abs(gpu.ground_energy - cpu.ground_energy) <= \
        1e-10 * abs(cpu.ground_energy)
    evals, vecs = lz.lowest_states(gpu.hamiltonian, v0=v0,
                                   krylov_budget_bytes=1024)
    assert vecs.device.type == "cuda"
    assert abs(evals[0] - cpu.ground_energy) <= 1e-10 * abs(evals[0])
