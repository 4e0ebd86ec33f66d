"""The port's hand-written CUDA kernels on the card, held against their
plain PyTorch versions, for single operands and for batches, and the
port's solve, spectral functions and correlators on the card held against
the same on the CPU.  Marked ``cuda``: without a card every test skips.
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


def _strided(g, rows, cols, layout, cuda):
    """A float64 (rows, cols) operand: 'k' has the second axis contiguous,
    'm' the first, 'k+1'/'m+1' the same behind a base pointer that is 8
    but not 16 bytes aligned (a [1:] slice of the storage), 'none' has
    neither axis contiguous."""
    if layout == "none":
        return torch.randn(2 * rows, 2 * cols, generator=g, device=cuda,
                           dtype=torch.float64)[::2, ::2]
    shape = (rows, cols) if layout[0] == "k" else (cols, rows)
    off = int(layout.endswith("+1"))
    flat = torch.randn(rows * cols + off, generator=g, device=cuda,
                       dtype=torch.float64)[off:]
    t = flat.view(shape)
    return t if layout[0] == "k" else t.T


# shapes that cross every edge of the 128- and 64-wide tiles and of the
# 16-deep k slices: k not a multiple of 16 (and odd), m and n not multiples
# of the tile, one row, one column, enough 128-tiles to take the large tile
@pytest.mark.parametrize("m,n,k", [(200, 136, 40), (130, 70, 33),
                                   (1, 200, 50), (70, 1, 18),
                                   (1500, 1410, 24), (1411, 1500, 17)])
@pytest.mark.parametrize("xl,al,yl", [("k", "k", "k"), ("m", "k", "m"),
                                      ("k+1", "m", "k+1"),
                                      ("m+1", "k+1", "m"),
                                      ("none", "none", "none"),
                                      ("m", "m", "k")])
@pytest.mark.parametrize("accumulate", [False, True])
def test_factor_matmul_f64_edges(cuda, m, n, k, xl, al, yl, accumulate):
    """Every staging path of the tensor-core kernel (k-major and row-major,
    16- and 8-byte copies, both store widths, both tile sizes) agrees with
    the plain version, and writes nothing outside its output."""
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    x = _strided(g, m, k, xl, cuda)
    a = _strided(g, n, k, al, cuda)
    y = _strided(g, m, n, yl, cuda)
    assert x.shape == (m, k) and a.shape == (n, k) and y.shape == (m, n)
    plan = kernels.factor_matmul_plan(
        x.data_ptr(), x.stride(), a.data_ptr(), a.stride(), y.data_ptr(),
        y.stride(), m, n)
    assert plan.tile == (128 if m > 1400 else 64)
    assert plan.x_vec16 == (xl in ("k", "m") and (k if xl == "k" else m)
                            % 2 == 0)
    y0 = y.clone()
    ref = kernels.factor_matmul_ref(x, a) + (y0 if accumulate else 0)
    kernels.factor_matmul(x, a, out=y, accumulate=accumulate)
    torch.cuda.synchronize()
    assert _rel(y, ref) <= 1e-12


def test_factor_matmul_f64_leaves_neighbours(cuda):
    """A ragged product into the middle of a larger buffer changes only
    its own block."""
    g = torch.Generator(device=cuda).manual_seed(5)
    big = torch.zeros(300, 300, device=cuda, dtype=torch.float64)
    x = torch.randn(131, 77, generator=g, device=cuda, dtype=torch.float64)
    a = torch.randn(67, 77, generator=g, device=cuda, dtype=torch.float64)
    kernels.factor_matmul(x, a, out=big[10:141, 20:87])
    torch.cuda.synchronize()
    ref = torch.zeros_like(big)
    ref[10:141, 20:87] = x @ a.T
    assert (big - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
    assert (big[:10] == 0).all() and (big[141:] == 0).all()
    assert (big[:, :20] == 0).all() and (big[:, 87:] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("dim,k", [(5003, 7), (1000, 1), (257, 12), (1, 3)])
@pytest.mark.parametrize("layout", ["k_major", "contiguous"])
def test_ell_spmv_kernel(cuda, dtype, tol, dim, k, layout):
    g = torch.Generator(device=cuda).manual_seed(1)
    diag = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    cols = torch.randint(0, dim, (dim, k), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(dim, k, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    ref = kernels.ell_spmv_ref(diag, cols, vals, x)
    before = kernels.LAUNCHES["ell_spmv"]
    if layout == "k_major":
        cols, vals = cols.T.contiguous().T, vals.T.contiguous().T
    if not cols.is_contiguous():
        # the port keeps the contiguous layout alone: a K-major view (one
        # that is not contiguous too, as with dim or K of 1) is refused
        # before the launch
        with pytest.raises(ValueError, match="contiguous"):
            kernels.ell_spmv(diag, cols, vals, x)
        assert kernels.LAUNCHES["ell_spmv"] == before
        return
    got = kernels.ell_spmv(diag, cols, vals, x)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert _rel(got, ref) <= tol
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("dim,k", [(5003, 7), (1000, 1), (257, 12),
                                   (300, 16), (301, 17), (64, 40)])
@pytest.mark.parametrize("rows", [1, 3, 14])
def test_ell_spmv_batched_kernel(cuda, dtype, tol, dim, k, rows):
    """One launch for a batch-major block, rows that stay in registers
    (K <= 16) and rows that are re-read per member (K > 16); every member
    equals its own single launch bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(dim + k + rows)
    diag = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    cols = torch.randint(0, dim, (dim, k), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(dim, k, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(rows, dim, generator=g, device=cuda, dtype=dtype)
    before = kernels.LAUNCHES["ell_spmv"]
    got = kernels.ell_spmv(diag, cols, vals, x)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert got.shape == x.shape
    assert _rel(got, kernels.ell_spmv_ref(diag, cols, vals, x)) <= tol
    for b in {0, rows - 1}:
        assert torch.equal(got[b], kernels.ell_spmv(diag, cols, vals, x[b]))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("rows,szd,szu", [(1, 70, 33), (3, 300, 257),
                                          (5, 130, 64), (14, 56, 70),
                                          (2, 1411, 150)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_factor_matmul_batched_kernel(cuda, dtype, tol, rows, szd, szu,
                                      accumulate):
    """The two forms of the batched apply on a block of states
    (rows, szd, szu), ragged and with odd szu: the up product with the
    batch folded into its rows, and the dn product as one launch over
    transposed views of every state."""
    g = torch.Generator(device=cuda).manual_seed(rows * szd + szu)
    x = torch.randn(rows, szd, szu, generator=g, device=cuda, dtype=dtype)
    a_up = torch.randn(szu, szu, generator=g, device=cuda, dtype=dtype)
    a_dn = torch.randn(szd, szd, generator=g, device=cuda, dtype=dtype)
    y0 = torch.randn(rows, szd, szu, generator=g, device=cuda, dtype=dtype)
    keep = y0 if accumulate else 0
    before = kernels.LAUNCHES["factor_matmul"]
    y = y0.clone()
    kernels.factor_matmul(x.view(-1, szu), a_up, out=y.view(-1, szu),
                          accumulate=accumulate)
    assert _rel(y, keep + x @ a_up.T) <= tol
    y = y0.clone()
    kernels.factor_matmul(x.transpose(1, 2), a_dn, out=y.transpose(1, 2),
                          accumulate=accumulate)
    assert kernels.LAUNCHES["factor_matmul"] == before + 2
    assert _rel(y, keep + a_dn @ x) <= tol
    # a batched product with its own output, against the members' own
    got = kernels.factor_matmul(x, a_up)
    assert got.shape == (rows, szd, szu)
    for b in {0, rows - 1}:
        assert torch.equal(got[b], kernels.factor_matmul(x[b], a_up))
    torch.cuda.synchronize()


def test_factor_matmul_batched_strides(cuda):
    """Members that are not packed (a batch stride larger than a member,
    and an odd one) and a batch of views into a larger buffer."""
    g = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn(40, 24, generator=g, device=cuda, dtype=torch.float64)
    for stride in (50 * 24, 50 * 24 + 1):
        flat = torch.randn(4 * stride, generator=g, device=cuda,
                           dtype=torch.float64)
        x = flat.as_strided((4, 50, 24), (stride, 24, 1))
        out = torch.zeros(4, 64, 64, device=cuda, dtype=torch.float64)
        kernels.factor_matmul(x, a, out=out[:, 3:53, 10:50])
        torch.cuda.synchronize()
        assert _rel(out[:, 3:53, 10:50], x @ a.T) <= 1e-12
        assert (out[:, :3] == 0).all() and (out[:, 53:] == 0).all()
        assert (out[:, :, :10] == 0).all() and (out[:, :, 50:] == 0).all()


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
        kernels.ell_spmv(z[:, 0].contiguous(), cols,
                         z[:, :2].contiguous(), z[:, 0].contiguous())
    v = torch.zeros(16, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ell_spmv(v[::2, 0], cols, v[::2], v[::2, 1])
    # the same refusals for batched operands
    zb = torch.zeros(3, 8, 4, device=cuda, dtype=torch.complex128)
    with pytest.raises(TypeError):
        kernels.factor_matmul(zb, z[:4])
    xb = torch.zeros(3, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="overlaps"):
        kernels.factor_matmul(xb, x, out=xb, accumulate=True)
    with pytest.raises(ValueError, match="overlaps"):
        kernels.factor_matmul(xb[:2], x, out=xb[1:], accumulate=True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ell_spmv(v[:8, 0].contiguous(), cols, v[:8].contiguous(),
                         torch.zeros(8, 3, device=cuda,
                                     dtype=torch.float64).T)
    before = dict(kernels.LAUNCHES)
    assert kernels.factor_matmul(xb[:0], x).shape == (0, 8, 8)
    assert dict(kernels.LAUNCHES) == before


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


CHAIN6 = """
TotalNumberOfSites=6
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 6 4 4 4 4 4 4
potentialV 12 0 0 0 0 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=3
TargetElectronsDown=3
IsPeriodicX=1
SpectralSteps=300
"""


def _pair(text, cuda):
    """(CPU engine, card engine) on one ground state, the CPU's."""
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    cpu = Engine(model, inp, config=Config(device="cpu"))
    gpu = Engine(model, inp, config=Config(device=cuda),
                 v0=cpu.eigenvector(0).numpy())
    gpu._vectors = cpu._vectors.to(cuda)
    gpu._energies = cpu._energies
    return cpu, gpu


@pytest.mark.parametrize("text", [CHAIN6, SUPER6 + "SpectralSteps=300\n"],
                         ids=["chain6", "super6"])
def test_spectral_functions_on_card_match_cpu(cuda, text):
    """Batched and serial continued fractions through the batched kernels
    against the CPU's plain versions: weights, the first coefficients and
    the evaluated function (odd one-spin sizes: C(6, 2) = C(6, 4) = 15)."""
    cpu, gpu = _pair(text, cuda)
    pairs = [(0, 0), (1, 4), (3, 3), (2, 5)]
    omegas = np.linspace(-8, 8, 81)
    kernels.reset_launches()
    outs = gpu.spectral_functions_batched("c", pairs)
    ell = gpu.hamiltonian.ell is not None
    # two sectors, 300 steps (the sectors' dim): two GEMMs and, with a J
    # term, one ELL launch a step
    assert kernels.LAUNCHES == {"factor_matmul": 2 * 2 * 300,
                                "ell_spmv": 2 * 300 * ell}
    refs = cpu.spectral_functions_batched("c", pairs)
    for (coll, labels), (rcoll, rlabels) in zip(outs, refs):
        assert labels == rlabels
        for cf, rcf in zip(coll.items, rcoll.items):
            assert abs(cf.weight - rcf.weight) <= 1e-12
            np.testing.assert_allclose(cf.alphas[:8], rcf.alphas[:8],
                                       rtol=0, atol=1e-9)
        np.testing.assert_allclose(coll.evaluate(omegas, 0.1),
                                   rcoll.evaluate(omegas, 0.1), rtol=0,
                                   atol=1e-8)
    serial, _ = gpu.spectral_function("c", 1, 4)
    np.testing.assert_allclose(serial.evaluate(omegas, 0.1),
                               refs[1][0].evaluate(omegas, 0.1), rtol=0,
                               atol=1e-8)


def test_observables_on_card_match_cpu(cuda):
    cpu, gpu = _pair(SUPER6, cuda)
    before = dict(kernels.LAUNCHES)
    for op_name in ("n", "sz", "c", "splus"):
        got, ref = gpu.two_point(op_name), cpu.two_point(op_name)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                                   rtol=0, atol=1e-12)
    args = ((2, 4), ("splus", "sminus"), (0, 0), (0, 0))
    assert abs(gpu.many_point(*args) - cpu.many_point(*args)) <= 1e-12
    assert abs(gpu.measure("gs|c'[1];c[3]|gs")
               - cpu.measure("gs|c'[1];c[3]|gs")) <= 1e-12
    from lanczosplusplus_tpu_torch.engine.rdm import ReducedDensityMatrix
    rdm = ReducedDensityMatrix(gpu.basis, gpu.eigenvector(0), 3)
    ref = ReducedDensityMatrix(cpu.basis, cpu.eigenvector(0), 3)
    np.testing.assert_allclose(rdm.rho, ref.rho, rtol=0, atol=1e-12)
    assert dict(kernels.LAUNCHES) == before   # no kernel on these paths


def test_complex_spectral_run_on_card_raises(cuda):
    """The kernels take no complex values: a useComplex spectral run on
    the card says which ROADMAP items hold that, before any launch.  (The
    4-site input is solved densely, so the Engine itself builds.)"""
    text = CHAIN6.replace("TotalNumberOfSites=6", "TotalNumberOfSites=4") \
        .replace("hubbardU 6 4 4 4 4 4 4", "hubbardU 4 4 4 4 4") \
        .replace("potentialV 12 0 0 0 0", "potentialV 8") \
        .replace("TargetElectronsUp=3", "TargetElectronsUp=2") \
        .replace("TargetElectronsDown=3", "TargetElectronsDown=2") \
        .replace("SolverOptions=none", "SolverOptions=useComplex")
    inp = parse_input(text)
    engine = Engine(build_model(inp, Geometry(inp)), inp,
                    config=Config.from_input(inp, device=cuda))
    assert engine.eigenvector(0).dtype == torch.complex128
    before = dict(kernels.LAUNCHES)
    for call in (lambda: engine.spectral_function("c", 0, 0),
                 lambda: engine.spectral_functions_batched("c", [(0, 1)])):
        with pytest.raises(NotImplementedError, match="Queue 2 items 1-2"):
            call()
    assert dict(kernels.LAUNCHES) == before
    z = torch.zeros(2, 36, device=cuda, dtype=torch.complex128)
    with pytest.raises(TypeError):
        engine.hamiltonian.matmat_t(z)
