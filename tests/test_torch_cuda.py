"""The port's hand-written CUDA kernels on the card, held against their
plain PyTorch versions, for single operands and for batches, and the
port's solve, spectral functions and correlators on the card held against
the same on the CPU.  Marked ``cuda``: without a card every test skips.
This file imports no jax, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import re

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
from chip_smoke import hubbard_chain_text
from test_torch_inputs import (INPUT100, feas_so_text, feas_text,
                                heisenberg_text, immm_text, kitaev_text,
                                rashba_text, tj_text)

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


ELL_DTYPES = [(torch.float64, 1e-13), (torch.float32, 1e-5),
              (torch.complex128, 1e-13), (torch.complex64, 1e-5)]


def _random_ell(g, dim, k, dtype, device):
    """A padded (dim, K) ELL with a random half of its entries padding
    (its own row, value 0) and every fifth row padding throughout."""
    diag = torch.randn(dim, generator=g, device=device, dtype=dtype)
    cols = torch.randint(0, dim, (dim, k), generator=g, device=device,
                         dtype=torch.int32)
    vals = torch.randn(dim, k, generator=g, device=device, dtype=dtype)
    pad = torch.rand(dim, k, generator=g, device=device) < 0.5
    pad[::5] = True
    own = torch.arange(dim, device=device, dtype=torch.int32)[:, None]
    cols = torch.where(pad, own.expand(dim, k), cols).contiguous()
    vals = torch.where(pad, torch.zeros_like(vals), vals).contiguous()
    return diag, cols, vals


@pytest.mark.parametrize("dtype,tol", ELL_DTYPES)
@pytest.mark.parametrize("dim,k", [(5003, 7), (1000, 1), (257, 12), (1, 3),
                                   (2003, 48)])
@pytest.mark.parametrize("layout", ["k_major", "contiguous"])
def test_ell_spmv_kernel(cuda, dtype, tol, dim, k, layout):
    """The sliced kernel against the plain version on the padded arrays;
    a K-major view of those arrays (one that is not contiguous too, as
    with dim or K of 1) is refused before the launch, as it always was,
    though the kernel reads only the sliced form."""
    g = torch.Generator(device=cuda).manual_seed(1)
    diag, cols, vals = _random_ell(g, dim, k, dtype, cuda)
    x = torch.randn(dim, generator=g, device=cuda, dtype=dtype)
    ref = kernels.ell_spmv_ref(diag, cols, vals, x)
    sliced = kernels.slice_ell(cols, vals)
    before = kernels.LAUNCHES["ell_spmv"]
    if layout == "k_major":
        cols, vals = cols.T.contiguous().T, vals.T.contiguous().T
    if not cols.is_contiguous():
        with pytest.raises(ValueError, match="contiguous"):
            kernels.ell_spmv(diag, cols, vals, x, sliced=sliced)
        assert kernels.LAUNCHES["ell_spmv"] == before
        return
    got = kernels.ell_spmv(diag, cols, vals, x, sliced=sliced)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert _rel(got, ref) <= tol
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", ELL_DTYPES)
@pytest.mark.parametrize("dim,k", [(5003, 7), (1000, 1), (257, 12),
                                   (300, 16), (301, 17), (64, 40),
                                   (1500, 48), (700, 96), (333, 8),
                                   (334, 9)])
@pytest.mark.parametrize("rows", [1, 3, 14])
def test_ell_spmv_batched_kernel(cuda, dtype, tol, dim, k, rows):
    """One launch for a batch-major block, real and complex, slices that
    stay in registers (at most 16 entries a row, or 8 in complex128) and
    slices that go chunk by chunk (the flat models: K = 48 on a 24-site
    Heisenberg ring, 96 on a 12-site Rashba ring); every member equals
    its own single launch bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(dim + k + rows)
    diag, cols, vals = _random_ell(g, dim, k, dtype, cuda)
    sliced = kernels.slice_ell(cols, vals)
    x = torch.randn(rows, dim, generator=g, device=cuda, dtype=dtype)
    before = kernels.LAUNCHES["ell_spmv"]
    got = kernels.ell_spmv(diag, cols, vals, x, sliced=sliced)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert got.shape == x.shape
    assert _rel(got, kernels.ell_spmv_ref(diag, cols, vals, x)) <= tol
    assert _rel(got, kernels.ell_spmv_sliced_ref(diag, sliced, x)) <= tol
    for b in {0, rows - 1}:
        assert torch.equal(got[b], kernels.ell_spmv(diag, cols, vals, x[b],
                                                    sliced=sliced))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", ELL_DTYPES)
@pytest.mark.parametrize("dim,k,extra", [(5003, 7, 3 * 5003), (257, 12, 40),
                                         (300, 17, 1), (1000, 96, 3000)])
@pytest.mark.parametrize("rows", [0, 1, 3, 14])
def test_ell_spmv_longer_source_kernel(cuda, dtype, tol, dim, k, extra,
                                       rows):
    """A row shard's apply: the gathers read a source longer than the
    rows (the all-gathered state of a distributed form, or its rows with
    their halo), at its own batch pitch; against both plain versions,
    each member of a batch equal to its single launch bit for bit.  rows
    0 is a single vector."""
    g = torch.Generator(device=cuda).manual_seed(dim + k + rows)
    diag, cols, vals = _random_ell(g, dim, k, dtype, cuda)
    length = dim + extra
    far = torch.randint(0, length, cols.shape, generator=g, device=cuda,
                        dtype=torch.int32)
    cols = torch.where(vals != 0, far, cols).contiguous()
    sliced = kernels.slice_ell(cols, vals)
    lead = (rows,) if rows else ()
    x = torch.randn(*lead, dim, generator=g, device=cuda, dtype=dtype)
    # a pitch longer than a row: the source is a view of a wider block
    wide = torch.randn(*lead, length + 5, generator=g, device=cuda,
                       dtype=dtype)
    src = wide[..., :length]
    before = kernels.LAUNCHES["ell_spmv"]
    got = kernels.ell_spmv(diag, cols, vals, x, sliced=sliced, src=src)
    assert kernels.LAUNCHES["ell_spmv"] == before + 1
    assert got.shape == x.shape
    assert _rel(got, kernels.ell_spmv_ref(diag, cols, vals, x, src)) <= tol
    assert _rel(got, kernels.ell_spmv_sliced_ref(diag, sliced, x,
                                                 src)) <= tol
    if rows:
        for b in {0, rows - 1}:
            assert torch.equal(got[b], kernels.ell_spmv(
                diag, cols, vals, x[b], sliced=sliced, src=src[b]))
    torch.cuda.synchronize()


def test_ell_spmv_own_source_is_the_default(cuda):
    """src=x itself gives the call without a source bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    diag, cols, vals = _random_ell(g, 2003, 17, torch.float64, cuda)
    sliced = kernels.slice_ell(cols, vals)
    x = torch.randn(5, 2003, generator=g, device=cuda, dtype=torch.float64)
    assert torch.equal(kernels.ell_spmv(diag, cols, vals, x, sliced=sliced),
                       kernels.ell_spmv(diag, cols, vals, x, sliced=sliced,
                                        src=x))


def test_ell_spmv_without_sliced_form_raises(cuda):
    """On the card the kernel reads the sliced form alone: a call without
    one is refused before any launch, never computed another way."""
    g = torch.Generator(device=cuda).manual_seed(5)
    diag, cols, vals = _random_ell(g, 100, 4, torch.float64, cuda)
    before = dict(kernels.FORM_LAUNCHES)
    with pytest.raises(ValueError, match="sliced form"):
        kernels.ell_spmv(diag, cols, vals, diag)
    other = kernels.slice_ell(cols[:50], vals[:50])
    with pytest.raises(ValueError, match="rows"):
        kernels.ell_spmv(diag, cols, vals, diag, sliced=other)
    assert kernels.FORM_LAUNCHES == before


def test_ell_part_slices_once(cuda):
    """A Hamiltonian's ELL part makes its sliced form at its first apply
    on the card and keeps it: one making however many applies."""
    inp = parse_input(SUPER6)
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            device=cuda)
    kernels.reset_launches()
    x = torch.randn(3, ham.dim, device=cuda, dtype=ham.dtype)
    for _ in range(3):
        ham.matmat_t(x)
        ham.matvec(x[0])
    assert kernels.SLICINGS == {"ell_spmv": 1}
    assert kernels.LAUNCHES["ell_spmv"] == 6
    assert ham.ell.sliced() is ham.ell.sliced()
    assert ham.ell.sliced().nnz == int((ham.ell.vals != 0).sum())


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
    with pytest.raises(TypeError):    # a complex64 factor under complex128
        kernels.factor_matmul(z, z[:4].to(torch.complex64))
    with pytest.raises(TypeError):    # a float32 factor under complex128
        kernels.factor_matmul(z, torch.zeros(4, 4, device=cuda))
    with pytest.raises(TypeError):    # a real out for a complex state
        kernels.factor_matmul(z, z[:4].real.contiguous(),
                              out=torch.zeros(8, 4, device=cuda,
                                              dtype=torch.float64))
    with pytest.raises(TypeError):
        kernels.factor_matmul(torch.zeros(8, 4, device=cuda),
                              torch.zeros(4, 4, device=cuda,
                                          dtype=torch.float64))
    with pytest.raises(TypeError):
        kernels.factor_matmul(torch.zeros(8, 4, device=cuda,
                                          dtype=torch.float16),
                              torch.zeros(4, 4, device=cuda,
                                          dtype=torch.float16))
    x = torch.zeros(8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="overlaps"):
        kernels.factor_matmul(x, x, out=x, accumulate=True)
    cols = torch.zeros(8, 2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):    # complex values on a real vector
        kernels.ell_spmv(x[:, 0].contiguous(), cols,
                         z[:, :2].contiguous(), x[:, 0].contiguous())
    with pytest.raises(TypeError):
        kernels.ell_spmv(x[:, 0].contiguous(), cols.long(),
                         x[:, :2].contiguous(), x[:, 0].contiguous())
    v = torch.zeros(16, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ell_spmv(v[::2, 0], cols, v[::2], v[::2, 1])
    # the same refusals for batched operands
    zb = torch.zeros(3, 8, 4, device=cuda, dtype=torch.complex128)
    with pytest.raises(TypeError):
        kernels.factor_matmul(zb, z[:4].to(torch.complex64))
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
    assert kernels.factor_matmul(zb[:0], x[:, :4]).shape == (0, 8, 8)
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-5)])
@pytest.mark.parametrize("rows,szd,szu", [(1, 70, 33), (3, 300, 257),
                                          (14, 56, 70), (2, 1411, 150)])
@pytest.mark.parametrize("real_factor", [True, False])
@pytest.mark.parametrize("accumulate", [False, True])
def test_factor_matmul_complex_planes(cuda, dtype, tol, rows, szd, szu,
                                      real_factor, accumulate):
    """A complex block of states through the real kernel as its real and
    imaginary planes, in the two forms of the apply, against
    ``torch.matmul`` on the complex tensors: one launch for a real factor,
    three for a complex one; a batch of one equals the 2-D call."""
    g = torch.Generator(device=cuda).manual_seed(rows * szd + szu)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    def draw(*shape, complex_=True):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=dtype if complex_ else real)
    x, y0 = draw(rows, szd, szu), draw(rows, szd, szu)
    a_up = draw(szu, szu, complex_=not real_factor)
    a_dn = draw(szd, szd, complex_=not real_factor)
    keep = y0 if accumulate else 0
    per_call = 1 if real_factor else 3
    before = kernels.LAUNCHES["factor_matmul"]
    y = y0.clone()
    kernels.factor_matmul(x.view(-1, szu), a_up, out=y.view(-1, szu),
                          accumulate=accumulate)
    assert kernels.LAUNCHES["factor_matmul"] == before + per_call
    assert _rel(y, keep + x @ a_up.T.to(dtype)) <= tol
    y = y0.clone()
    kernels.factor_matmul(x.transpose(1, 2), a_dn, out=y.transpose(1, 2),
                          accumulate=accumulate)
    assert kernels.LAUNCHES["factor_matmul"] == before + 2 * per_call
    assert _rel(y, keep + a_dn.to(dtype) @ x) <= tol
    got = kernels.factor_matmul(x, a_up)
    assert _rel(got, kernels.factor_matmul_ref(x, a_up)) <= tol
    assert torch.equal(got[0], kernels.factor_matmul(x[0], a_up))
    torch.cuda.synchronize()


def test_gather_form_on_card_matches_cpu(cuda):
    """A one-spin factor kept in gather form (``max_bytes=0``, or only the
    larger one) runs on the card through ``perm_gather``, one launch per
    factor, and gives the CPU's matvec, alone or beside a dense factor."""
    inp = parse_input(SUPER6.replace("TargetElectronsDown=3",
                                     "TargetElectronsDown=2"))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    cpu = model.hamiltonian(basis, dtype=torch.float64, device="cpu")
    ham = model.hamiltonian(basis, dtype=torch.float64, device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, ham.dim)))
    want = cpu.matmat_t(x)
    up, dn = basis.up.size, basis.down.size
    for max_bytes, gathered in ((0, 2), (8 * up * up - 1, 1)):
        form = ham.densify_factors(max_bytes=max_bytes)
        f = form.factorized
        assert f.up_dense is None and (f.dn_dense is None) == (gathered == 2)
        kernels.reset_launches()
        got = form.matmat_t(x.to(cuda))
        assert kernels.LAUNCHES["perm_gather"] == gathered
        assert _rel(got.cpu(), want) <= 1e-13
        assert _rel(form.matvec(x[1].to(cuda)).cpu(), want[1]) <= 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("rows", [None, 1, 14])
@pytest.mark.parametrize("sides", ["both", "rows_identity",
                                   "cols_identity", "no_amplitudes"])
def test_perm_gather_kernel(cuda, dtype, rows, sides):
    """perm_gather against its plain version on random tables, for one
    block and a batch, either side the identity, on strided views."""
    g = torch.Generator().manual_seed(11)
    lead = () if rows is None else (rows,)
    rs_, cs_, rd, cd, nb = 37, 300, 37, 300, 5
    if sides != "rows_identity":
        rd = 29
    if sides != "cols_identity":
        cd = 257
    x = torch.randn((*lead, cs_, rs_), generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(x.shape, generator=g,
                                         dtype=torch.float64))
    x = x.transpose(-1, -2)                       # a strided view
    y0 = torch.randn((*lead, rd, cd), generator=g,
                     dtype=torch.float64).to(dtype)

    def table(n, src):
        return torch.randint(0, src, (nb, n), generator=g, dtype=torch.int32)

    def amps(n):
        a = torch.randn(nb, n, generator=g, dtype=torch.float64)
        a[:, ::7] = 0.0                           # unreached destinations
        return a.to(dtype)
    tabs = dict(rs=None if sides == "rows_identity" else table(rd, rs_),
                a=None if sides == "no_amplitudes" else amps(rd),
                cs=None if sides == "cols_identity" else table(cd, cs_),
                beta=None if sides == "no_amplitudes" else amps(cd))
    want = kernels.perm_gather_ref(x, y0.clone(), **tabs)
    got = y0.to(cuda)
    kernels.reset_launches()
    kernels.perm_gather(x.to(cuda).transpose(-1, -2).contiguous()
                        .transpose(-1, -2), got,
                        **{k: None if v is None else v.to(cuda)
                           for k, v in tabs.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["perm_gather"] == 1
    assert _rel(got.cpu(), want) <= 1e-13


def test_perm_gather_64bit_offsets(cuda):
    """The second member of a batch starts 2^31 elements into x: offsets
    are 64-bit."""
    big = torch.zeros(2 ** 31 + 64, dtype=torch.float64, device=cuda)
    x = big.as_strided((2, 4, 8), (2 ** 31, 8, 1))
    x.copy_(torch.arange(64, dtype=torch.float64).view(2, 4, 8).to(cuda))
    rs = torch.tensor([[3, 2, 1, 0]], dtype=torch.int32, device=cuda)
    cs = torch.tensor([[7, 6, 5, 4, 3, 2, 1, 0]], dtype=torch.int32,
                      device=cuda)
    out = torch.zeros(2, 4, 8, dtype=torch.float64, device=cuda)
    kernels.perm_gather(x, out, rs=rs, cs=cs)
    assert torch.equal(out.cpu(), x.cpu().flip(1).flip(2))
    del big, x
    torch.cuda.empty_cache()


# (batch, rows, cols, nb), for the pairs a thread carries (float64 2,
# complex128 1): an odd number of pairs (21, a tail of one in float64),
# a float64 thread's two pairs across two batch members (rows 5: pairs 4
# and 5), the FeAs interaction's 32 channels and one more, more groups of
# pairs than a grid's 65 535 block rows; no column count is a multiple
# of the 128-column block
GATHER_GEOMETRY_CASES = {"pair_tail": (3, 7, 203, 5),
                         "spans_members": (2, 5, 70, 4),
                         "nb32": (1, 37, 100, 32),
                         "nb33": (2, 19, 45, 33),
                         "grid_y_loop": (3, 100_001, 33, 2)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32, torch.complex64])
@pytest.mark.parametrize("case", sorted(GATHER_GEOMETRY_CASES))
@pytest.mark.parametrize("sides", ["both", "rows_identity",
                                   "cols_identity"])
def test_perm_gather_geometry_bit_equal(cuda, dtype, case, sides):
    """perm_gather equals its plain version on the card bit for bit: the
    tail of pairs, a thread's pairs across two batch members, 32 and 33
    channels, the grid-y loop, a column block cut short, rows and columns
    of amplitude 0 in some channels, a strided x; with tables on both
    sides, and with the rows (the kernel without a row side) or the
    columns the identity; in each of the kernel's four types (float32
    four pairs a thread, complex64 two)."""
    batch, rows, cols, nb = GATHER_GEOMETRY_CASES[case]
    rows_src = rows if sides == "rows_identity" else rows + 3
    cols_src = cols if sides == "cols_identity" else cols + 11
    g = torch.Generator(device=cuda).manual_seed(rows * cols + nb)
    real = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32

    def rand(*shape):
        t = torch.randn(shape, generator=g, device=cuda, dtype=real)
        if dtype.is_complex:
            t = torch.complex(t, torch.randn(shape, generator=g,
                                             device=cuda, dtype=real))
        return t
    x = rand(batch, cols_src, rows_src).transpose(1, 2)
    y0 = rand(batch, rows, cols)
    a = rand(nb, rows)
    a[:, ::3] = 0.0
    a[nb // 2, :] = 0.0
    beta = rand(nb, cols)
    beta[:, 1::4] = 0.0
    tabs = dict(rs=torch.randint(0, rows_src, (nb, rows), generator=g,
                                 device=cuda, dtype=torch.int32),
                a=a,
                cs=torch.randint(0, cols_src, (nb, cols), generator=g,
                                 device=cuda, dtype=torch.int32),
                beta=beta)
    if sides != "both":
        side = ("rs", "a") if sides == "rows_identity" else ("cs", "beta")
        tabs.update(dict.fromkeys(side))
    want = kernels.perm_gather_ref(x, y0.clone(), **tabs)
    got = y0.clone()
    kernels.reset_launches()
    kernels.perm_gather(x, got, **tabs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["perm_gather"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(GATHER_GEOMETRY_CASES))
@pytest.mark.parametrize("sides", ["both", "rows_identity"])
def test_perm_gather_bf16_source_bit_equal(cuda, dtype, case, sides):
    """The bf16cross form: a bfloat16 source block (strided), amplitudes
    and out in float32 or float64, equal bit for bit to the plain version,
    which widens the block first."""
    batch, rows, cols, nb = GATHER_GEOMETRY_CASES[case]
    rows_src = rows if sides == "rows_identity" else rows + 3
    g = torch.Generator(device=cuda).manual_seed(rows + cols + nb)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    x = rand(batch, cols + 11, rows_src).to(torch.bfloat16).transpose(1, 2)
    y0 = rand(batch, rows, cols)
    a = rand(nb, rows)
    a[:, ::3] = 0.0
    tabs = dict(rs=torch.randint(0, rows_src, (nb, rows), generator=g,
                                 device=cuda, dtype=torch.int32),
                a=a,
                cs=torch.randint(0, cols + 11, (nb, cols), generator=g,
                                 device=cuda, dtype=torch.int32),
                beta=rand(nb, cols))
    if sides == "rows_identity":
        tabs.update(rs=None, a=None)
    want = kernels.perm_gather_ref(x, y0.clone(), **tabs)
    got = y0.clone()
    kernels.reset_launches()
    kernels.perm_gather(x, got, **tabs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["perm_gather"] == 1
    assert torch.equal(got, want)


# float32 sums of exact bf16 products, in another order than the plain
# version's: a few units of float32 rounding of max |y|
BF16_TOL = 2e-5


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,k", [(300, 123, 257), (64, 64, 16),
                                   (1, 70, 5), (129, 1, 300), (260, 130, 33)])
@pytest.mark.parametrize("layout", ["k_major", "row_major"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_factor_matmul_bf16_kernel(cuda, out_dtype, m, n, k, layout,
                                   accumulate):
    """The bf16 form on the tensor cores against its plain version (the
    operands widened to float32, a float32 product), k-contiguous or
    row-contiguous operands (transposed views), ragged edges and k tails,
    stored or added into a float32 or float64 out."""
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn(n, k, generator=g, device=cuda).to(torch.bfloat16)
    if layout == "row_major":
        x = x.T.contiguous().T
        a = a.T.contiguous().T
    y0 = torch.randn(m, n, generator=g, device=cuda, dtype=out_dtype)
    got = y0.clone()
    before = kernels.LAUNCHES["factor_matmul"]
    kernels.factor_matmul(x, a, out=got, accumulate=accumulate)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["factor_matmul"] == before + 1
    want = (y0 if accumulate else torch.zeros_like(y0)) \
        + kernels.factor_matmul_ref(x, a)
    assert _rel(got, want) <= BF16_TOL
    if not accumulate:
        assert kernels.factor_matmul(x, a).dtype == torch.float32


def test_factor_matmul_bf16_batched(cuda):
    """A batch of states against a shared bf16 factor and against a factor
    per member (blockIdx.z), the dn form on transposed views."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, 200, 136, generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn(3, 136, 136, generator=g, device=cuda).to(torch.bfloat16)
    for factor in (a[0], a):
        got = kernels.factor_matmul(x, factor)
        assert _rel(got, kernels.factor_matmul_ref(x, factor)) <= BF16_TOL
    # y[b] += A x[b] for states x[b] of (136, 200), as y[b]^T += x[b]^T A^T
    xd = x.transpose(1, 2).contiguous()
    y = torch.zeros(3, 136, 200, device=cuda, dtype=torch.float64)
    kernels.factor_matmul(xd.transpose(1, 2), a[0], out=y.transpose(1, 2),
                          accumulate=True)
    assert _rel(y, a[0].double() @ xd.double()) <= BF16_TOL


def _bf16_path_case(case, g, cuda):
    """(x, a, out, want) for the layouts the paths hand the bf16 kernel, at
    a reduced size: the 14-site chain's up and dn applies (14h), a batch
    of states' dn apply, and the Kitaev form's four products
    (models/kitaev_factored.py matmat_t, dl = dr = 264, K = 3 cut terms)."""
    def bf(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    d, k3 = 264, 3
    xm, f = bf(d, d), bf(d, d)
    if case == "up":                      # X . A_up^T
        return xm, f, torch.zeros(d, d, device=cuda), None
    if case == "dn":                      # Y^T += X^T . A_dn^T
        y = torch.randn(d, d, generator=g, device=cuda, dtype=torch.float64)
        want = y + f.double() @ xm.double()
        return xm.T, f, y.T, want.T
    if case == "batched dn":              # the same for a block of states
        xb = bf(3, d, 136)
        y = torch.zeros(3, d, 136, device=cuda)
        want = torch.matmul(f.float(), xb.float())
        return xb.transpose(1, 2), f, y.transpose(1, 2), want.transpose(1, 2)
    if case == "kitaev right half":       # X . hr_t, A = hr_t.T MN-major
        return xm, f.T, torch.zeros(d, d, device=cuda), None
    if case == "kitaev left half":        # Y^T += X^T . hl^T
        y = torch.randn(d, d, generator=g, device=cuda)
        return xm.T, f, y.T, (y + f.float() @ xm.float()).T
    p = bf(k3, d, d)
    if case == "kitaev P_k X":            # X^T shared, a P_k per member
        px = torch.zeros(d, k3, d, device=cuda)
        want = torch.einsum("kac,cd->akd", p.float(), xm.float())
        return (xm.T.expand(k3, d, d), p, px.permute(1, 2, 0),
                want.permute(1, 2, 0))
    # Y += [P_0 X ... P_K-1 X] [Q_0 ... Q_K-1]^T, pitch K d
    pxq = bf(d, k3 * d)
    return pxq, bf(d, k3 * d), torch.zeros(d, d, device=cuda), None


@pytest.mark.parametrize("case", ["up", "dn", "batched dn",
                                  "kitaev right half", "kitaev left half",
                                  "kitaev P_k X", "kitaev Q"])
def test_factor_matmul_bf16_path_layouts(cuda, case):
    """The bf16 kernel on every stride pattern a path hands it: k-major
    and MN-major X and A, Y transposed, X shared by a batch (stride 0), a
    factor per member, px.permute(1, 2, 0) as Y; one launch each, no
    operand repacked, within BF16_TOL of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    x, a, out, want = _bf16_path_case(case, g, cuda)
    accumulate = want is not None and case in ("dn", "kitaev left half")
    if want is None:
        want = kernels.factor_matmul_ref(x, a)
    elif case in ("batched dn", "kitaev P_k X"):
        want = want.to(out.dtype)
    kernels.reset_launches()
    kernels.factor_matmul(x, a, out=out, accumulate=accumulate)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["factor_matmul"] == 1 and not kernels.REPACKS
    assert _rel(out, want) <= BF16_TOL


def test_factor_matmul_bf16_repacks_only_what_tma_cannot_take(cuda):
    """An operand whose pitch is not a multiple of 16 bytes is copied into
    a padded one before the launch, counted in REPACKS and nowhere in the
    launch counts; an aligned one is not, also where its rows are a view
    narrower than their pitch."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(300, 257, generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn(123, 264, generator=g, device=cuda).to(torch.bfloat16)
    kernels.reset_launches()
    got = kernels.factor_matmul(x, a[:, :257])
    torch.cuda.synchronize()
    assert kernels.REPACKS == {"factor_matmul bf16": 1}
    assert kernels.FORM_LAUNCHES == {"factor_matmul bf16_f32": 1}
    assert _rel(got, kernels.factor_matmul_ref(x, a[:, :257])) <= BF16_TOL
    kernels.reset_launches()
    got = kernels.factor_matmul(x[:, :256].contiguous(), a[:, :256])
    torch.cuda.synchronize()
    assert not kernels.REPACKS
    assert kernels.FORM_LAUNCHES == {"factor_matmul bf16_f32": 1}


@pytest.mark.parametrize("layout", ["up", "dn"])
def test_factor_matmul_f32_tiles_and_batch_bit_equal(cuda, layout):
    """Every float32 output is one chain of FMAs in k order: the large and
    the small tile's plans give the same bits, and so does a batch of one
    against the 2-D call."""
    from lanczosplusplus_tpu_torch.ops.build import load_library
    g = torch.Generator(device=cuda).manual_seed(12)
    size = 700
    x = torch.randn(size, size, generator=g, device=cuda)
    a = torch.randn(size, size, generator=g, device=cuda)
    if layout == "dn":
        x = x.T
    y0 = torch.randn(size, size, generator=g, device=cuda)
    outs = []
    for tile in (128, 64):
        y = y0.clone()
        plan = kernels.factor_matmul_plan(
            x.data_ptr(), x.stride(), a.data_ptr(), a.stride(), y.data_ptr(),
            y.stride(), size, size, elem_size=4)._replace(tile=tile)
        err = load_library().lpp_factor_matmul_f32(
            x.data_ptr(), 0, *x.stride(), a.data_ptr(), 0, *a.stride(),
            y.data_ptr(), 0, *y.stride(), 1, size, size, size, 1, plan.bits,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs.append(y)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert _rel(outs[0], y0 + kernels.factor_matmul_ref(x, a)) <= 1e-5
    assert torch.equal(kernels.factor_matmul(x[None], a)[0],
                       kernels.factor_matmul(x, a))


def test_new_forms_refuse_what_they_do_not_take(cuda):
    xb = torch.zeros(8, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):    # a float32 factor under a bf16 state
        kernels.factor_matmul(xb, torch.zeros(4, 4, device=cuda))
    with pytest.raises(TypeError):    # a bf16 product into half precision
        kernels.factor_matmul(xb, xb, out=torch.zeros(
            8, 8, device=cuda, dtype=torch.float16))
    out = torch.zeros(8, 4, device=cuda, dtype=torch.complex64)
    with pytest.raises(TypeError):    # bf16cross takes real amplitudes
        kernels.perm_gather(xb, out, cs=torch.zeros(
            1, 4, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):    # amplitudes of another type than out
        kernels.perm_gather(xb, torch.zeros(8, 4, device=cuda),
                            cs=torch.zeros(1, 4, dtype=torch.int32,
                                           device=cuda),
                            beta=torch.ones(1, 4, device=cuda,
                                            dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bf16_factor_entry_points_on_card_match_cpu(cuda, dtype):
    """The two entry points to bf16 factors on the card: the 8-site
    Hubbard chain's densify_factors(factor_dtype=torch.bfloat16) under a
    float32 and a float64 state, and the 10-site Kitaev ring's
    build_factored_kitaev(factor_dtype=torch.bfloat16) under a float32
    state.  Each matvec launches the bf16 factor_matmul into the state's
    type and equals the CPU form's to float32 rounding; the Hubbard form's
    refined E0 equals the float64 one within 1e-10."""
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        build_factored_kitaev)
    from test_torch_inputs import kitaev_text
    form = f"factor_matmul bf16_{'f32' if dtype == torch.float32 else 'f64'}"
    inp = parse_input(hubbard_chain_text(8, 4))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    forms = [model.hamiltonian(basis, dtype=dtype, device=dev).densify_factors(
        max_bytes=1 << 30, factor_dtype=torch.bfloat16)
        for dev in ("cpu", cuda)]
    e64 = float(lz.lowest_states(model.hamiltonian(
        basis, dtype=torch.float64, device="cpu"))[0][0])
    if dtype == torch.float32:
        kinp = parse_input(kitaev_text(10, 1.1, 0.7, 0.9, periodic=1))
        kmodel = build_model(kinp, Geometry(kinp))
        kbasis = kmodel.create_basis(kmodel.default_parts(kinp))
        forms += [build_factored_kitaev(kmodel, kbasis, dtype=dtype,
                                        device=dev,
                                        factor_dtype=torch.bfloat16)
                  for dev in ("cpu", cuda)]
    for cpu_form, card_form in zip(forms[::2], forms[1::2]):
        assert card_form.quantized
        x = torch.randn(cpu_form.dim, generator=torch.Generator().manual_seed(
            3), dtype=torch.float64).to(dtype)
        kernels.reset_launches()
        y = card_form.matvec(x.to(cuda))
        torch.cuda.synchronize()
        assert y.dtype == dtype and kernels.FORM_LAUNCHES.get(form, 0) > 0
        assert _rel(y.cpu(), cpu_form.matvec(x)) <= BF16_TOL
    kernels.reset_launches()
    e0 = float(lz.lowest_states(forms[1], seed=5)[0][0])
    assert kernels.FORM_LAUNCHES.get(form, 0) > 0
    assert abs(e0 - e64) <= 1e-10 * abs(e64)


def test_float32_solves_on_card_refine_to_the_float64_bar(cuda):
    """A float32 solve on the card (the flat Hubbard form through the f32
    GEMMs, the SuperHubbardExtended J-ELL through the f32 ell_spmv, a
    bf16cross half-cut Rashba form through the bf16-source perm_gather)
    refines to the float64 energy within 1e-10, as on the CPU."""
    texts = (hubbard_chain_text(8, 4), SUPER6,
             rashba_text(6, 6, r=0.5, options="factored,bf16cross"))
    for text in texts:
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        e64 = Engine(model, inp, config=Config.from_input(
            inp, device="cpu")).ground_energy
        kernels.reset_launches()
        eng = Engine(model, inp, config=Config.from_input(
            inp, device=cuda, real_dtype=torch.float32))
        assert eng.eigenvector(0).dtype in (torch.float32, torch.complex64)
        assert sum(kernels.LAUNCHES.values()) > 0
        assert abs(eng.ground_energy - e64) <= 1e-10 * abs(e64)


@pytest.mark.parametrize("rows,m,n,k", [(3, 300, 123, 257), (7, 64, 64, 16),
                                        (6, 40, 40, 40)])
def test_factor_matmul_factor_per_member(cuda, rows, m, n, k):
    """A factor per batch member (the tiers' and the cross terms' stacks)
    through the batch stride on A: each member equals its own 2-D call
    bit for bit and torch.matmul to 1e-12; an expanded X (batch stride 0)
    shares one state."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, m, k, generator=g, device=cuda,
                    dtype=torch.float64)
    a = torch.randn(rows, n, k, generator=g, device=cuda,
                    dtype=torch.float64)
    kernels.reset_launches()
    got = kernels.factor_matmul(x, a)
    assert kernels.LAUNCHES["factor_matmul"] == 1
    assert _rel(got, torch.matmul(x, a.transpose(1, 2))) <= 1e-12
    for b in range(rows):
        assert torch.equal(got[b], kernels.factor_matmul(x[b], a[b]))
    shared = kernels.factor_matmul(x[0].expand(rows, m, k), a)
    for b in range(rows):
        assert torch.equal(shared[b], kernels.factor_matmul(x[0], a[b]))
    # transposed views, accumulating, a complex state on real factors
    y0 = torch.randn(rows, n, m, generator=g, device=cuda,
                     dtype=torch.float64)
    y = y0.clone()
    kernels.factor_matmul(x, a, out=y.transpose(1, 2), accumulate=True)
    assert _rel(y, y0 + torch.matmul(a, x.transpose(1, 2))) <= 1e-12
    xc = torch.complex(x, x.flip(0))
    assert _rel(kernels.factor_matmul(xc, a),
                kernels.factor_matmul_ref(xc, a)) <= 1e-12


FACTORED = {
    "heisenberg": heisenberg_text(10, 1, 5),
    "heisenberg_spin1": heisenberg_text(6, 2, 5),
    "kitaev": kitaev_text(8, 1.1, 0.7, 0.9, periodic=1),
    "tj": tj_text(10, 4, 3, j=0.3, periodic=1),
    "rashba_complex": rashba_text(6, 5, r="(0.3,0.4)", periodic=1,
                                  options="useComplex"),
    "feas": feas_text(4, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1], 2, 2),
    "feas_spinorbit": feas_so_text(2, 2, 1),
}


@pytest.mark.parametrize("name", sorted(FACTORED))
def test_factored_form_on_card_matches_cpu(cuda, name):
    """Each factored form applies on the card as on the CPU (one state and
    a block of 3), the card's launches are the kernels', and the Engine
    with SolverOptions=factored reaches the CPU's energy."""
    text = FACTORED[name].replace("SolverOptions=none",
                                  "SolverOptions=factored").replace(
        "SolverOptions=useComplex", "SolverOptions=useComplex,factored")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    cpu = Engine(model, inp, config=Config.from_input(inp, device="cpu"))
    kernels.reset_launches()
    gpu = Engine(model, inp, config=Config.from_input(inp, device=cuda),
                 v0=cpu.eigenvector(0).cpu().numpy())
    assert cpu._factored and gpu._factored
    assert abs(gpu.ground_energy - cpu.ground_energy) <= \
        1e-10 * abs(cpu.ground_energy)
    h_cpu = cpu._cached_hamiltonian(cpu.parts)
    h_gpu = gpu._cached_hamiltonian(gpu.parts)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, h_cpu.dim))).to(h_cpu.dtype)
    kernels.reset_launches()
    assert _rel(h_gpu.matmat_t(x.to(cuda)).cpu(), h_cpu.matmat_t(x)) <= 1e-12
    assert _rel(h_gpu.matvec(x[2].to(cuda)).cpu(), h_cpu.matvec(x[2])) <= \
        1e-12
    assert kernels.LAUNCHES["factor_matmul"] > 0
    assert kernels.LAUNCHES["ell_spmv"] == 0
    gathers = name in ("tj", "rashba_complex", "feas", "feas_spinorbit")
    assert (kernels.LAUNCHES["perm_gather"] > 0) == gathers


def test_rashba_block_kron_on_card_matches_cpu(cuda):
    """The (nup, ndown) block-Kronecker Rashba form, which no dispatch
    reaches, applies on the card as on the CPU."""
    inp = parse_input(rashba_text(5, 4, periodic=1))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    h_cpu = model.block_kron_hamiltonian(basis)
    h_gpu = model.block_kron_hamiltonian(basis, device=cuda)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, basis.size)))
    kernels.reset_launches()
    assert _rel(h_gpu.matmat_t(x.to(cuda)).cpu(), h_cpu.matmat_t(x)) <= 1e-12
    assert kernels.LAUNCHES["perm_gather"] > 0


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
                                "ell_spmv": 2 * 300 * ell, "perm_gather": 0}
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


def test_complex_spectral_run_on_card_matches_cpu(cuda):
    """A useComplex spectral run on the card goes through the complex
    forms of both kernels (the state's planes through ``factor_matmul``,
    complex128 ``ell_spmv``) and gives the CPU's fractions."""
    text = SUPER6.replace("SolverOptions=none", "SolverOptions=useComplex") \
        + "SpectralSteps=300\n"
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    cpu = Engine(model, inp, config=Config.from_input(inp, device="cpu"))
    gpu = Engine(model, inp, config=Config.from_input(inp, device=cuda),
                 v0=cpu.eigenvector(0).numpy())
    assert gpu.eigenvector(0).dtype == torch.complex128
    assert abs(gpu.ground_energy - cpu.ground_energy) <= 1e-10
    f = gpu.hamiltonian.factorized
    assert f.up_dense.dtype == f.dn_dense.dtype == torch.float64
    gpu._vectors = cpu._vectors.to(cuda)
    pairs = [(0, 0), (1, 4), (2, 5)]
    omegas = np.linspace(-8, 8, 81)
    kernels.reset_launches()
    outs = gpu.spectral_functions_batched("c", pairs)
    # two sectors of dim 300: a step is one launch over the planes for
    # each real factor and one complex ell_spmv
    assert kernels.LAUNCHES == {"factor_matmul": 2 * 2 * 300,
                                "ell_spmv": 2 * 300, "perm_gather": 0}
    refs = cpu.spectral_functions_batched("c", pairs)
    for (coll, labels), (rcoll, rlabels) in zip(outs, refs):
        assert labels == rlabels
        for cf, rcf in zip(coll.items, rcoll.items):
            assert abs(cf.weight - rcf.weight) <= 1e-12
        np.testing.assert_allclose(coll.evaluate(omegas, 0.1),
                                   rcoll.evaluate(omegas, 0.1), rtol=0,
                                   atol=1e-8)
    serial, _ = gpu.spectral_function("c", 1, 4)
    np.testing.assert_allclose(serial.evaluate(omegas, 0.1),
                               refs[1][0].evaluate(omegas, 0.1), rtol=0,
                               atol=1e-8)
    z = torch.randn(2, gpu.basis.size, device=cuda, dtype=torch.complex128)
    np.testing.assert_allclose(
        gpu.hamiltonian.matmat_t(z).cpu().numpy(),
        cpu.hamiltonian.matmat_t(z.cpu()).numpy(), rtol=0, atol=1e-12)


# name -> (input text, launches a matvec makes of factor_matmul, ell_spmv)
FLAT_MODELS = {
    "heisenberg": (heisenberg_text(10, 1, 5), 0, 1),
    "heisenberg_spin_one": (heisenberg_text(6, 2, 6, periodic=0), 0, 1),
    "kitaev": (kitaev_text(8, 1.0, 0.6, 0.8, periodic=1,
                           extra="MagneticField 8 0.1 0.2 0 0 0.3 0 0 0\n"),
               0, 1),
    "tj": (tj_text(8, 3, 3, periodic=1), 0, 1),
    "rashba": (rashba_text(5, 4, periodic=1), 0, 1),
    "rashba_complex": (rashba_text(5, 4, r="(0.3,0.4)", periodic=1,
                                   options="useComplex"), 0, 1),
    "feas": (feas_text(3, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1], 2, 2,
                       extra="AnisotropyD=0.4\n"), 2, 1),
    "feas_complex": (feas_text(3, 2, "INT_PAPER33", [1.0, 0.6, -0.2, -0.1],
                               2, 2, options="useComplex"), 2, 1),
    "feas_kspace": (feas_text(2, 3, "INT_KSPACE", [0.9], 2, 2), 2, 1),
    "feas_int_v": (feas_text(2, 3, "INT_V", [1.0, 0.2, 0.3, 0.2, 0.8, 0.1,
                                             0.3, 0.1, 0.6], 2, 2), 2, 0),
    "feas_spinorbit": (feas_so_text(3, 2, 1), 0, 1),
    "immm": (immm_text(4, 2, 2), 2, 0),
    "immm_complex": (immm_text(4, 2, 2).replace(
        "SolverOptions=none", "SolverOptions=useComplex"), 2, 0),
}


@pytest.mark.parametrize("name", sorted(FLAT_MODELS))
def test_flat_model_on_card_matches_cpu(cuda, name):
    """Each flat model's kernel path on the card against the CPU's plain
    versions: one matvec, a block of three states, and the ground-state
    energy from the same start vector, with the launches a matvec makes
    as the model's form predicts."""
    text, n_gemm, n_ell = FLAT_MODELS[name]
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    config = Config.from_input(inp, device="cpu")
    parts = model.default_parts(inp)
    dim = model.create_basis(parts).size
    assert dim > 64     # past the dense branch
    v0 = np.random.default_rng(2).standard_normal(dim)
    cpu = Engine(model, inp, config=config, v0=v0)
    gpu = Engine(model, inp, config=Config.from_input(inp, device=cuda),
                 v0=v0)
    ham, ref = gpu.hamiltonian, cpu.hamiltonian
    assert ham.dtype == ref.dtype and ham.device.type == "cuda"
    x = lz.random_start_vector(dim, 5, ham.dtype, "cpu")
    kernels.reset_launches()
    got = ham.matvec(x.to(cuda))
    assert kernels.LAUNCHES == {"factor_matmul": n_gemm, "ell_spmv": n_ell,
                                "perm_gather": 0}
    want = ref.matvec(x)
    assert _rel(got.cpu(), want) <= 1e-12
    block = torch.stack([x, 2 * x, x.flip(0)])
    kernels.reset_launches()
    got = ham.matmat_t(block.to(cuda))
    assert kernels.LAUNCHES == {"factor_matmul": n_gemm, "ell_spmv": n_ell,
                                "perm_gather": 0}
    assert _rel(got.cpu(), ref.matmat_t(block)) <= 1e-12
    assert gpu.solve_info.converged and not gpu.solve_info.used_dense_fallback
    assert abs(gpu.ground_energy - cpu.ground_energy) <= \
        1e-10 * max(abs(cpu.ground_energy), 1.0)


def test_input100_on_card_reaches_the_golden(cuda):
    """TestSuite input100 (FeAs, useComplex, dim 48 400) on the card: both
    kernels in their complex forms, E0 of benchmarks/goldens.json."""
    inp = parse_input(INPUT100)
    kernels.reset_launches()
    gpu = Engine(build_model(inp, Geometry(inp)), inp,
                 config=Config.from_input(inp, device=cuda))
    assert gpu.basis.size == 48400
    assert gpu.eigenvector(0).dtype == torch.complex128
    assert abs(gpu.ground_energy - -3.0994640142192615) <= 1e-10 * 3.1
    assert kernels.LAUNCHES["factor_matmul"] == 2 * kernels.LAUNCHES["ell_spmv"]
    assert kernels.LAUNCHES["ell_spmv"] >= gpu.solve_info.steps


def test_spin_orbital_chain_on_card(cuda):
    from lanczosplusplus_tpu_torch.models.spin_orbital import (
        build_spin_orbital)
    ham = build_spin_orbital(4, 1, dtype=torch.float64, device=cuda)
    ref = build_spin_orbital(4, 1, dtype=torch.float64, device="cpu")
    x = lz.random_start_vector(ham.dim, 3, torch.float64, "cpu")
    kernels.reset_launches()
    assert _rel(ham.matvec(x.to(cuda)).cpu(), ref.matvec(x)) <= 1e-12
    assert kernels.LAUNCHES == {"factor_matmul": 0, "ell_spmv": 1,
                                "perm_gather": 0}
    evals, _ = lz.lowest_states(ham, seed=3)
    want = np.linalg.eigvalsh(ref.to_dense())[0]
    assert abs(evals[0] - want) <= 1e-10 * abs(want)


def _symmetry_of(text, label, device):
    """The input's symmetry with its blocks on `device`."""
    from lanczosplusplus_tpu_torch.symmetry import build_symmetry
    inp = parse_input(text + label)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    return build_symmetry(inp, basis, model.geometry, model, device=device)


@pytest.mark.parametrize("label, dtype", [
    ("UseTranslationSymmetry=1\n", torch.complex128),
    ("UseReflectionSymmetry=1\n", torch.float64)],
    ids=["momentum_c128", "parity_f64"])
def test_ell_spmv_on_symmetry_blocks(cuda, label, dtype):
    """ell_spmv on the largest block of a type of the 10-site (3, 3)
    Hubbard chain (momentum blocks PBC, parity blocks open) against its
    plain version, one vector and a block of 3."""
    periodic = int(dtype.is_complex)
    sym = _symmetry_of(hubbard_chain_text(10, 4, 3, 3, periodic=periodic),
                       label, cuda)
    blocks = [sym.block_hamiltonian(s) for s in range(sym.sectors())]
    blk = max((b for b in blocks if b is not None and b.dtype == dtype),
              key=lambda b: b.dim)
    assert blk.ell.cols.device.type == "cuda" and blk.diag.dtype == dtype
    gen = torch.Generator(device=cuda).manual_seed(3)
    for shape in ((blk.dim,), (3, blk.dim)):
        x = torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
        kernels.reset_launches()
        got = kernels.ell_spmv(blk.diag, blk.ell.cols, blk.ell.vals, x,
                               sliced=blk.ell.sliced())
        assert kernels.LAUNCHES["ell_spmv"] == 1
        ref = kernels.ell_spmv_ref(blk.diag, blk.ell.cols, blk.ell.vals, x)
        assert _rel(got, ref) <= 1e-13


def _mirror(sym, s):
    """The sector of the opposite momentum: its block is the complex
    conjugate of sector s's, its spectrum the same."""
    momenta = sym._momenta
    lx = 1 + max(kx for kx, _ in momenta)
    ly = 1 + max(ky for _, ky in momenta)
    kx, ky = momenta[s]
    return momenta.index(((-kx) % lx, (-ky) % ly))


def _assert_same_minimum_sector(gpu, cpu):
    """The card's minimum sector is the CPU's, or one whose block has the
    CPU's minimum E0 (1e-10): k and -k, and on the 8-site ladder (0, 0)
    and (2, 0), are degenerate, so rounding picks among them."""
    print(f"minimum sector: card {gpu.solve_sector}, CPU {cpu.solve_sector}")
    if gpu.solve_sector == cpu.solve_sector:
        return
    blk = cpu.symmetry.block_hamiltonian(gpu.solve_sector)
    e0 = float(lz.lowest_states(blk, seed=cpu.config.seed)[0][0])
    assert abs(e0 - cpu.ground_energy) <= 1e-10 * abs(cpu.ground_energy)


@pytest.mark.parametrize("text, label", [
    (hubbard_chain_text(8, 4, 2, 2, ladder=True),
     "UseTranslationSymmetry=2\n"),
    (hubbard_chain_text(10, 4, 3, 3, periodic=0), "UseReflectionSymmetry=1\n"),
    (hubbard_chain_text(8, 4, 2, 3), "UseTranslationSymmetry=1\n")],
    ids=["ladder8", "reflection10", "ring8_complex"])
def test_symmetry_engine_on_card_matches_cpu(cuda, text, label):
    """A symmetric Engine on the card: every block through ell_spmv, no
    other kernel, E0 as on the CPU (1e-10), the minimum sector the CPU's
    or one degenerate with it, the residual on the full H, the
    eigenvector on the card, complex128 after the 8-site ring's complex
    momentum sector (blocks of 196)."""
    inp = parse_input(text + label)
    model = build_model(inp, Geometry(inp))
    cpu = Engine(model, inp, config=Config(device="cpu"))
    kernels.reset_launches()
    gpu = Engine(model, inp, config=Config(device=cuda))
    assert kernels.LAUNCHES["ell_spmv"] > 0
    assert kernels.LAUNCHES["factor_matmul"] == 0
    assert abs(gpu.ground_energy - cpu.ground_energy) <= \
        1e-10 * abs(cpu.ground_energy)
    _assert_same_minimum_sector(gpu, cpu)
    v = gpu.eigenvector(0)
    assert v.device.type == "cuda" and v.dtype == cpu.eigenvector(0).dtype
    full = cpu.hamiltonian.to_dense()
    vh = v.cpu().numpy()
    assert np.linalg.norm(full @ vh - gpu.ground_energy * vh) <= 1e-7


def test_spectral_after_a_complex_sector_on_card(cuda):
    """After the 6-site ring's complex momentum sector (1 up, 2 down), -g
    on the card builds its sector Hamiltonians complex128 and runs the
    complex kernels: G_01(omega + 0.1i) as on the CPU (1e-8; 300 steps
    exhaust every Krylov space, so the fractions are comparable).  The
    card's sector is the CPU's or its mirror -k, whose G_01 is the same
    there (test_torch_symmetry.py::test_mirror_sector_spectral)."""
    inp = parse_input(hubbard_chain_text(6, 4, 1, 2,
                                         extra="SpectralSteps=300\n")
                      + "UseTranslationSymmetry=1\n")
    model = build_model(inp, Geometry(inp))
    cpu = Engine(model, inp, config=Config(device="cpu"))
    gpu = Engine(model, inp, config=Config(device=cuda))
    assert gpu.eigenvector(0).dtype == torch.complex128
    assert gpu.solve_sector in (cpu.solve_sector,
                                _mirror(cpu.symmetry, cpu.solve_sector))
    kernels.reset_launches()
    coll, _ = gpu.spectral_function("c", 0, 1)
    assert kernels.LAUNCHES["factor_matmul"] > 0
    assert gpu.hamiltonian.dtype == torch.complex128
    omegas = np.linspace(-6, 6, 41)
    ref, _ = cpu.spectral_function("c", 0, 1)
    np.testing.assert_allclose(coll.evaluate(omegas, 0.1),
                               ref.evaluate(omegas, 0.1), rtol=0, atol=1e-8)


def test_projected_kitaev_on_card(cuda):
    """UseTranslationSymmetry=1 on the 12-site Kitaev ring takes the
    projected path on the card (factor_matmul, no ell_spmv): E0 as the CPU's
    orbit blocks (1e-10), a clean sector vector, and the card's vector an
    eigenvector of the full H."""
    text = kitaev_text(12, 1.1, 0.7, 0.9, periodic=1,
                       extra="UseTranslationSymmetry=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    kernels.reset_launches()
    gpu = Engine(model, inp, config=Config(device=cuda))
    assert kernels.LAUNCHES["factor_matmul"] > 0
    assert kernels.LAUNCHES["ell_spmv"] == 0
    assert gpu.projected_purity >= 1 - 1e-8
    cpu = Engine(model, inp, config=Config(device="cpu"))
    assert not hasattr(cpu, "projected_purity")
    assert abs(gpu.ground_energy - cpu.ground_energy) <= \
        1e-10 * abs(cpu.ground_energy)
    v = gpu.eigenvector(0)
    assert v.device.type == "cuda"
    from lanczosplusplus_tpu_torch.models.kitaev_factored import (
        build_factored_kitaev)
    ham = build_factored_kitaev(model, gpu.basis, device=cuda)
    assert torch.linalg.vector_norm(
        ham.matvec(v) - gpu.ground_energy * v).item() <= 1e-7


# -- the estimators on the card against the CPU, one start block ------------

def _sector(text, device, dtype=torch.float64):
    """The default sector's flat Hamiltonian on `device` (one-spin
    factors densified on the card, as the estimators build it)."""
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            dtype=dtype, device=device)
    return ham.densify_factors() if device.type == "cuda" else ham


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("text,kernel", [
    (hubbard_chain_text(10, 4), "factor_matmul"),
    (tj_text(10, 4, 4, periodic=1), "ell_spmv")], ids=["hubbard10", "tj10"])
def test_ftlm_on_card_matches_cpu(cuda, text, kernel):
    """FTLM's batched recurrence (R = 12, 40 steps) through the kernels
    against the CPU's plain versions from one block: thermal energies and
    ln Z to 1e-8 (a plain recurrence sits between them)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import ftlm
    cpu, gpu = _sector(text, torch.device("cpu")), _sector(text, cuda)
    block = lz.random_start_block(cpu.dim, 12, 5, torch.float64, cuda)
    betas = [0.2, 1.0, 5.0]
    kernels.reset_launches()
    got = ftlm(gpu, betas, steps=40, start_vectors=block)
    assert kernels.LAUNCHES[kernel] > 0
    want = ftlm(cpu, betas, steps=40, start_vectors=block.cpu())
    assert _rel_max(got.energy, want.energy) <= 1e-8
    assert _rel_max(got.log_z, want.log_z) <= 1e-8


def test_ltlm_on_card_matches_cpu(cuda):
    """LTLM's stored-V runs and H projection on the 8-site
    SuperHubbardExtended chain (factor_matmul and ell_spmv)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import ltlm
    from chip_smoke import super_hubbard_text
    text = super_hubbard_text(8)
    cpu, gpu = _sector(text, torch.device("cpu")), _sector(text, cuda)
    block = lz.random_start_block(cpu.dim, 3, 9, torch.float64, cuda)
    kernels.reset_launches()
    got = ltlm(gpu, [0.5, 4.0], {"energy": gpu}, steps=40,
               start_vectors=block)
    assert kernels.LAUNCHES["factor_matmul"] > 0
    assert kernels.LAUNCHES["ell_spmv"] > 0
    want = ltlm(cpu, [0.5, 4.0], {"energy": cpu}, steps=40,
                start_vectors=block.cpu())
    assert _rel_max(got["energy"], want["energy"]) <= 1e-9


def test_kpm_on_card_matches_cpu(cuda):
    """Chebyshev moments through ell_spmv (the flat t-J ring) and kpm_dos
    through the factored form's inner order (perm_gather and
    factor_matmul), both against the CPU from one block, to 1e-10 of
    mu_0."""
    from lanczosplusplus_tpu_torch.engine.kpm import (chebyshev_moments,
                                                      kpm_dos)
    from lanczosplusplus_tpu_torch.models.factored import (
        factored_hamiltonian_or_none)
    text = tj_text(10, 4, 4, periodic=1)
    cpu, gpu = _sector(text, torch.device("cpu")), _sector(text, cuda)
    block = lz.random_start_block(cpu.dim, 4, 13, torch.float64, cuda)
    bounds = (-12.0, 12.0)
    kernels.reset_launches()
    got = chebyshev_moments(gpu, block, 200, bounds)
    assert kernels.LAUNCHES["ell_spmv"] > 0
    want = chebyshev_moments(cpu, block.cpu(), 200, bounds)
    assert np.abs(got.moments - want.moments).max() <= 1e-10 * want.moments[0]
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    parts = model.default_parts(inp)
    basis = model.create_basis(parts)
    forms = [factored_hamiltonian_or_none(model, basis, parts,
                                          torch.float64, device=d)
             for d in (torch.device("cpu"), cuda)]
    kernels.reset_launches()
    got = kpm_dos(forms[1], 120, bounds=bounds, start_vectors=block)
    assert kernels.LAUNCHES["perm_gather"] > 0
    want = kpm_dos(forms[0], 120, bounds=bounds, start_vectors=block.cpu())
    assert np.abs(got.moments - want.moments).max() <= 1e-10 * want.moments[0]


def test_ftlm_dynamic_on_card_matches_cpu(cuda):
    """Engine.ftlm_local_dos (stored-V source and destination runs, the
    operator rows and the cross products on the card) and ftlm_sq_omega,
    card against CPU from one block, to 1e-9 of their maximum."""
    from chip_smoke import super_hubbard_text
    omegas = np.linspace(-8.0, 8.0, 161)
    for text, call in (
            (super_hubbard_text(8),
             lambda e, v: e.ftlm_local_dos("c", 0, 1.5, omegas, delta=0.2,
                                           steps=30, start_vectors=v)),
            (heisenberg_text(10, 1, 5),
             lambda e, v: e.ftlm_sq_omega("sz", 0.8, omegas, delta=0.2,
                                          steps=20, start_vectors=v)[1])):
        inp = parse_input(text)
        model = build_model(inp, Geometry(inp))
        cpu = Engine(model, inp, config=Config(device="cpu"))
        gpu = Engine(model, inp, config=Config(device=cuda))
        block = lz.random_start_block(cpu.basis.size, 4, 152917,
                                      torch.float64, cuda)
        kernels.reset_launches()
        got = call(gpu, block)
        assert kernels.LAUNCHES["ell_spmv"] > 0
        want = call(cpu, block.cpu())
        assert _rel_max(got, want) <= 1e-9


@pytest.mark.parametrize("text", [hubbard_chain_text(8, 4),
                                  heisenberg_text(12, 1, 6)])
def test_consistency_on_card_matches_cpu(cuda, tmp_path, capsys, text):
    """consistency --tinf on the card against the CPU: the Lanczos and
    dense energies and the T=inf energy to 1e-10."""
    from lanczosplusplus_tpu_torch.cli import consistency_main
    path = tmp_path / "input.inp"
    path.write_text(text)
    printed = []
    for device in ("cuda", "cpu"):
        consistency_main.run(["-f", str(path), "--tinf", "--device", device])
        printed.append([float(v) for v in re.findall(
            r"= (\S+)$", capsys.readouterr().out, re.M)])
    assert len(printed[0]) == 4
    for got, want in zip(*printed):
        assert abs(got - want) <= 1e-10 * max(abs(want), 1.0)


def test_spin_orbital_cli_on_card_matches_cpu(cuda, capsys):
    from lanczosplusplus_tpu_torch.cli import spin_orbital_main
    card = spin_orbital_main.run(["4", "1", "--device", "cuda"])
    host = spin_orbital_main.run(["4", "1", "--device", "cpu"])
    capsys.readouterr()
    for got, want in zip(card, host):
        assert abs(got - want) <= 1e-10 * abs(want)
    with pytest.raises(SystemExit, match="not Hermitian"):
        spin_orbital_main.run(["2", "3", "--device", "cuda"])


def test_sector_files_on_card_match_cpu(cuda, tmp_path):
    from lanczosplusplus_tpu_torch.io_ import sector_files
    inp = parse_input(hubbard_chain_text(4, 3))
    model = build_model(inp, Geometry(inp))
    read = []
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.dat")
        assert sector_files.write_all_sectors(path, model, 4,
                                              device=device) == 25
        read.append(sector_files.read_sectors(path))
    for s, h in zip(*read):
        assert s["parts"] == h["parts"]
        np.testing.assert_allclose(s["evals"], h["evals"], rtol=0,
                                   atol=1e-12)
        for key, (dest, m) in s["operators"].items():
            assert dest == h["operators"][key][0]
            np.testing.assert_array_equal(m, h["operators"][key][1])


def test_ltlm_on_card_reckons_and_chunks(cuda, monkeypatch):
    """LTLM on the card: an over-budget run raises MemoryError before it
    allocates; a run with one-row image chunks equals one with whole
    images to 1e-12."""
    from lanczosplusplus_tpu_torch.engine import ftlm
    inp = parse_input(hubbard_chain_text(8, 4))
    model = build_model(inp, Geometry(inp))
    ham = model.hamiltonian(model.create_basis(model.default_parts(inp)),
                            device=cuda).densify_factors()
    need = ftlm.ltlm_bytes(ham.dim, 40, 3, ham.dtype)
    with monkeypatch.context() as m:
        m.setattr(lz, "default_krylov_budget", lambda device: need - 1)
        before = torch.cuda.memory_allocated(cuda)
        with pytest.raises(MemoryError, match="ltlm"):
            ftlm.ltlm(ham, [0.5, 5.0], {"energy": ham}, num_vectors=3,
                      steps=40)
        assert torch.cuda.memory_allocated(cuda) == before
    outs = []
    for chunk in (1000, 1):
        monkeypatch.setattr(ftlm, "LTLM_CHUNK_ROWS", chunk)
        outs.append(ftlm.ltlm(ham, [0.5, 5.0], {"energy": ham},
                              num_vectors=3, steps=40))
    np.testing.assert_allclose(outs[1]["energy"], outs[0]["energy"],
                               rtol=1e-12)


# -- float32 and complex64 on the fleets, estimators and symmetry paths ----

@pytest.mark.parametrize("layout", ["up", "dn"])
def test_factor_matmul_f32_batched_pitch_3003_bit_equal(cuda, layout):
    """The float32 fleet's batched products at pitch 3003 (one-element
    copies, the 14-site N_up = 8 sector's up factor): 14 states of 64 x
    3003 in one launch, each member equal bit for bit to its own 2-D call,
    a batch of one to the unbatched call, and the whole to the plain
    version to 1e-5 of max |y|."""
    g = torch.Generator(device=cuda).manual_seed(3003)
    rows, szd, szu = 14, 64, 3003
    xb = torch.randn(rows, szd, szu, generator=g, device=cuda)
    yb = torch.randn(rows, szd, szu, generator=g, device=cuda)
    if layout == "up":
        a = torch.randn(szu, szu, generator=g, device=cuda)
        x, y0 = xb.view(rows * szd, szu), yb.view(rows * szd, szu)
        got = kernels.factor_matmul(x, a, out=y0.clone(), accumulate=True)
        members = [kernels.factor_matmul(xb[b], a, out=yb[b].clone(),
                                         accumulate=True)
                   for b in range(rows)]
        assert torch.equal(got.view(rows, szd, szu), torch.stack(members))
        ref = y0 + kernels.factor_matmul_ref(x, a)
        one = kernels.factor_matmul(xb[:1], a)
        assert torch.equal(one[0], kernels.factor_matmul(xb[0], a))
    else:
        a = torch.randn(szd, szd, generator=g, device=cuda)
        xt = xb.transpose(1, 2)
        got = yb.clone()
        kernels.factor_matmul(xt, a, out=got.transpose(1, 2),
                              accumulate=True)
        for b in range(rows):
            one = yb[b].clone()
            kernels.factor_matmul(xt[b], a, out=one.T, accumulate=True)
            assert torch.equal(one, got[b])
        ref = yb + torch.matmul(a, xb)
        single = yb[:1].clone()
        kernels.factor_matmul(xt[:1], a, out=single.transpose(1, 2),
                              accumulate=True)
        assert torch.equal(single[0], got[0])
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5


def _f32_ell_case(diag, cols, vals, rows, gen, tol):
    """ell_spmv on a block of `rows` states: one launch, the plain version
    to `tol` of max |y|, every member and a batch of one equal to their 1-D
    calls bit for bit."""
    x = torch.randn(rows, diag.shape[0], generator=gen, device=diag.device,
                    dtype=diag.dtype)
    sliced = kernels.slice_ell(cols, vals)
    kernels.reset_launches()
    got = kernels.ell_spmv(diag, cols, vals, x, sliced=sliced)
    assert kernels.FORM_LAUNCHES == {
        f"ell_spmv {kernels._SUFFIX[diag.dtype]}": 1}
    assert _rel(got, kernels.ell_spmv_ref(diag, cols, vals, x)) <= tol
    for b in range(rows):
        assert torch.equal(got[b], kernels.ell_spmv(diag, cols, vals, x[b],
                                                    sliced=sliced))
    assert torch.equal(
        kernels.ell_spmv(diag, cols, vals, x[:1], sliced=sliced)[0],
        kernels.ell_spmv(diag, cols, vals, x[0], sliced=sliced))


def test_ell_spmv_f32_fleet_at_r23(cuda):
    """The float32 TSPCenter fleet's shape: a SuperHubbardExtended J-ELL
    (the 6-site chain's N_up = 4 sector, narrowed from float64) at R =
    23."""
    from lanczosplusplus_tpu_torch.ops.refine import narrowed
    inp = parse_input(SUPER6)
    model = build_model(inp, Geometry(inp))
    ham = narrowed(model.hamiltonian(model.create_basis((4, 3)),
                                     device=cuda))
    assert ham.dtype == torch.float32 and ham.ell is not None
    _f32_ell_case(ham.diag, ham.ell.cols, ham.ell.vals, 23,
                  torch.Generator(device=cuda).manual_seed(23), 1e-5)


@pytest.mark.parametrize("label, dtype", [
    ("UseTranslationSymmetry=1\n", torch.complex64),
    ("UseReflectionSymmetry=1\n", torch.float32)],
    ids=["momentum_c64", "parity_f32"])
def test_ell_spmv_on_float32_symmetry_blocks_at_r14(cuda, label, dtype):
    """The largest complex64 momentum block and float32 parity block of
    the 10-site (3, 3) chain, each the float64 block narrowed
    (block_pair), at R = 14."""
    periodic = int(dtype.is_complex)
    sym = _symmetry_of(hubbard_chain_text(10, 4, 3, 3, periodic=periodic),
                       label, cuda)
    pairs = [sym.block_pair(s, torch.float32) for s in range(sym.sectors())]
    blk, wide = max(((b, w) for b, w in pairs
                     if b is not None and b.dtype == dtype),
                    key=lambda bw: bw[0].dim)
    assert blk.diag.dtype == dtype and blk.ell.cols is wide.ell.cols
    _f32_ell_case(blk.diag, blk.ell.cols, blk.ell.vals, 14,
                  torch.Generator(device=cuda).manual_seed(14), 1e-5)


def test_float32_paths_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """--dtype float32 on the card against the same on the CPU: the 8-site
    chain's DOS fleet (the float32 batched GEMMs; densities at delta 0.1
    to 1e-4 of their maximum, #CFEnergy= to 1e-10), its complex64 momentum
    blocks (complex64 ell_spmv; refined E0 to 1e-10) and the 8-site Kitaev
    ring by projection (float32 GEMMs; E0 to 1e-10)."""
    from lanczosplusplus_tpu_torch.cli import lanczos_main
    from lanczosplusplus_tpu_torch.engine.spectral import read_collection
    monkeypatch.chdir(tmp_path)
    text = hubbard_chain_text(8, 4) + "ComputeDensityOfStates=1\n"
    omegas = np.linspace(-8, 8, 161)
    curves, energies = {}, {}
    for device in ("cpu", "cuda"):
        where = tmp_path / device
        where.mkdir()
        monkeypatch.chdir(where)
        (where / "in.inp").write_text(text)
        kernels.reset_launches()
        eng = lanczos_main.run(["-f", "in.inp", "--device", device,
                                "--dtype", "float32", "-g", "c"])
        if device == "cuda":
            assert kernels.FORM_LAUNCHES.get("factor_matmul f32", 0) > 0
        colls = [read_collection(str(where / f"in.inp{i}.comb"))
                 for i in range(8)]
        curves[device] = np.stack([-c.evaluate(omegas, 0.1).imag
                                   for c in colls])
        energies[device] = [cf.e0 for c in colls for cf in c.items]
        assert eng.eigenvector(0).dtype == torch.float32
    assert _rel(torch.as_tensor(curves["cuda"]),
                torch.as_tensor(curves["cpu"])) <= 1e-4
    assert max(abs(a - b) for a, b in zip(energies["cuda"],
                                          energies["cpu"])) <= 1e-9
    for projected in (False, True):
        text = (kitaev_text(8, 1.1, 0.7, 0.9, periodic=1).replace(
            "SolverOptions=none", "SolverOptions=projected") if projected
            else hubbard_chain_text(8, 4, 2, 3)) + "UseTranslationSymmetry=1\n"
        e0 = {}
        for device in ("cpu", cuda):
            inp = parse_input(text)
            kernels.reset_launches()
            eng = Engine(build_model(inp, Geometry(inp)), inp,
                         config=Config.from_input(inp, device=device,
                                                  real_dtype=torch.float32))
            e0[str(device)] = eng.ground_energy
            if device == cuda:
                form = "factor_matmul f32" if projected else "ell_spmv c64"
                assert kernels.FORM_LAUNCHES.get(form, 0) > 0
        assert abs(e0["cuda"] - e0["cpu"]) <= 1e-10 * abs(e0["cpu"])
