"""The port's float32, complex64 and bfloat16 forms held against the JAX
package on the CPU, the port on the plain versions of its kernels: the
bf16 form of ``factor_matmul`` against the Pallas kernel's bf16 contract,
``perm_gather`` in float32, complex64 and from a bfloat16 source block
(bf16cross) against ``_perm_cross_apply``, ``densify_factors(factor_dtype=
bf16)`` and bf16 Kitaev factors against the JAX forms, the bf16cross
Engine energy, and the pure parts of the bf16 kernel (``wgmma`` fed by
TMA): its plan over the paths' layouts, the repack of an operand TMA
cannot address, the m64nNk16 accumulator table and the shared-memory
descriptors against TMA's swizzled layout.

Tolerances.  A bf16 product is exact in float32, so the two packages'
float32 sums of the same bf16 operands differ by their order only: 1e-5
of max |y|.  The JAX package's bf16cross column-dedup path rounds each
column group's summed row side to bf16 before its column gather
(``core/blockkron.py:207``; ROADMAP Queue 3 item 3); the port's kernel
and plain version keep that sum in the state's type.  One bf16 rounding
of the pre-sum is 2^-9 of it, so where a term has column groups of more
than one channel the two applies are held to 4e-3 of max |y|; without
such groups (and without the bf16 cast) they agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.core import blockkron as jbk
from lanczosplusplus_tpu.engine import Engine as JaxEngine
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu.models import (
    factored_hamiltonian_or_none as jax_factored)
from lanczosplusplus_tpu.models.kitaev_factored import (
    build_factored_kitaev as jax_build_kitaev)
from lanczosplusplus_tpu.ops import pallas_kernels as pk
from lanczosplusplus_tpu_torch import Config
from lanczosplusplus_tpu_torch.core.blockkron import make_perm_cross
from lanczosplusplus_tpu_torch.engine import Engine
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from lanczosplusplus_tpu_torch.models.factored import (
    factored_hamiltonian_or_none)
from lanczosplusplus_tpu_torch.models.kitaev_factored import (
    build_factored_kitaev)
from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from test_torch_host import hubbard_chain_text
from test_torch_inputs import _term, kitaev_text, rashba_text, tj_text

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _rel(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want,
                                                           np.complex128)
    return np.abs(got - want).max() / np.abs(want).max()


def _models(text):
    inp, jinp = parse_input(text), jax_parse(text)
    model = build_model(inp, Geometry(inp))
    jmodel = jax_build_model(jinp, JaxGeometry(jinp))
    parts = model.default_parts(inp)
    return model, model.create_basis(parts), jmodel, \
        jmodel.create_basis(parts), parts


@pytest.mark.parametrize("m,n,k", [(300, 123, 257), (64, 64, 16),
                                   (129, 1, 300)])
def test_factor_matmul_bf16_ref_matches_pallas(m, n, k):
    """bfloat16 operands, float32 sums: the TPU kernel's own contract
    (``preferred_element_type=jnp.float32``), run as
    tests/test_torch_kernels.py runs the float32 one.  The Pallas kernel
    stores its float32 sums in the operands' type, bf16; the port's form
    keeps them in float32 (or adds them into a float64 out), as the JAX
    package's bf16 GEMMs (``dot_general(..., preferred_element_type=
    x.dtype)``) do: held to those sums to 1e-5, and to the Pallas output
    within its one bf16 rounding (2^-8)."""
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = rng.standard_normal((n, k)).astype(np.float32)
    xb, ab = jnp.asarray(x, jnp.bfloat16), jnp.asarray(a, jnp.bfloat16)
    pallas = np.asarray(pk.factor_matmul(xb, ab, tile_m=128, tile_n=128,
                                         tile_k=128)).astype(np.float32)
    expect = np.asarray(jax.lax.dot_general(
        xb, ab, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))
    got = kernels.factor_matmul_ref(torch.from_numpy(x).to(BF16),
                                    torch.from_numpy(a).to(BF16))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), expect) <= 1e-5
    assert np.abs(got.numpy() - pallas).max() <= 2.0 ** -8 * np.abs(
        pallas).max()
    # the wrapper's CPU path: into a float64 out, added
    y0 = torch.from_numpy(rng.standard_normal((m, n)))
    out = kernels.factor_matmul(torch.from_numpy(x).to(BF16),
                                torch.from_numpy(a).to(BF16), out=y0.clone(),
                                accumulate=True)
    assert out.dtype == torch.float64
    assert _rel(out.numpy(), y0.numpy() + expect) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("batched", [False, True])
def test_perm_gather_f32_c64_matches_perm_cross_apply(dtype, batched):
    """perm_gather's plain version in float32 and complex64 against JAX
    ``_perm_cross_apply(_batched)`` on one term's random tables, with
    shared row maps and column groups."""
    rng = np.random.default_rng(4)
    nb, rd, rs, cd, cs = 6, 13, 17, 21, 19
    row_src = rng.integers(0, rs, (nb, rd)).astype(np.int32)
    row_src[3] = row_src[0]                      # a shared row map
    col_src = rng.integers(0, cs, (nb, cd)).astype(np.int32)
    row_amp = rng.standard_normal((nb, rd))
    col_amp = rng.standard_normal((nb, cd))
    col_src[4], col_amp[4] = col_src[1], col_amp[1]   # a column group
    npdt = np.complex64 if dtype.is_complex else np.float32
    if dtype.is_complex:
        row_amp = row_amp + 1j * rng.standard_normal((nb, rd))
    shape = (3, rs, cs) if batched else (rs, cs)
    x = rng.standard_normal(shape).astype(npdt)
    jt = jbk.make_perm_cross(row_src, row_amp, col_src, col_amp, 0, 0, npdt)
    apply = jbk._perm_cross_apply_batched if batched else \
        jbk._perm_cross_apply
    want = np.asarray(apply(jt, jnp.asarray(x)))
    t = make_perm_cross(row_src, row_amp, col_src, col_amp, 0, 0, dtype)
    out = torch.zeros(want.shape, dtype=dtype)
    kernels.perm_gather(torch.from_numpy(x), out, rs=t.row_src,
                        a=t.row_amp, cs=t.col_src, beta=t.col_amp,
                        groups=t.groups, col_groups=t.col_groups)
    assert _rel(out.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dedup", [False, True])
def test_perm_gather_bf16_source_matches_jax_state_cast(dtype, dedup):
    """make_perm_cross(cross_dtype=bf16) and its apply against the JAX
    package's (state_cast "bf16"): the same bf16 source block, amplitudes
    and sums in the state's type.  Without column groups the two agree to
    float32 rounding; with them, within the extra bf16 rounding of JAX's
    column-dedup path (see the module docstring)."""
    rng = np.random.default_rng(8 + dedup)
    nb, rd, rs, cd, cs = 5, 11, 14, 16, 15
    row_src = rng.integers(0, rs, (nb, rd)).astype(np.int32)
    col_src = rng.integers(0, cs, (nb, cd)).astype(np.int32)
    row_amp = rng.standard_normal((nb, rd))
    col_amp = rng.standard_normal((nb, cd))
    if dedup:
        col_src[2], col_amp[2] = col_src[0], col_amp[0]
        col_src[3], col_amp[3] = col_src[0], col_amp[0]
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = rng.standard_normal((rs, cs)).astype(npdt)
    jt = jbk.make_perm_cross(row_src, row_amp, col_src, col_amp, 0, 0, npdt,
                             cross_dtype=jnp.bfloat16)
    assert jt.state_cast == "bf16"
    want = np.asarray(jbk._perm_cross_apply(jt, jnp.asarray(x)))
    t = make_perm_cross(row_src, row_amp, col_src, col_amp, 0, 0, dtype,
                        cross_dtype=BF16)
    assert t.state_cast == "bf16"
    assert any(len(g) > 1 for g in t.col_groups) == dedup
    out = torch.zeros(want.shape, dtype=dtype)
    kernels.perm_gather(torch.from_numpy(x).to(BF16), out, rs=t.row_src,
                        a=t.row_amp, cs=t.col_src, beta=t.col_amp,
                        groups=t.groups, col_groups=t.col_groups)
    assert out.dtype == dtype
    assert _rel(out.numpy(), want) <= (4e-3 if dedup else 1e-5)
    # the plain version of the kernel's form: the block widened, then the
    # ordinary sums; the full-precision block differs by the bf16 cast
    widened = kernels.perm_gather_ref(torch.from_numpy(x).to(BF16).to(dtype),
                                      torch.zeros_like(out), t.row_src,
                                      t.row_amp, t.col_src, t.col_amp)
    assert _rel(out.numpy(), widened.numpy()) <= 1e-5
    exact = kernels.perm_gather_ref(torch.from_numpy(x),
                                    torch.zeros_like(out), t.row_src,
                                    t.row_amp, t.col_src, t.col_amp)
    assert 0 < _rel(out.numpy(), exact.numpy()) <= 4e-3


_jax_matvec = jax.jit(lambda form, x: form.matvec(x))


@pytest.mark.parametrize("text", [
    rashba_text(6, 5, r=0.5, u=4.0, periodic=1),
    tj_text(7, 3, 3, periodic=1)], ids=["rashba6", "tj7"])
def test_bf16cross_forms_match_jax(text):
    """The bf16cross half-cut Rashba and t-J forms (float32), built by both
    packages, applied to one state: within the column-dedup rounding of
    each other, quantized, and within bf16 of the unquantized form."""
    model, basis, jmodel, jbasis, parts = _models(text)
    form = factored_hamiltonian_or_none(model, basis, parts, torch.float32,
                                        cross_dtype=BF16)
    exact = factored_hamiltonian_or_none(model, basis, parts, torch.float32)
    jform = jax_factored(jmodel, jbasis, parts, np.float32,
                         cross_dtype=jnp.bfloat16)
    assert form.quantized and jform.quantized and not exact.quantized
    inner = getattr(form, "inner", form)
    assert all(t.state_cast == "bf16" for t in inner.perm_cross)
    x = np.random.default_rng(5).standard_normal(form.dim).astype(np.float32)
    y = form.matvec(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(_jax_matvec(jform, jnp.asarray(x)))) <= 4e-3
    assert _rel(y, exact.matvec(torch.from_numpy(x)).numpy()) <= 1e-2


def test_bf16cross_engine_solves_exactly():
    """tests/test_fallback.py::test_bf16cross_option_solves_exactly on the
    port: SolverOptions=factored,bf16cross on the 6-site real Rashba ring
    reaches the JAX package's factored energy to 1e-8 through the
    refinement, in float64 and in float32, with full reorthogonalization."""
    n, ne = 6, 6
    base = (f"TotalNumberOfSites={n}\nNumberOfTerms=2\n"
            + _term(-1.0) + _term(0.5)
            + "Model=HubbardOneBandRashbaSOC\n"
            + f"hubbardU {n} {' '.join(['4'] * n)}\n"
            + f"potentialV {2 * n} {' '.join(['0'] * 2 * n)}\n"
            + f"TargetElectronsTotal={ne}\nIsPeriodicX=1\n")
    jinp = jax_parse(base + "SolverOptions=factored\n")
    e_ref = JaxEngine(jax_build_model(jinp, JaxGeometry(jinp)),
                      jinp).ground_energy
    inp = parse_input(base + "SolverOptions=factored,bf16cross\n")
    model = build_model(inp, Geometry(inp))
    for real in (torch.float64, torch.float32):
        eng = Engine(model, inp, config=Config(device="cpu",
                                               real_dtype=real))
        ham = eng._cached_hamiltonian(eng.parts)
        assert ham.quantized and ham.inner.perm_cross[0].state_cast == "bf16"
        assert eng.ground_energy == pytest.approx(e_ref, abs=1e-8)


def test_bf16cross_skips_complex_states():
    """As in the JAX Engine, a complex scalar type gathers at full
    precision: useComplex never casts."""
    text = rashba_text(5, 4, r="(0.3,0.4)", u=4.0, periodic=1,
                       options="useComplex,factored,bf16cross")
    inp = parse_input(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp,
                 config=Config.from_input(inp, device="cpu"))
    form = eng._cached_hamiltonian(eng.parts)
    assert form.dtype == torch.complex128 and not form.quantized


def test_kitaev_bf16_factors_match_jax():
    """build_factored_kitaev(factor_dtype=bf16): within 2e-2 of max |y| of
    the float32 form (tests/test_kitaev_factored.py:89-101), its factors
    equal to the JAX package's bit for bit, and its matvec (the state and
    P_k X rounded to bf16, float32 sums) equal to the JAX matvec to
    float32 rounding; quantized."""
    model, basis, jmodel, jbasis, _ = _models(
        kitaev_text(8, 1.1, 0.7, 0.9, periodic=1))
    f32 = build_factored_kitaev(model, basis, dtype=torch.float32)
    b16 = build_factored_kitaev(model, basis, dtype=torch.float32,
                                factor_dtype=BF16)
    jb16 = jax_build_kitaev(jmodel, jbasis, dtype=np.float32,
                            factor_dtype=jnp.bfloat16)
    assert b16.quantized and not f32.quantized and b16.hl.dtype == BF16
    for name in ("hl", "hr_t", "p", "q"):
        assert np.array_equal(
            getattr(b16, name).float().numpy(),
            np.asarray(getattr(jb16, name)).astype(np.float32))
    x = np.random.default_rng(2).standard_normal(f32.dim).astype(np.float32)
    y16 = b16.matvec(torch.from_numpy(x))
    y32 = f32.matvec(torch.from_numpy(x)).numpy()
    assert y16.dtype == torch.float32
    assert np.abs(y16.numpy() - y32).max() < 2e-2 * np.abs(y32).max()
    assert _rel(y16.numpy(), np.asarray(_jax_matvec(jb16, jnp.asarray(x)))) \
        <= 1e-5
    batch = torch.from_numpy(np.stack([x, 2 * x]))
    assert _rel(b16.matmat_t(batch)[1].numpy(), 2 * y16.numpy()) <= 1e-5


def test_densify_factors_bf16_matches_jax():
    """densify_factors(factor_dtype=bf16) on the 8-site Hubbard chain in
    float32: the dense factors equal the JAX package's, the matvec (state
    rounded to bf16 for the GEMMs) equals JAX's to float32 rounding; the
    form is quantized and its gather maps stay in float32."""
    model, basis, jmodel, jbasis, _ = _models(hubbard_chain_text(8))
    ham = model.hamiltonian(basis, dtype=torch.float32)
    hb = ham.densify_factors(factor_dtype=BF16)
    jhb = jmodel.hamiltonian(jbasis, dtype=np.float32).densify_factors(
        factor_dtype=jnp.bfloat16)
    f = hb.factorized
    assert hb.quantized and not ham.quantized and hb.dtype == torch.float32
    assert f.up_dense.dtype == BF16 and f.up_vals.dtype == torch.float32
    assert np.array_equal(f.up_dense.float().numpy(), np.asarray(
        jhb.factorized.up_dense).astype(np.float32))
    x = np.random.default_rng(6).standard_normal(ham.dim).astype(np.float32)
    y = hb.matvec(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(_jax_matvec(jhb, jnp.asarray(x)))) <= 1e-5
    assert _rel(y, ham.matvec(torch.from_numpy(x)).numpy()) <= 1e-2
    with pytest.raises(ValueError, match="real state"):
        model.hamiltonian(basis, dtype=torch.complex64).densify_factors(
            factor_dtype=BF16)


def test_densify_factors_bf16_under_a_float64_state():
    """densify_factors(factor_dtype=bf16) under a float64 state (the bf16
    factor_matmul into float64): the matvec equals the JAX package's on
    the same bf16 factors to float32 rounding, stays in float64, and
    lowest_states refines its E0 to the float64 form's within 1e-10 (the
    hop amplitudes, 1, are exact in bf16)."""
    model, basis, jmodel, jbasis, _ = _models(hubbard_chain_text(8))
    ham = model.hamiltonian(basis, dtype=torch.float64)
    hb = ham.densify_factors(factor_dtype=BF16)
    jhb = jmodel.hamiltonian(jbasis, dtype=np.float64).densify_factors(
        factor_dtype=jnp.bfloat16)
    assert hb.quantized and hb.dtype == torch.float64
    assert hb.factorized.dn_dense.dtype == BF16
    x = np.random.default_rng(8).standard_normal(ham.dim)
    y = hb.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert _rel(y.numpy(), np.asarray(_jax_matvec(jhb, jnp.asarray(x)))) \
        <= 1e-5
    e64 = float(lz.lowest_states(ham)[0][0])
    eb = float(lz.lowest_states(hb)[0][0])
    assert abs(eb - e64) <= 1e-10 * abs(e64)


def test_float32_engine_drops_the_float64_form_after_refining():
    """A float32 Engine holds its target sector's float64 form only until
    the ground state is refined: none is held afterwards, also when the
    flat form of a factored solve is built later for the observables."""
    text = tj_text(7, 3, 3, periodic=1).replace("SolverOptions=none",
                                                "SolverOptions=factored")
    inp = parse_input(text)
    eng = Engine(build_model(inp, Geometry(inp)), inp,
                 config=Config(device="cpu", real_dtype=torch.float32))
    assert eng._factored
    assert eng._cached_hamiltonian(eng.parts).dtype == torch.float32
    assert eng._ham64 is None
    assert eng.hamiltonian.dtype == torch.float32
    assert eng._ham64 is None


BASE = 1 << 20   # a 16-byte aligned address


def _bf16_case(case):
    """(plan arguments, expected plan) for the layouts the paths hand the
    bf16 kernel and for the card tests' odd ones: the 14-site chain's up
    and dn applies (14h), the Kitaev form's four products at 22 sites
    (dl = dr = 2048, K = 4 cut terms; models/kitaev_factored.py matmat_t)."""
    big, half, k4 = 3432, 2048, 4
    row, col = (big, 1), (1, big)
    hrow, hcol = (half, 1), (1, half)
    cases = {
        # X . A_up^T: both k-contiguous
        "14h up": ((BASE, row, BASE, row, big, big, big),
                   (True, True, True, True, False, False)),
        # A_dn . X as X^T . A_dn^T: X^T is row-contiguous (MN-major)
        "14h dn": ((BASE, col, BASE, row, big, big, big),
                   (False, True, True, True, False, False)),
        # X . hr_t: A = hr_t.T is row-contiguous
        "kitaev right half": ((BASE, hrow, BASE, hcol, half, half, half),
                              (True, True, False, True, False, False)),
        # Y^T += X^T . hl^T
        "kitaev left half": ((BASE, hcol, BASE, hrow, half, half, half),
                             (False, True, True, True, False, False)),
        # (P_k X)^T = X^T . P_k^T for the K terms in one launch: X^T shared
        # (batch stride 0, a 2-D map), a P_k per member (a 3-D map)
        "kitaev P_k X": ((BASE, (0, 1, half), BASE, (half * half, half, 1),
                          half, half, half, k4),
                         (False, True, True, True, False, True)),
        # [P_0 X ... P_K-1 X] [Q_0 ... Q_K-1]^T: pitch K dr
        "kitaev Q": ((BASE, (k4 * half, 1), BASE, (k4 * half, 1), half,
                      half, k4 * half),
                     (True, True, True, True, False, False)),
        # the card tests' pitches 257 and 5: not multiples of 16 bytes,
        # beside an MN-major factor of pitch 72 that TMA takes
        "pitch 257": ((BASE, (257, 1), BASE, (257, 1), 300, 123, 257),
                      (True, False, True, False, False, False)),
        "pitch 5": ((BASE, (5, 1), BASE, (1, 72), 1, 70, 5),
                    (True, False, False, True, False, False)),
        # an aligned pitch one element into its storage
        "base off 16 bytes": ((BASE + 2, row, BASE, row, big, big, big),
                              (True, False, True, True, False, False)),
        # no contiguous axis
        "strided": ((BASE, (2 * big, 2), BASE, row, big, big, big),
                    (True, False, True, True, False, False)),
        # a batch of states whose batch stride is not a multiple of 8
        "odd batch stride": ((BASE, (136 * 200 + 1, 136, 1), BASE, (136, 1),
                              200, 136, 136, 3),
                             (True, False, True, True, True, False)),
        # a pitch shorter than its row: rows that overlap
        "overlapping rows": ((BASE, (8, 1), BASE, row, 64, big, 64),
                             (True, False, True, True, False, False)),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "14h up", "14h dn", "kitaev right half", "kitaev left half",
    "kitaev P_k X", "kitaev Q", "pitch 257", "pitch 5", "base off 16 bytes",
    "strided", "odd batch stride", "overlapping rows"])
def test_bf16_plan(case):
    """The bf16 kernel's path, a pure function of pointers, strides and
    shape: each operand's majorness and whether TMA can address it where
    it lies (every path's layout can: no repack on a path) and a 3-D
    tensor map for an operand per batch member only."""
    args, expect = _bf16_case(case)
    plan = kernels.factor_matmul_bf16_plan(*args)
    assert tuple(plan) == expect
    assert plan.bits == (expect[0] | expect[2] << 1 | expect[4] << 2
                         | expect[5] << 3)


@pytest.mark.parametrize("layout", ["pitch 257", "transposed pitch 33",
                                    "shared, pitch 5", "aligned"])
def test_tma_operand_repacks_on_cpu(layout):
    """An operand TMA cannot address is copied k-major into a zero-padded
    buffer whose pitch is a multiple of 8 elements: the same values, whose
    plain product is the original's (to float32 rounding, the sums'
    order); an aligned one is handed back as it is."""
    rng = np.random.default_rng(12)
    bf = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape)).to(BF16)
    a = bf(24, 257)
    if layout == "pitch 257":
        x = bf(40, 257)
    elif layout == "transposed pitch 33":
        x, a = bf(33, 257).T, bf(24, 33)
    elif layout == "shared, pitch 5":
        x, a = bf(6, 5).expand(3, 6, 5), bf(3, 24, 5)
    else:
        x, a = bf(40, 256), bf(24, 256)
    ready = kernels.tma_operand(x)
    if layout == "aligned":
        assert ready is x
    else:
        assert ready is not x and ready.shape == x.shape
        *_, rows, k = ready.shape
        batch = ready.shape[0] if ready.dim() == 3 else 1
        assert ready.stride(-1) == 1 and ready.stride(-2) % 8 == 0
        assert kernels._tma_layout(ready.data_ptr(), rows, k, ready.stride(),
                                   batch) == (True, True)
        if layout == "shared, pitch 5":
            assert ready.stride(0) == 0   # one member's copy, expanded
        base = ready[0] if ready.dim() == 3 else ready
        pitch = base.stride(0)
        padded = torch.as_strided(base, (rows, pitch), (pitch, 1))
        assert (padded[:, k:] == 0).all()
    assert torch.equal(ready, x)
    np.testing.assert_allclose(kernels.factor_matmul_ref(ready, a).numpy(),
                               kernels.factor_matmul_ref(x, a).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [128, 256])
def test_wgmma_accumulator_map_covers_tile(n):
    """Every element of a warpgroup's 64 x n tile is held by exactly one
    (thread, register), n / 2 registers a thread."""
    acc = kernels.wgmma_accumulator_map(n)
    assert sorted(acc.values()) == [(r, c) for r in range(64)
                                    for c in range(n)]
    assert sorted(acc) == [(t, i) for t in range(128) for i in range(n // 2)]


def test_wgmma_accumulator_map_multiplies():
    """The bf16 kernel's stores, copied here from csrc/factor_matmul.cu
    (row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    2 (t % 4) + i % 2 of register i of thread t), put the sums the table
    says each register holds where X . A^T has them."""
    rng = np.random.default_rng(13)
    n, k = 128, 16
    x = rng.standard_normal((64, k))
    a = rng.standard_normal((n, k))
    sums = {held: x[r] @ a[c]
            for held, (r, c) in kernels.wgmma_accumulator_map(n).items()}
    y = np.full((64, n), np.nan)
    for t in range(128):
        row0, col0 = 16 * (t // 32) + (t % 32) // 4, 2 * (t % 4)
        for i in range(n // 2):
            y[row0 + 8 * ((i // 2) % 2), col0 + 8 * (i // 4) + i % 2] = \
                sums[t, i]
    np.testing.assert_allclose(y, x @ a.T, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kmajor", [True, False])
def test_wgmma_descriptors_read_what_tma_wrote(kmajor):
    """For every element (row, k) of a stage's 128-row tile, the byte the
    kernel's wgmma descriptor (start + its k16 step, LBO, SBO, 128-byte
    swizzle) reads is the byte TMA wrote it to, and the tile's bytes are
    each read once."""
    rows, depth = kernels.WGMMA_TILE_M, kernels.WGMMA_STAGE_K
    read = {}
    for row in range(rows):
        for k in range(depth):
            offset = kernels.wgmma_smem_offset(kmajor, row, k)
            assert offset == kernels.tma_smem_offset(kmajor, row, k)
            read[offset] = (row, k)
    assert sorted(read) == list(range(0, 2 * rows * depth, 2))
