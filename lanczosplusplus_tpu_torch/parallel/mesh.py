"""Row-partitioned distribution of sector Hamiltonians over ranks.

Counterpart of ``lanczosplusplus_tpu/parallel/mesh.py``.  The JAX package
shards one global array over a device ``Mesh`` and lets GSPMD insert the
collectives.  Here every rank is a process of a ``torch.distributed``
group (NCCL on the card, gloo on the CPU) that holds its own rows: the
padded sector dimension is cut into ``size`` equal shards, rank r owning
rows ``[r * shard, (r + 1) * shard)``, the JAX package's layout, so its
plans and results compare with the port's.  Padding appends decoupled
zero rows; the Kronecker forms pad size_down instead.

A sharded form (``ShardedHamiltonian``, ``kron.KronHamiltonian``,
``halo.HaloHamiltonian``, ``halo.KronHaloHamiltonian``,
``blockkron_dist.DistBlockKron``) carries its ``Mesh``; ``dim`` is the
padded global dimension and ``rows`` this rank's share.  The port's own
solver and estimators run on it unchanged: they take vectors of this
rank's rows and sum every dot and norm over the ranks when the form has a
mesh (``solver/lanczos._allsum``).  Those sums all-gather the partial
sums and add them up in rank order, so every rank gets the same bits and
takes the same branches.

Transports (``Mesh.transport``, chosen once from the group's backend,
never switched because a call failed): ``nccl``, or ``gloo``, which takes
CPU tensors and, for ranks that share one card, CUDA tensors as they are
(on the H100 host it gives both collectives back bit for bit in every
type of state: ``chip_smoke.py`` phase 16b checks it).

Collectives are ``all_gather`` (a list of views of one buffer) and
``all_to_all_single``, which every torch version of the port's hosts takes
without a deprecation warning; complex tensors travel as their real
views.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from lanczosplusplus_tpu_torch.ops import kernels
from lanczosplusplus_tpu_torch.solver import lanczos as lz

ROWS = "rows"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as a collective takes it: a complex tensor as its real view."""
    return torch.view_as_real(t) if t.is_complex() else t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis (``ROWS``) of ranks: the process group, this rank, the
    group's size, the device this rank's rows live on, and the transport
    of its collectives."""
    group: object
    rank: int
    size: int
    device: torch.device
    transport: str

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        t = t.resolve_conj().contiguous()
        out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(_wire(out).unbind(0)), _wire(t),
                        group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t (size, ...): slab s goes to rank s; returns (size, ...), slab
        s from rank s."""
        t = t.resolve_conj().contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(_wire(out), _wire(t), group=self.group)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t summed in rank order: the same bits on every
        rank."""
        return self.all_gather(t).sum(0)

    def norm(self, t: torch.Tensor, dim=None, keepdim=False) -> torch.Tensor:
        """``vector_norm`` over all ranks' rows: the local norms gathered
        and combined (at size 1, the local norm itself)."""
        local = torch.linalg.vector_norm(t, dim=dim, keepdim=keepdim)
        gathered = self.all_gather(local)
        if self.size == 1:
            return gathered[0]
        return torch.linalg.vector_norm(gathered, dim=0)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole padded vector (..., size * rows) from every rank's
        rows (..., rows)."""
        g = self.all_gather(x)
        if x.dim() == 1:
            return g.reshape(-1)
        return g.movedim(0, -2).reshape(*x.shape[:-1], -1)

    def local_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole vector (or batch-major block) of
        length up to `dim` (the padded dimension), zero-padded to it."""
        shard = dim // self.size
        x = torch.as_tensor(x, device=self.device)
        if x.shape[-1] < dim:
            x = torch.nn.functional.pad(x, (0, dim - x.shape[-1]))
        return x[..., self.rank * shard:(self.rank + 1) * shard].contiguous()


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of a process group (the default one, as ``torchrun`` sets
    it up, when `group` is None).  This rank's device defaults to
    ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank modulo the
    cards); it raises when no process group is initialised, or when no
    card is present and the caller did not name the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group "
                           "is initialised (init_process_group, or run "
                           "under torchrun)")
    group = group if group is not None else dist.group.WORLD
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch.cuda.is_available() is "
                               "False; pass device='cpu' for a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: device {device} requested but "
                           f"torch.cuda.is_available() is False")
    transport = str(dist.get_backend(group)).lower()
    if transport not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {transport!r}; the port runs "
                         f"on nccl or gloo")
    if transport == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs a CUDA device")
    return Mesh(group=group, rank=rank, size=size, device=device,
                transport=transport)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _to_device(a: np.ndarray, mesh: Mesh, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(a), device=mesh.device)
    return t if dtype is None else t.to(dtype)


@dataclasses.dataclass(frozen=True)
class ShardedHamiltonian:
    """This rank's rows of the padded flat ELL form: the diagonal and ELL
    rows whose columns index the whole padded state.  A matvec
    all-gathers the state and runs ``ell_spmv`` on the local rows with
    the gathered state as the gathers' source."""
    diag: torch.Tensor        # (rows,)
    ell: object               # core.sparse.EllPart, (rows, K), global cols
    mesh: Mesh
    padded_dim: int

    @property
    def dim(self) -> int:
        return self.padded_dim

    @property
    def rows(self) -> int:
        return self.diag.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matmat_t(self, xk: torch.Tensor) -> torch.Tensor:
        """H on this rank's rows of one state (rows,) or of a batch-major
        block (R, rows)."""
        src = self.mesh.gather_rows(xk)
        sliced = self.ell.sliced() if xk.is_cuda else None
        return kernels.ell_spmv(self.diag, self.ell.cols, self.ell.vals, xk,
                                sliced=sliced, src=src)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat_t(x)


def shard_hamiltonian(ham, mesh: Mesh) -> ShardedHamiltonian:
    """Pad and ELL-flatten a Hamiltonian (``flatten_to_ell_host``, the
    layout of ``Hamiltonian.padded``) and keep this rank's rows on its
    device."""
    from lanczosplusplus_tpu_torch.core.sparse import (EllPart,
                                                       flatten_to_ell_host)
    diag, cols, vals = flatten_to_ell_host(ham, mesh.size)
    dimp = diag.shape[0]
    shard = dimp // mesh.size
    lo, hi = mesh.rank * shard, (mesh.rank + 1) * shard
    return ShardedHamiltonian(
        diag=_to_device(diag[lo:hi], mesh, ham.dtype),
        ell=EllPart(cols=_to_device(cols[lo:hi], mesh, torch.int32),
                    vals=_to_device(vals[lo:hi], mesh, ham.dtype)),
        mesh=mesh, padded_dim=dimp)


def sharded_vector(x, mesh: Mesh, dim: int | None = None) -> torch.Tensor:
    """This rank's rows of the whole vector x (or batch-major block),
    zero-padded to `dim` (default: the next multiple of the mesh size)."""
    x = torch.as_tensor(x)
    dim = dim or _pad_to(x.shape[-1], mesh.size)
    return mesh.local_rows(x, dim)


def _is_wrapped(ham) -> bool:
    """A ``PermutedHamiltonian`` (a factored form in flat order)."""
    return hasattr(ham, "inner") and hasattr(ham, "perm")


def shard_for_mesh(ham, mesh: Mesh, prefer_kron: bool = True):
    """Place a sector Hamiltonian on `mesh` in its best distributed form:
    a block-factorized form (``BlockKronHamiltonian``, or a
    ``PermutedHamiltonian`` wrapping one, in block order) column-sharded
    (``blockkron_dist``); else the Kronecker form (``kron``: shard-local
    up GEMM, one all-gather for the dn factor) when the Hamiltonian has
    spin factors that densify; else the padded flat ELL.  A form that is
    sharded already comes back as it is."""
    if getattr(ham, "mesh", None) is not None:
        return ham
    if _is_wrapped(ham):
        ham = ham.inner
    if hasattr(ham, "shapes"):
        from lanczosplusplus_tpu_torch.parallel.blockkron_dist import \
            shard_blockkron
        return shard_blockkron(ham, mesh)
    if prefer_kron and getattr(ham, "factorized", None) is not None:
        from lanczosplusplus_tpu_torch.parallel.kron import \
            shard_kron_hamiltonian
        try:
            return shard_kron_hamiltonian(ham, mesh)[0]
        except ValueError:
            pass    # factors too large to densify: the flat ELL
    return shard_hamiltonian(ham, mesh)


def _finish(alphas, betas, V: torch.Tensor, num_states: int, mesh: Mesh):
    """``lz.finish_lanczos`` over a row-sharded basis: (evals, this rank's
    rows of the normalized Ritz vectors)."""
    alphas, betas, m = lz.trim_at_breakdown(alphas, betas)
    evals, evecs = lz.tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = lz._combine(V, evecs[:, :k])
    return evals[:k], vecs / mesh.norm(vecs, dim=1, keepdim=True)


def _sharded_plain_solve(sham, mesh: Mesh, v0: torch.Tensor,
                         orig_dim: int, num_states: int, max_steps: int):
    """Distributed plain two-pass Lanczos: two stored vectors a rank, the
    fallback when the stored Krylov basis would exceed the budget.  The
    first pass builds (alpha, beta), the host eigensolves, the second
    replays the recurrence to accumulate the Ritz vectors.  Returns
    (evals, this rank's rows of the vectors)."""
    steps = int(min(orig_dim, max_steps))
    alphas, betas = lz._plain_pass(sham, v0, steps)
    alphas, betas, m = lz.trim_at_breakdown(alphas, betas)
    evals, evecs = lz.tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = []
    for i in range(k):
        wts = np.zeros(steps)
        wts[:m] = evecs[:, i]
        acc = lz._plain_pass(sham, v0, steps, weights=wts)
        vecs.append(acc / mesh.norm(acc))
    return evals[:k], torch.stack(vecs)


def _whole(vecs: torch.Tensor, mesh: Mesh, orig_dim: int) -> torch.Tensor:
    """(k, orig_dim): the whole vectors from every rank's rows."""
    return mesh.gather_rows(vecs)[..., :orig_dim]


def sharded_selective_solve(sham, mesh: Mesh, orig_dim: int,
                            num_states: int = 1, seed: int = 7239443,
                            max_steps: int = 200, tol: float = 1e-10,
                            krylov_budget_bytes: int | None = None,
                            return_info: bool = False,
                            strict: bool = False):
    """The distributed lowest_states driver: the single-device solver's
    selective-reorthogonalization Lanczos (``lz._lanczos_scan``) on a
    sharded form (flat ELL, Kronecker, halo or block-factored), the
    Krylov basis and the state row-sharded.  The start vector is the
    single-device port's (``random_start_vector(orig_dim, seed)`` drawn
    whole on every rank), padded with zeros, so padded rows never enter
    the Krylov space.

    The budget is per mesh (default: the per-device budget times the
    ranks), as in the JAX package: a basis that would not fit hands over
    to the plain two-pass solver; otherwise the Ritz residual is checked
    and the steps double within the budget, with memory-bounded restarts
    from the current Ritz vector at its edge.  Returns (evals, vecs) or
    (evals, vecs, SolveInfo) with `return_info`; vecs (k, orig_dim) are
    the whole vectors on every rank.  `strict` raises when unconverged."""
    def ret(evals, vecs, info):
        vecs = _whole(vecs, mesh, orig_dim)
        return (evals, vecs, info) if return_info else (evals, vecs)

    dim = sham.dim
    dtype = sham.dtype
    itemsize = dtype.itemsize
    if krylov_budget_bytes is None:
        krylov_budget_bytes = lz.default_krylov_budget(mesh.device) * \
            mesh.size
    v0 = mesh.local_rows(lz.random_start_vector(orig_dim, seed, dtype,
                                                mesh.device), dim)
    if dtype in lz.LOW_PRECISION:
        tol = max(tol, 1e-6)

    if min(orig_dim, max_steps) * dim * itemsize > krylov_budget_bytes:
        evals, vecs = _sharded_plain_solve(sham, mesh, v0, orig_dim,
                                           num_states, max_steps)
        # no stored basis to estimate a residual from
        return ret(evals, vecs, lz.SolveInfo(True, float("nan"),
                                             min(orig_dim, max_steps)))

    steps = int(min(orig_dim, max_steps))
    restarts = 0
    while True:
        V = None    # free the previous basis before the next is made
        V, alphas, betas, _ = lz._lanczos_scan(sham, v0, steps)
        a_t, b_t, m = lz.trim_at_breakdown(alphas, betas)
        evals, evecs = lz.tridiag_eigh(a_t[:m], b_t[:m])
        k_chk = min(num_states, m)
        resid = abs(b_t[m - 1]) * np.abs(evecs[m - 1, :k_chk]).max()
        scale = max(np.abs(evals[0]), 1.0)
        converged = bool(m < steps or steps >= orig_dim or
                         resid <= tol * scale)
        if converged or steps >= 4 * max_steps:
            break
        if 2 * steps * dim * itemsize > krylov_budget_bytes:
            if num_states > 1 or restarts >= 8:
                break
            # memory-bounded restart from the current Ritz vector
            restarts += 1
            v_r = lz._combine(V, evecs[:, :1])[0]
            v0 = v_r / mesh.norm(v_r)
            continue
        steps = int(min(orig_dim, steps * 2))
    if not converged and strict:
        raise RuntimeError(
            f"distributed Lanczos failed to converge: relative residual "
            f"{resid / scale:.3e} > tol {tol:.1e} after {steps} steps "
            f"at dim {orig_dim}")
    evals, vecs = _finish(alphas, betas, V, num_states, mesh)
    return ret(evals, vecs, lz.SolveInfo(converged, resid / scale, steps))


def lanczos_step(ham, v, v_prev, beta_prev):
    """One distributed Lanczos iteration (matvec and alpha, beta) on this
    rank's rows: the unit the dry run executes.  Returns (v_next, v,
    alpha, beta), the scalars the same on every rank."""
    mesh = lz._mesh(ham)
    w = ham.matvec(v)
    alpha = lz._allsum(torch.vdot(v, w), mesh).real
    w = w - alpha * v - beta_prev * v_prev
    # re-orthogonalize against the current vector once more
    w = w - lz._allsum(torch.vdot(v, w), mesh) * v
    beta = lz._allnorm(w, mesh)
    v_next = w / torch.where(beta > 0, beta, 1.0)
    return v_next, v, alpha, beta


def jit_lanczos_step(mesh: Mesh):
    """The step the JAX package compiles for a mesh: here it runs eagerly
    on each rank, so this is ``lanczos_step`` itself."""
    return lanczos_step


def distributed_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                              seed: int = 7239443, max_steps: int = 200,
                              prefer_kron: bool = True, **solve_kw):
    """Row-sharded computeAllStatesBelow over the mesh.  Spin-factorized
    Hamiltonians run in the Kronecker form, block-factorized ones (or a
    ``PermutedHamiltonian`` wrapping one) column-sharded
    (``blockkron_dist``), others as the padded flat ELL with the state
    all-gathered each matvec.  Extra keywords (tol, krylov_budget_bytes,
    return_info, strict) reach ``sharded_selective_solve``.  Returns
    (energies, vectors), the whole vectors (k, dim) on every rank, in the
    caller's order."""
    if hasattr(ham, "shapes") or _is_wrapped(ham):
        from lanczosplusplus_tpu_torch.parallel.blockkron_dist import \
            blockkron_lowest_states
        return blockkron_lowest_states(ham, mesh, num_states, seed,
                                       max_steps, **solve_kw)
    sham = shard_for_mesh(ham, mesh, prefer_kron=prefer_kron)
    return sharded_selective_solve(sham, mesh, ham.dim, num_states, seed,
                                   max_steps, **solve_kw)


def _padded_random_block(dim: int, dimp: int, num_vectors: int,
                         dtype: torch.dtype, seed: int,
                         mesh: Mesh) -> torch.Tensor:
    """This rank's rows (rows, R) of the single-device port's random start
    block (``random_start_block(dim, R, seed)``, drawn whole on every
    rank), zero in the padded rows: padded rows are decoupled eigenvalue-0
    states, which would contaminate a trace estimator."""
    v = lz.random_start_block(dim, num_vectors, seed, dtype, mesh.device)
    return mesh.local_rows(v.T, dimp).T


def _diag_rows(op, mesh: Mesh, dimp: int, perm=None) -> torch.Tensor:
    """This rank's rows of a (dim,) diagonal operator, permuted into the
    block order of a factored form first (`perm`) and zero-padded."""
    diag = torch.as_tensor(np.asarray(op) if not torch.is_tensor(op)
                           else op, device=mesh.device)
    if perm is not None:
        diag = diag[perm.to(mesh.device)]
    return mesh.local_rows(diag, dimp)


def _pad_operators(operators, ham, sham, mesh: Mesh, perm=None):
    """Operators for the sharded estimators: diagonals as this rank's
    padded rows; the Hamiltonian itself as its sharded form; other
    matmat-style operators sharded the same way (a sharded one passes
    through)."""
    ops = {}
    for name, op in operators.items():
        if hasattr(op, "matmat") or hasattr(op, "matmat_t"):
            ops[name] = sham if op is ham else shard_for_mesh(op, mesh)
        else:
            ops[name] = _diag_rows(op, mesh, sham.dim, perm)
    return ops


def distributed_ftlm(ham, mesh: Mesh, beta_grid, num_vectors: int = 32,
                     steps: int = 80, seed: int = 982451653,
                     operators=None):
    """Finite-temperature Lanczos with the sector row-sharded over the
    mesh: the port's ``ftlm`` on the sharded form from the padded
    single-device start block, its per-column scalars summed over the
    ranks.  Diagonal operators (1-D arrays, flat order) are padded; the
    Hamiltonian or other matmat-style operators are sharded.  A factored
    wrapper runs in block order (traces are basis-independent)."""
    from lanczosplusplus_tpu_torch.engine.ftlm import ftlm

    perm = None
    if _is_wrapped(ham):
        perm = ham.perm
        ham = ham.inner
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype, seed,
                              mesh)
    ops = (_pad_operators(operators, ham, sham, mesh, perm)
           if operators else None)
    return ftlm(sham, beta_grid, steps=steps, start_vectors=V0,
                trace_dim=dim, operators=ops)


def distributed_ltlm(ham, mesh: Mesh, beta_grid, operators,
                     num_vectors: int = 16, steps: int = 80,
                     seed: int = 982451653):
    """Low-temperature Lanczos (``engine/ftlm.ltlm``) with the sector
    row-sharded over the mesh: each stored-V run and each operator
    projection on this rank's rows, summed over the ranks.  Same
    operator conventions as ``distributed_ftlm``."""
    from lanczosplusplus_tpu_torch.engine.ftlm import ltlm

    perm = None
    if _is_wrapped(ham):
        perm = ham.perm
        ham = ham.inner
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype, seed,
                              mesh)
    ops = _pad_operators(operators, ham, sham, mesh, perm)
    return ltlm(sham, beta_grid, ops, steps=steps, start_vectors=V0,
                trace_dim=dim)


def _perm_layout(ham):
    """(to_block, to_flat, inner) converters of whole vectors (or
    batch-major blocks) for an optionally ``PermutedHamiltonian``-wrapped
    sector Hamiltonian: block = sign * flat[perm], flat = (sign *
    block)[inv]."""
    if _is_wrapped(ham):
        return ham.to_inner, ham.to_flat, ham.inner

    def ident(x):
        return x
    return ident, ident, ham


def distributed_spectral_fleet(ham, mesh: Mesh, v0s, steps: int = 100):
    """Batched continued-fraction tridiagonalizations (the spectral fleet)
    with the destination sector row-sharded: v0s is the (R, dim) block of
    normalized start vectors in flat order; padded rows carry zero start
    amplitude, so the tridiagonals equal the single-device ones.  Returns
    the per-vector ``LanczosResult`` list."""
    to_block, _, inner = _perm_layout(ham)
    sham = shard_for_mesh(inner, mesh)
    v0s = torch.as_tensor(np.asarray(v0s) if not torch.is_tensor(v0s)
                          else v0s, device=inner.device).to(sham.dtype)
    v0s = mesh.local_rows(to_block(v0s), sham.dim)
    return lz.tridiagonalize_plain_batched(sham, v0s, steps)


def distributed_ftlm_dynamic(ham_src, ham_dst, apply_b, mesh: Mesh,
                             num_vectors: int = 16, steps: int = 100,
                             seed: int = 152917, apply_a=None,
                             start_vectors=None):
    """FTLM double-Krylov finite-T dynamics (``engine/ftlm_dynamic``) with
    both sector Hamiltonians row-sharded: every stored-V run on this
    rank's rows, the cross coupling summed over the ranks.  apply_b /
    apply_a keep the single-device convention (a batch-major (k, dim_src)
    block in flat order to (k, dim_dst)); the whole block is gathered for
    them, converted to flat order and back, padded and cut to this rank's
    rows here.  Padded rows carry zero start amplitude, so the pole data
    equal the single-device estimator's."""
    import dataclasses as dc

    from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import ftlm_dynamic

    apply_a = apply_a or apply_b
    src_tb, src_tf, src_inner = _perm_layout(ham_src)
    dst_tb, _, dst_inner = _perm_layout(ham_dst)
    s_src = shard_for_mesh(src_inner, mesh)
    s_dst = shard_for_mesh(dst_inner, mesh)
    dim_s, dim_d = src_inner.dim, dst_inner.dim
    dev = src_inner.device

    if start_vectors is not None:
        V0 = torch.as_tensor(np.asarray(start_vectors)
                             if not torch.is_tensor(start_vectors)
                             else start_vectors, device=dev)
    else:
        V0 = lz.random_start_block(ham_src.dim, num_vectors, seed,
                                   ham_src.dtype, dev)
    V0 = V0.to(s_src.dtype)
    V0b = mesh.local_rows(src_tb(V0.T), s_src.dim).T   # (rows, R)

    def wrap(apply):
        def f(xk):     # this rank's rows of block-order src -> of dst
            flat = src_tf(mesh.gather_rows(xk)[..., :dim_s].to(dev))
            y = torch.as_tensor(apply(flat), device=dev)
            return mesh.local_rows(dst_tb(y), s_dst.dim).to(s_dst.dtype)
        return f

    res = ftlm_dynamic(s_src, s_dst, wrap(apply_b), steps=steps,
                       apply_a=wrap(apply_a), start_vectors=V0b)
    return dc.replace(res, dim=ham_src.dim)


def _spectral_bounds(sham, dim: int, mesh: Mesh, steps: int = 64,
                     seed: int = 271828, margin: float = 0.05):
    """``kpm.spectral_bounds`` on a sharded form: a short plain Lanczos
    run from the single-device start vector (zero in the padded rows)."""
    steps = int(min(steps, dim))
    v0 = mesh.local_rows(lz.random_start_vector(dim, seed, sham.dtype,
                                                mesh.device), sham.dim)
    res = lz.tridiagonalize_plain(sham, v0, steps)
    evals, _ = lz.tridiag_eigh(res.alphas, res.betas)
    lo, hi = float(evals[0]), float(evals[-1])
    pad = margin * max(hi - lo, 1.0)
    return lo - pad, hi + pad


def distributed_kpm_dos(ham, mesh: Mesh, num_moments: int = 256,
                        num_vectors: int = 16, seed: int = 314159,
                        bounds=None):
    """Stochastic-trace density of states by the kernel polynomial method
    with the sector row-sharded: the Chebyshev recurrence on this rank's
    rows, the moments summed over the ranks, the trace normalized by the
    true dimension."""
    from lanczosplusplus_tpu_torch.engine.kpm import chebyshev_moments

    if _is_wrapped(ham):
        ham = ham.inner     # traces are basis-independent
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    if bounds is None:
        bounds = _spectral_bounds(sham, dim, mesh)
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype, seed,
                              mesh)
    res = chebyshev_moments(sham, V0, num_moments, bounds=bounds)
    res.moments *= dim / num_vectors
    return res

