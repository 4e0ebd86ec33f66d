"""Engine: sector diagonalization on construction, then observables.

Counterpart of ``lanczosplusplus_tpu/engine/engine.py``: the ground state
(``Engine.__init__``, ``hamiltonian``, ``energies``, ``eigenvector``), the
sector caches, operator application across sectors
(``apply_operator_map``, ``acc_modified_state``), continued-fraction
spectral functions serial and batched (``spectral_function``,
``spectral_functions_batched``), and the static observables
(``two_point``, ``many_point``, ``measure``), and the factored forms of
``SolverOptions=factored`` (``_factored_hamiltonian``, ``_warn_fallback``,
``SolveInfo.factored_fallback``; the sector caches build the factored form
of every sector a spectral run visits), and the symmetry sectors
(``_solve_with_symmetry`` over translation and reflection blocks,
``_try_projected_translation`` for the Kitaev chain, ``solve_sector``,
``projected_purity``); itself a functional re-design of the reference
Engine (reference: src/Engine/Engine.h:84-98 ctor diagonalizes; 601-657
computeAllStatesBelow; observable entry points 113-389), and the
estimators' spectral functions (``kpm_local_dos``, ``ftlm_local_dos``,
``ftlm_sq_omega``, whose operator rows go through device plans made once
from the cached maps, ``_operator_rows``).  The solve's scalar type is the
Hamiltonian's: a model may force a complex one whatever the input asks,
and a complex momentum sector makes the later sector Hamiltonians complex
(``scalar_dtype``).

States are tensors on the configured device; operator index maps are
built on the host in numpy and applied there as ``index_add_`` scatters.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.core.blockkron import BF16_CROSS
from lanczosplusplus_tpu_torch.engine import operators as ops
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFraction, ContinuedFractionCollection)
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.utils.progress import ProgressIndicator


def apply_operator_map(tgt, amp, dst_dim, vec: torch.Tensor, factor=1.0):
    """z[tgt] += factor * amp * vec for the host index map (tgt, amp) of
    an operator over the source sector (tgt = -1 where annihilated): the
    vectorized accModifiedState_ scatter (reference: Engine.h:416-458),
    one ``index_add_`` on the device of `vec`.  Returns z (dst_dim,)."""
    mask = tgt >= 0
    dev = vec.device
    coef = torch.as_tensor(factor * amp[mask], device=dev)
    contrib = coef * vec[torch.as_tensor(np.nonzero(mask)[0], device=dev)]
    out = torch.zeros(dst_dim, dtype=contrib.dtype, device=dev)
    return out.index_add_(0, torch.as_tensor(tgt[mask], device=dev), contrib)


class Engine:
    """Diagonalizes the target sector on construction and serves the
    energies and eigenvectors.  `config` defaults to the input's solver
    labels on ``cuda``; `v0` is an optional start vector for the solve
    (without symmetry; each symmetry sector draws its own)."""

    def __init__(self, model, inp, config: Config | None = None, v0=None):
        self.progress = ProgressIndicator("Engine")
        self.model = model
        self.inp = inp
        self.config = config or Config.from_input(inp)
        self.excited = inp.integer("Excited", default=0)
        self.parts = model.default_parts(inp)
        self.basis = model.create_basis(self.parts)
        self._flat_ham = None
        self._factored = False
        self._complex_state = False
        self.factored_fallback_reason = None
        # symmetry sectors take precedence over SolverOptions=factored
        use_symmetry = (inp.integer("UseTranslationSymmetry", default=0) or
                        inp.integer("UseReflectionSymmetry", default=0))
        if "factored" in inp.solver_options() and not use_symmetry:
            if "bf16cross" in inp.solver_options():
                raise NotImplementedError(BF16_CROSS)
            # models and inputs without a factored form fall back to the
            # flat form, with the reason logged and kept in solve_info
            ham_f = self._factored_hamiltonian(self.parts, self.basis,
                                               warn=self._warn_fallback)
            if ham_f is not None:
                self._factored = True
                self._ham_cache = {self.parts: ham_f}
        with self.progress.phase(
                f"diagonalization dim={self.basis.size}"):
            if use_symmetry:
                self._solve_with_symmetry(inp, self.excited + 1)
            else:
                self._energies, self._vectors, info = lz.lowest_states(
                    self._cached_hamiltonian(self.parts),
                    num_states=self.excited + 1,
                    seed=self.config.seed,
                    max_steps=self.config.lanczos_steps,
                    return_info=True, v0=v0)
                self._log_solve(info)

    def _warn_fallback(self, reason: str):
        self.factored_fallback_reason = reason
        self.progress(f"WARNING: {reason}")

    @property
    def scalar_dtype(self) -> torch.dtype:
        """The scalar type of the sector Hamiltonians built for the solve
        and the observables: the configured one, or complex128 once a
        symmetry solve has left a complex eigenvector (a momentum sector),
        so that every later kernel takes the state and the Hamiltonian in
        one dtype (the JAX package promotes a real Hamiltonian against a
        complex state; the port's kernels take a single dtype)."""
        if self._complex_state:
            return torch.complex128
        return self.config.scalar_dtype

    def _solve_with_symmetry(self, inp, nstates):
        """Sector scan keeping the lowest states (reference:
        Engine.h:601-657 computeAllStatesBelow over symmetry sectors):
        each non-empty block solved on the configured device, the winner's
        eigenvectors transformed back to the site basis on the host and
        held on the device (complex128 where the transform is complex).
        The winning block's SolveInfo is logged and exposed, and its
        sector is ``solve_sector``; the symmetry, with its blocks, stays
        as ``symmetry``.  No non-empty sector raises."""
        from lanczosplusplus_tpu_torch.symmetry import build_symmetry

        if self._try_projected_translation(inp, nstates):
            return
        with self.progress.phase("symmetry setup"):
            sym = build_symmetry(
                inp, self.basis, self.model.geometry, self.model,
                fermionic=getattr(self.model, "is_fermionic", True),
                device=self.config.device)
        self.symmetry = sym
        best = None
        for s in range(sym.sectors()):
            with self.progress.phase(f"symmetry sector {s} block build"):
                ham_s = sym.block_hamiltonian(s)
            if ham_s is None or ham_s.dim == 0:
                continue
            # a block is one padded ELL: no Kronecker factors to densify
            with self.progress.phase(f"symmetry sector {s} solve"):
                evals, vecs, info = lz.lowest_states(
                    ham_s, num_states=min(nstates, ham_s.dim),
                    seed=self.config.seed,
                    max_steps=self.config.lanczos_steps, return_info=True)
            self.progress(
                f"symmetry sector {s}: dim {ham_s.dim}, {ham_s.dtype}, ELL "
                f"K {ham_s.ell.cols.shape[1]} against "
                f"{sym.block_entries[s] / ham_s.dim:.2f} entries a row, "
                f"steps {info.steps}, E0 {float(evals[0])!r}")
            if not info.converged:
                self.progress(
                    f"WARNING: symmetry block {s} unconverged "
                    f"(relative residual {info.residual:.3e} after "
                    f"{info.steps} steps)")
            if best is None or evals[0] < best[0][0]:
                best = (evals, vecs, s, info)
        if best is None:
            raise ValueError(
                f"no non-empty symmetry sector among {sym.sectors()}: "
                f"nothing to solve")
        evals, vecs, sector, info = best
        self._log_solve(info)
        self.solve_sector = sector
        self._energies = evals
        self._vectors = [
            torch.as_tensor(sym.transform(v.cpu().numpy(), sector),
                            device=self.config.device) for v in vecs]
        self._complex_state = self._vectors[0].is_complex()

    def _try_projected_translation(self, inp, nstates) -> bool:
        """Momentum sectors via projected Lanczos in the FULL space
        (symmetry/projected.py) for a model that asks for it
        (``projects_translation``: the Kitaev chain) when the basis index
        is the bit word and translation is the +1 cyclic site shift, on
        the matvec of the model's ``symmetry_form``.  The JAX package
        routes this way on its accelerator because the assembled k-blocks
        are random-column ELLs there; the port keeps that routing on
        CUDA.  Returns False
        (-> orbit-block path) when out of scope.  CPU runs keep the block
        path unless SolverOptions=projected asks for this one."""
        if inp.integer("UseTranslationSymmetry", default=0) != 1:
            return False
        if inp.integer("UseReflectionSymmetry", default=0):
            return False
        if self.config.device.type != "cuda" \
                and "projected" not in inp.solver_options():
            return False
        if not getattr(self.model, "projects_translation", False):
            return False
        n = self.model.geometry.number_of_sites()
        if self.basis.size != (1 << n):
            return False
        perm = [self.model.geometry.translate(s, 0, 1) for s in range(n)]
        if perm != [(s + 1) % n for s in range(n)]:
            return False
        from lanczosplusplus_tpu_torch.symmetry.projected import (
            ProjectedTranslationSolver)
        with self.progress.phase("projected translation build"):
            ham = self.model.symmetry_form(self.basis,
                                           dtype=self.scalar_dtype,
                                           device=self.config.device)
        proj = ProjectedTranslationSolver(ham, n)
        best = None
        for s in range(proj.sectors()):
            k = proj.momentum(s)
            with self.progress.phase(f"momentum sector k={k} solve"):
                evals, vecs, info = proj.solve_sector(
                    s, num_states=nstates,
                    max_steps=self.config.lanczos_steps,
                    seed=self.config.seed)
            self.progress(f"momentum sector k={k}: steps {info.steps}, "
                          f"E0 {float(evals[0])!r}")
            if not info.converged:
                self.progress(
                    f"WARNING: momentum sector k={k} unconverged "
                    f"(relative residual {info.residual:.3e})")
            if best is None or evals[0] < best[0][0]:
                best = (evals, vecs, s, info)
        if best is None:
            raise ValueError("no non-empty symmetry sector: the projected "
                             "translation has no momentum sector")
        evals, vecs, sector, info = best
        self._log_solve(info)
        self.solve_sector = proj.momentum(sector)
        self.projected_purity = proj.purity(sector, vecs[0])
        self.progress(
            f"projected translation: min-k sector k={self.solve_sector}"
            f" purity={self.projected_purity:.6f}")
        self._energies = evals
        self._vectors = list(vecs)
        return True

    def _factored_hamiltonian(self, parts, basis, warn=None):
        """The sector's factored form on the configured device (half-cut
        Sz blocks for Heisenberg of any spin S, the half-cut Kronecker
        product for Kitaev, block-Kronecker unions for Rashba, t-J, FeAs
        spin-orbit and the single FeAs block), or None."""
        from lanczosplusplus_tpu_torch.models.factored import (
            factored_hamiltonian_or_none)
        return factored_hamiltonian_or_none(
            self.model, basis, parts, self.scalar_dtype,
            device=self.config.device, warn=warn)

    def _log_solve(self, info):
        """Reference-style convergence report (Engine.h:624-639 prints
        'lanczos solver failed ... trying fullDiag')."""
        info.factored_fallback = self.factored_fallback_reason
        self.solve_info = info
        if info.used_dense_fallback and info.steps:
            self.progress(
                "Lanczos did not converge (relative residual "
                f"{info.residual:.3e} after {info.steps} steps); "
                "used dense fullDiag fallback")
        elif not info.converged:
            self.progress(
                "WARNING: Lanczos unconverged (relative residual "
                f"{info.residual:.3e} after {info.steps} steps) and "
                "sector too large for dense fallback")

    def _build_hamiltonian(self, basis):
        """A sector's flat Hamiltonian on the configured device.  On CUDA
        the Kronecker one-spin factors, where the model has any, are
        densified where they fit a quarter of the free memory, so the
        matvec runs them as ``factor_matmul`` GEMMs; a factor too large
        stays in gather form, applied by ``perm_gather``.  The CPU keeps
        the gather form.  The form taken is logged."""
        ham = self.model.hamiltonian(basis, dtype=self.scalar_dtype,
                                     device=self.config.device)
        if self.config.device.type == "cuda":
            ham = ham.densify_factors()
        f = ham.factorized
        if f is not None:
            pairs = [(cols.shape[0], d is not None) for cols, d in
                     ((f.up_cols, f.up_dense), (f.dn_cols, f.dn_dense))
                     if cols is not None]
            dense = [(n, n) for n, is_dense in pairs if is_dense]
            gather = [(n, n) for n, is_dense in pairs if not is_dense]
            self.progress(f"one-spin factors on {ham.device}: " + "; ".join(
                ([f"dense {dense} through factor_matmul"] if dense else [])
                + ([f"gather form {gather} through perm_gather"] if gather
                   else [])))
        return ham

    @property
    def hamiltonian(self):
        """The target sector's Hamiltonian, built lazily."""
        if self._flat_ham is None:
            self._flat_ham = self._build_hamiltonian(self.basis)
        return self._flat_ham

    def energies(self, i: int = 0) -> float:
        return float(self._energies[i])

    def eigenvector(self, i: int = 0):
        """The i-th eigenvector, a tensor on the configured device."""
        return self._vectors[i]

    @property
    def ground_energy(self) -> float:
        return self.energies(0)

    @property
    def geometry(self):
        return self.model.geometry

    # -- sector caches (spectral pipelines revisit the same N+-1 sectors
    #    for every site pair and operator type) ---------------------------

    def _cached_basis(self, parts):
        if not hasattr(self, "_basis_cache"):
            self._basis_cache = {self.parts: self.basis}
        if parts not in self._basis_cache:
            self._basis_cache[parts] = self.model.create_basis(parts)
        return self._basis_cache[parts]

    def _cached_hamiltonian(self, parts):
        """The Hamiltonian the solvers apply in a sector: its factored
        form under SolverOptions=factored where the model has one, else
        the flat one."""
        if not hasattr(self, "_ham_cache"):
            self._ham_cache = {}
        if parts not in self._ham_cache:
            ham = None
            if self._factored:
                ham = self._factored_hamiltonian(parts,
                                                 self._cached_basis(parts))
            if ham is None:
                ham = (self.hamiltonian if parts == self.parts else
                       self._build_hamiltonian(self._cached_basis(parts)))
            self._ham_cache[parts] = ham
        return self._ham_cache[parts]

    def _cached_dense_hamiltonian(self, parts):
        """Dense-factor (GEMM) form of a sector Hamiltonian for batched
        recurrences, on every device: the gather form would materialize
        an (R, dim) intermediate per hop bond on the CPU, the densified
        factors make each block step two GEMMs.  On CUDA
        ``_cached_hamiltonian`` is this form already; a factored form
        comes back as it is."""
        if not hasattr(self, "_dense_ham_cache"):
            self._dense_ham_cache = {}
        if parts not in self._dense_ham_cache:
            ham = self._cached_hamiltonian(parts)
            if hasattr(ham, "densify_factors"):
                ham = ham.densify_factors()
            self._dense_ham_cache[parts] = ham
        return self._dense_ham_cache[parts]

    # -- operator application across sectors ------------------------------

    def _get_needed_basis(self, parts, op, spin, orb):
        """(new_parts, basis) or None (reference: Engine.h:391-414)."""
        if not op.needs_new_basis:
            return parts, self._cached_basis(parts)
        new_parts = self.model.has_new_parts(parts, op, spin, orb)
        if new_parts is None:
            return None
        return new_parts, self._cached_basis(new_parts)

    def acc_modified_state(self, z, op, dst_basis, src_vec, src_basis,
                           site, spin, orb, factor):
        """z += factor * op_site |src>, in place on the tensor z
        (reference: Engine.h:416-458)."""
        tgt, amp, dst_dim = self._cached_operator_map(
            op, site, spin, orb, src_basis, dst_basis)
        z += apply_operator_map(tgt, amp, dst_dim, src_vec, factor)
        return z

    def _acc_modified_state_dressed(self, z, op, dst_basis, src_vec,
                                    src_basis, site, spin, orb, isign):
        """The twoPoint variant: sz -> 0.5 n_up - 0.5 n_down
        (reference: Engine.h:537-599 accModifiedState)."""
        if op.name == ops.SZ:
            op_n = LabeledOperator(ops.N)
            self.acc_modified_state(z, op_n, dst_basis, src_vec, src_basis,
                                    site, 0, orb, isign * 0.5)
            self.acc_modified_state(z, op_n, dst_basis, src_vec, src_basis,
                                    site, 1, orb, -isign * 0.5)
            return z
        return self.acc_modified_state(z, op, dst_basis, src_vec, src_basis,
                                       site, spin, orb, isign)

    # -- spectral functions (reference: Engine.h:113-206) -----------------

    def _spectral_steps(self) -> int:
        """The reference reads a separate "Spectral" solver section
        (Engine.h:472 ParametersForSolver(io, "Spectral"))."""
        return self.inp.integer("SpectralSteps",
                                default=self.config.lanczos_steps)

    def _spectral_jobs(self, op_name, isite, jsite, spin, orbs):
        """The (type, operator, destination parts, destination basis) of
        the 4-type decomposition that exist for one site pair
        (reference: Engine.h:133-206)."""
        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        is_diagonal = (isite == jsite and orbs[0] == orbs[1])
        for type_ in range(op1.number_of_types):
            if is_diagonal and type_ > 1:
                continue
            op = op1 if (type_ & 1) else op2
            got = self._get_needed_basis(self.parts, op, spin, orbs[0])
            if got is not None:
                yield (type_, op, *got)

    def spectral_function(self, op_name: str, isite: int, jsite: int,
                          spin: int = 0, orbs=(0, 0)):
        """Green's function G_op(isite, jsite, omega) as a
        continued-fraction collection via the 4-type decomposition
        (reference: Engine.h:133-206 spectralFunction)."""
        gs = self.eigenvector(0)
        is_diagonal = (isite == jsite and orbs[0] == orbs[1])
        coll = ContinuedFractionCollection()
        labels = []
        for type_, op, new_parts, basis_new in self._spectral_jobs(
                op_name, isite, jsite, spin, orbs):
            modif = torch.zeros(basis_new.size, dtype=gs.dtype,
                                device=gs.device)
            self.acc_modified_state(modif, op, basis_new, gs, self.basis,
                                    isite, spin, orbs[0], 1.0)
            if not is_diagonal:
                isign = -1.0 if type_ > 1 else 1.0
                self.acc_modified_state(modif, op, basis_new, gs, self.basis,
                                        jsite, spin, orbs[1], isign)
            ham_new = self._cached_hamiltonian(new_parts)
            cf = self._calc_spectral(ham_new, op.is_fermionic, modif,
                                     type_, is_diagonal)
            cf.meta = f"{spin},{type_},{orbs[0]},{orbs[1]}"
            labels.append(cf.meta)
            coll.push(cf)
        return coll, labels

    def spectral_functions_batched(self, op_name: str, pairs,
                                   spin: int = 0, orbs=(0, 0)):
        """Continued fractions for many site pairs at once.

        Same 4-type decomposition, weights and output as
        ``spectral_function``, but every (pair, type) job that lands in
        the same destination sector runs inside one batched recurrence
        (``tridiagonalize_plain_batched``, every step through the batched
        kernels): a whole TSPCenter / DoAllPairs / DOS fleet costs two
        batched Lanczos runs (the N+1 and N-1 sectors) instead of about
        4 x len(pairs) serial ones (the reference's mainLoop3 calls
        engine.spectralFunction once per pair).  The tridiagonals come
        from the plain recurrence without reorthogonalization, the
        reference's own decomposition mode (Engine.h:472-478).

        Returns a list of (ContinuedFractionCollection, labels), one per
        entry of `pairs`."""
        gs = self.eigenvector(0)
        steps = self._spectral_steps()
        per_pair_items = [[] for _ in pairs]
        # one scatter per (op, orb, destination sector) builds op_site|gs>
        # for every site; each (pair, type) start vector is then two row
        # reads and one axpy
        z_cache = {}

        def z_for(op, basis_new, orb_):
            zkey = (op.name, orb_, id(basis_new))
            if zkey not in z_cache:
                valid, Z = self._batched_modified_states(
                    op, basis_new, gs, spin, orb_, dressed=False)
                z_cache[zkey] = ({s_: k for k, s_ in enumerate(valid)}, Z)
            return z_cache[zkey]

        # parts -> (basis_new, jobs); job = (pi, slot, s, s2, meta, spec)
        pending = {}
        for pi, (isite, jsite) in enumerate(pairs):
            is_diagonal = (isite == jsite and orbs[0] == orbs[1])
            for type_, op, new_parts, basis_new in self._spectral_jobs(
                    op_name, isite, jsite, spin, orbs):
                s, s2 = self._spectral_signs(op.is_fermionic, type_,
                                             is_diagonal)
                meta = f"{spin},{type_},{orbs[0]},{orbs[1]}"
                slot = len(per_pair_items[pi])
                per_pair_items[pi].append(None)
                isign = 0.0 if is_diagonal else \
                    (-1.0 if type_ > 1 else 1.0)
                pending.setdefault(tuple(new_parts), (basis_new, []))[1] \
                    .append((pi, slot, s, s2, meta,
                             (op, isite, jsite, isign)))
        for parts_key, (basis_new, jobs) in pending.items():
            with self.progress.phase(
                    f"spectral start vectors sector {parts_key} "
                    f"rows={len(jobs)}"):
                rows = []
                for (_, _, _, _, _, (op, isite, jsite, isign)) in jobs:
                    pos_i, Z_i = z_for(op, basis_new, orbs[0])
                    row = Z_i[pos_i[isite]] if isite in pos_i else None
                    if isign != 0.0:
                        pos_j, Z_j = z_for(op, basis_new, orbs[1])
                        if jsite in pos_j:
                            zj = isign * Z_j[pos_j[jsite]]
                            row = zj if row is None else row + zj
                    rows.append(torch.zeros(basis_new.size, dtype=gs.dtype,
                                            device=gs.device)
                                if row is None else row)
                M = torch.stack(rows)
                del rows
                weights = (M.abs() ** 2).sum(dim=1).cpu().numpy() \
                    .astype(np.float64)
            live = weights >= 1e-24
            for j, (pi, slot, s, s2, meta, _) in enumerate(jobs):
                if not live[j]:
                    per_pair_items[pi][slot] = ContinuedFraction(
                        alphas=np.zeros(0), betas=np.zeros(0),
                        e0=self.ground_energy, weight=0.0, sigma=s,
                        meta=meta)
            if not live.any():
                continue
            ham_new = self._cached_dense_hamiltonian(parts_key)
            scale = torch.as_tensor(np.sqrt(weights[live]),
                                    device=M.device).to(M.dtype)
            v0s = M[torch.as_tensor(np.nonzero(live)[0], device=M.device)] \
                / scale[:, None]
            del M
            with self.progress.phase(
                    f"batched recurrence sector {parts_key} "
                    f"rows={v0s.shape[0]} steps={steps}"):
                ress = lz.tridiagonalize_plain_batched(ham_new, v0s, steps)
            live_jobs = [j for j, ok in zip(jobs, live) if ok]
            for (pi, slot, s, s2, meta, _), res, w in zip(
                    live_jobs, ress, weights[live]):
                per_pair_items[pi][slot] = ContinuedFraction(
                    alphas=res.alphas, betas=res.betas,
                    e0=self.ground_energy, weight=w * s2, sigma=s,
                    meta=meta)
        out = []
        for items in per_pair_items:
            coll = ContinuedFractionCollection()
            labels = []
            for cf in items:
                coll.push(cf)
                labels.append(cf.meta)
            out.append((coll, labels))
        return out

    @staticmethod
    def _spectral_signs(is_fermionic, type_, is_diagonal):
        """(s, s2) of the 4-type decomposition (Engine.h:139-158):
        s is the pole direction (sigma), s2 the CF weight sign."""
        s = -1 if (type_ & 1) else 1
        s2 = -1.0 if type_ > 1 else 1.0
        if not is_fermionic:
            s2 *= s
        if not is_diagonal:
            s2 *= 0.5
        return s, s2

    def _calc_spectral(self, ham_new, is_fermionic, modif, type_,
                       is_diagonal) -> ContinuedFraction:
        """Lanczos tridiagonalization of op|gs> (reference:
        Engine.h:460-490 calcSpectral)."""
        weight = torch.vdot(modif, modif).real.item()
        s, s2 = self._spectral_signs(is_fermionic, type_, is_diagonal)
        # sigma convention: +1 = particle addition (poles at
        # omega = E_n - E0); even types apply the transpose-conjugate
        # operator (c^dagger for gf "c"), odd types remove.  The
        # reference passes -s to PsimagLite cf.set whose internal
        # convention is mirrored (Engine.h:488).
        if weight < 1e-24:
            return ContinuedFraction(
                alphas=np.zeros(0), betas=np.zeros(0),
                e0=self.ground_energy, weight=0.0, sigma=s)
        steps = self._spectral_steps()
        basis_bytes = min(ham_new.dim, steps) * ham_new.dim \
            * ham_new.dtype.itemsize
        if basis_bytes > lz.default_krylov_budget(ham_new.device):
            # the stored basis would not fit: the CF needs only
            # (alpha, beta)
            res = lz.tridiagonalize_plain(ham_new, modif, steps)
        else:
            res = lz.tridiagonalize(ham_new, modif, steps)
        return ContinuedFraction(
            alphas=res.alphas, betas=res.betas, e0=self.ground_energy,
            weight=weight * s2, sigma=s)

    # -- estimators: KPM and FTLM spectral functions -----------------------

    def kpm_local_dos(self, op_name: str, isite: int, omegas,
                      spin: int = 0, orb: int = 0,
                      num_moments: int = 512):
        """N_i(omega) by the kernel polynomial method: the diagonal
        spectral function (types 0/1 of Engine.h:133-206) evaluated as a
        Jackson-broadened Chebyshev density instead of a Lanczos
        continued fraction.  Addition poles land at omega = E_n - E0 > 0,
        removal poles are mirrored to omega = E0 - E_n < 0; the removal
        branch of a non-fermionic operator carries the continued-fraction
        path's negative sign (commutator form).  Two stored vectors a
        destination sector, no reorthogonalization.  The start vector
        (operator maps and scatter) and the moments are timed as phases
        of their own."""
        from lanczosplusplus_tpu_torch.engine.kpm import kpm_spectral

        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        gs = self.eigenvector(0)
        omegas = np.asarray(omegas, dtype=np.float64)
        total = np.zeros_like(omegas)
        for type_ in range(2):
            op = op1 if (type_ & 1) else op2
            got = self._get_needed_basis(self.parts, op, spin, orb)
            if got is None:
                continue
            new_parts, basis_new = got
            with self.progress.phase(
                    f"kpm start vector type {type_} sector {new_parts}"):
                modif = torch.zeros(basis_new.size, dtype=gs.dtype,
                                    device=gs.device)
                self.acc_modified_state(modif, op, basis_new, gs,
                                        self.basis, isite, spin, orb, 1.0)
                weight = torch.vdot(modif, modif).real.item()
            if weight < 1e-24:
                continue
            ham_new = self._cached_hamiltonian(new_parts)
            grid = omegas if type_ == 0 else -omegas
            sgn = -1.0 if (type_ == 1 and not op1.is_fermionic) else 1.0
            with self.progress.phase(
                    f"kpm moments type {type_} sector {new_parts} "
                    f"moments={num_moments}"):
                total = total + sgn * kpm_spectral(
                    ham_new, modif, grid, self.ground_energy,
                    num_moments=num_moments)
        return total

    def _operator_rows(self, op, site_weights, spin, orb, dst_basis):
        """A function applying sum_site w_site op_site, from the target
        sector to `dst_basis`, to every row of a batch-major block
        (k, dim) on the device, one ``index_add_`` for the block.  Its
        plan (targets, sources, weighted amplitudes) is made once from
        the cached host maps (``_cached_operator_map``) and kept on the
        device.  `site_weights` maps site -> weight."""
        tgt_l, src_l, amp_l = [], [], []
        for site, w in site_weights.items():
            tgt, amp, _ = self._cached_operator_map(op, site, spin, orb,
                                                    dst_basis)
            mask = tgt >= 0
            tgt_l.append(tgt[mask])
            src_l.append(np.nonzero(mask)[0])
            amp_l.append(w * amp[mask])
        dev = self.config.device
        tgts = torch.as_tensor(np.concatenate(tgt_l), device=dev)
        srcs = torch.as_tensor(np.concatenate(src_l), device=dev)
        amps = torch.as_tensor(np.concatenate(amp_l), device=dev)
        size = dst_basis.size

        def apply(X):
            contrib = amps * X[:, srcs]
            out = torch.zeros((X.shape[0], size), dtype=contrib.dtype,
                              device=X.device)
            return out.index_add_(1, tgts, contrib)
        return apply

    def ftlm_local_dos(self, op_name: str, isite: int, beta: float,
                       omegas, delta: float = 0.1, spin: int = 0,
                       orb: int = 0, num_vectors: int = 16,
                       steps: int = 100, seed: int = 152917,
                       start_vectors=None):
        """N_i(omega, T): the finite-temperature local spectral function by
        the FTLM double-Krylov estimator (engine/ftlm_dynamic.py),
        addition part plus mirrored removal part, Lorentzian-broadened.
        The reference reaches finite-T dynamics only through the full
        spectra of every sector (thermal.cpp + grandCanonical.pl).
        Normalization: the source sector's canonical ensemble.  The
        mirrored removal branch carries the continued-fraction path's
        sign: negative for non-fermionic operators (commutator form),
        positive for fermionic ones.  One source fleet of R stored runs
        serves both operator types; the operator maps, the source runs and
        each type's destination runs are timed as phases of their own."""
        from lanczosplusplus_tpu_torch.engine.ftlm import start_block
        from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import (
            ftlm_dynamic, ftlm_source_runs)

        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        omegas = np.asarray(omegas, dtype=np.float64)
        total = np.zeros_like(omegas)
        ham_src = self.hamiltonian
        V0 = start_block(ham_src, start_vectors, num_vectors, seed).T
        src_steps = int(min(steps, ham_src.dim))
        with self.progress.phase(
                f"ftlm source runs R={V0.shape[1]} steps={src_steps}"):
            shared_runs = ftlm_source_runs(ham_src, V0, src_steps)
        for type_ in range(2):
            op = op1 if (type_ & 1) else op2
            got = self._get_needed_basis(self.parts, op, spin, orb)
            if got is None:
                continue
            new_parts, basis_new = got
            ham_new = self._cached_hamiltonian(new_parts)
            with self.progress.phase(
                    f"ftlm operator maps type {type_} sector {new_parts}"):
                apply = self._operator_rows(op, {isite: 1.0}, spin, orb,
                                            basis_new)
            with self.progress.phase(
                    f"ftlm destination runs type {type_} sector "
                    f"{new_parts}"):
                dyn = ftlm_dynamic(ham_src, ham_new, apply, steps=steps,
                                   start_vectors=V0,
                                   source_runs=shared_runs)
            grid = omegas if type_ == 0 else -omegas
            sgn = -1.0 if (type_ == 1 and not op1.is_fermionic) else 1.0
            total = total + sgn * dyn.evaluate(beta, grid, delta)
        return total

    def ftlm_sq_omega(self, op_name: str, beta: float, omegas,
                      delta: float = 0.1, spin: int = 0, orb: int = 0,
                      num_vectors: int = 16, steps: int = 100,
                      seed: int = 152917, start_vectors=None):
        """S(q, omega) at finite temperature for a sector-preserving
        operator (sz, n): S_q(w) = (1/Z) sum_nm e^{-b E_n}
        |<m|B_q|n>|^2 delta(w - E_m + E_n) with B_q = sum_j e^{iq r_j}
        op_j, estimated by the FTLM double-Krylov method.  The complex
        momentum operator splits into real cos/sin combinations
        (S_q = S_cos + S_sin), so the Hamiltonian stays real and one
        source fleet serves every momentum; a complex Hamiltonian raises.
        The per-site operator maps are built once.  The reference reaches
        S(q, w) only at T=0 (sqomega.pl) or through full spectra.
        Returns (qs, S[len(qs), len(omegas)])."""
        from lanczosplusplus_tpu_torch.engine.ftlm import start_block
        from lanczosplusplus_tpu_torch.engine.ftlm_dynamic import (
            ftlm_dynamic, ftlm_source_runs)

        op = LabeledOperator(op_name)
        if op.needs_new_basis:
            raise ValueError("ftlm_sq_omega: sector-preserving "
                             "operators only (sz, n)")
        ham = self.hamiltonian
        if ham.dtype.is_complex:
            # the cos/sin split S_q = S_cos + S_sin needs real matrix
            # elements; with complex eigenvectors the cross term
            # -2 Im(<m|C|n>* <m|S|n>) survives and the sum would
            # silently yield (S_q + S_-q)/2
            raise ValueError("ftlm_sq_omega: real Hamiltonians only "
                             "(complex eigenvectors break the cos/sin "
                             "momentum decomposition)")
        nsite = self.geometry.number_of_sites()
        omegas = np.asarray(omegas, dtype=np.float64)
        V0 = start_block(ham, start_vectors, num_vectors, seed).T
        src_steps = int(min(steps, ham.dim))
        with self.progress.phase(
                f"ftlm source runs R={V0.shape[1]} steps={src_steps}"):
            shared = ftlm_source_runs(ham, V0, src_steps)
        qs = 2.0 * np.pi * np.arange(nsite) / nsite
        out = np.zeros((nsite, omegas.shape[0]))
        for iq, q in enumerate(qs):
            for phase in (np.cos, np.sin):
                wsites = phase(q * np.arange(nsite))
                if np.abs(wsites).max() < 1e-14:
                    continue
                apply = self._operator_rows(
                    op, {site: w for site, w in enumerate(wsites)
                         if abs(w) >= 1e-14}, spin, orb, self.basis)
                dyn = ftlm_dynamic(ham, ham, apply, steps=steps,
                                   start_vectors=V0, source_runs=shared)
                out[iq] += dyn.evaluate(beta, omegas, delta)
        return qs, out

    # -- static correlators (reference: Engine.h:266-338) -----------------

    def _cached_operator_map(self, op, site, spin, orb, src_basis,
                             dst_basis=None):
        """Per-(op, site, spin, orb, source sector, destination sector)
        cache of the host index maps: building them dominates repeated
        observable calls at large dims.  An entry holds references to
        both bases, so the id()-based key cannot alias a collected
        basis."""
        if dst_basis is None:
            src_basis, dst_basis = self.basis, src_basis
        if not hasattr(self, "_opmap_cache"):
            self._opmap_cache = {}
        key = (op.name, site, spin, orb, id(src_basis), id(dst_basis))
        if key not in self._opmap_cache:
            self._opmap_cache[key] = (
                src_basis, dst_basis,
                self.model.operator_map(op, site, spin, orb,
                                        src_basis, dst_basis))
        return self._opmap_cache[key][2]

    def _batched_scatter_plan(self, op, dst_basis, spin, orb, dressed=True):
        """Scatter plan on the device for op_site |vec> over all sites:
        (valid_sites, flat targets k * dim + tgt, source indices,
        amplitudes), cached so repeated observable calls move only the
        state.  `dressed` applies the twoPoint sz -> (n_up - n_down)/2
        decomposition (Engine.h:537-599); spectral fleets pass
        dressed=False and use the model's own sz map (Engine.h:416-458)."""
        if not hasattr(self, "_scatter_plan_cache"):
            self._scatter_plan_cache = {}
        key = (op.name, spin, orb, id(dst_basis), dressed)
        if key in self._scatter_plan_cache:
            return self._scatter_plan_cache[key]
        n = self.geometry.number_of_sites()
        tgt_l, src_l, amp_l = [], [], []
        valid = []
        for site in range(n):
            if orb >= self.model.orbitals(site):
                continue
            k = len(valid)
            valid.append(site)
            if dressed and op.name == ops.SZ:
                # sz -> 0.5 n_up - 0.5 n_down (Engine.h:537-599)
                parts_ = [(LabeledOperator(ops.N), 0, 0.5),
                          (LabeledOperator(ops.N), 1, -0.5)]
            else:
                parts_ = [(op, spin, 1.0)]
            for (op_k, spin_k, factor) in parts_:
                tgt, amp, _ = self._cached_operator_map(
                    op_k, site, spin_k, orb, dst_basis)
                mask = tgt >= 0
                tgt_l.append(tgt[mask] + k * dst_basis.size)
                src_l.append(np.nonzero(mask)[0])
                amp_l.append(factor * amp[mask])
        plan = None
        if valid:
            dev = self.config.device
            plan = (valid,
                    torch.as_tensor(np.concatenate(tgt_l), device=dev),
                    torch.as_tensor(np.concatenate(src_l), device=dev),
                    torch.as_tensor(np.concatenate(amp_l), device=dev))
        self._scatter_plan_cache[key] = plan
        return plan

    def _batched_modified_states(self, op, dst_basis, vec, spin, orb,
                                 dressed=True):
        """(valid_sites, Z): Z[k] = (dressed) op_site |vec> for every
        valid site, built as one ``index_add_`` on the device: the batched
        accModifiedState_ (reference loops sites serially,
        Engine.h:416-458)."""
        plan = self._batched_scatter_plan(op, dst_basis, spin, orb,
                                          dressed=dressed)
        if plan is None:
            return [], None
        valid, tgts, src_idx, amps = plan
        contribs = amps * vec[src_idx]
        Z = torch.zeros(len(valid) * dst_basis.size, dtype=contribs.dtype,
                        device=vec.device)
        Z.index_add_(0, tgts, contribs)
        return valid, Z.view(len(valid), dst_basis.size)

    def two_point(self, op_name: str, spin=(0, 0), orbs=(0, 0),
                  bra_ket=(0, 0)):
        """C(i, j) = <bra| op^dag_j op_i |ket> for all site pairs.

        All modified states build as one batched scatter and the full
        pair matrix is one plain matrix product <Z_bra | Z_ket^T>
        (reference: Engine.h:266-338 loops pairs serially)."""
        op = LabeledOperator(op_name)
        n = self.geometry.number_of_sites()
        if op.needs_new_basis:
            if spin[0] != spin[1]:
                raise ValueError("two_point: off-diagonal spin with "
                                 "sector-changing operator unsupported")
            new_parts = self.model.has_new_parts(self.parts, op, spin[0],
                                                 orbs[0])
            if new_parts is None:
                return None
            basis_new = self._cached_basis(new_parts)
        else:
            basis_new = self.basis
        valid_i, Z_ket = self._batched_modified_states(
            op, basis_new, self.eigenvector(bra_ket[1]), spin[0], orbs[0])
        if (bra_ket[0] == bra_ket[1] and spin[0] == spin[1]
                and orbs[0] == orbs[1]):
            valid_j, Z_bra = valid_i, Z_ket
        else:
            valid_j, Z_bra = self._batched_modified_states(
                op, basis_new, self.eigenvector(bra_ket[0]), spin[1],
                orbs[1])
        result = np.full((n, n), np.nan, dtype=np.complex128)
        if Z_ket is None or Z_bra is None:
            return result
        # result[i, j] = <z_bra_j | z_ket_i>
        block = (Z_ket @ Z_bra.conj().T).cpu().numpy()
        result[np.ix_(valid_i, valid_j)] = block
        return result

    # -- many-point fixed-site correlator (reference: Engine.h:341-389) ---

    def many_point(self, sites, op_names, spins, orbs, bra_ket=(0, 0)):
        tmp = self.eigenvector(bra_ket[1])
        basis_old = self.basis
        old_parts = self.parts
        for k, site in enumerate(sites):
            if orbs[k] >= self.model.orbitals(site):
                continue
            op = LabeledOperator(op_names[k])
            got = self._get_needed_basis(old_parts, op, spins[k], orbs[k])
            if got is None:
                return 0.0
            new_parts, basis_new = got
            z = torch.zeros(basis_new.size, dtype=torch.complex128,
                            device=tmp.device)
            self.acc_modified_state(z, op, basis_new, tmp, basis_old,
                                    site, spins[k], orbs[k], 1.0)
            tmp = z
            basis_old = basis_new
            old_parts = new_parts
        if old_parts != self.parts:
            return 0.0
        bra = self.eigenvector(bra_ket[0]).to(torch.complex128)
        return complex(torch.vdot(bra, tmp.to(torch.complex128)).item())

    # -- measure mini-language (reference: Engine.h:208-249) --------------

    def measure(self, bra_op_ket: str):
        """'bra|op[site];...|ket' -> <bra| ops |ket> via the rahul
        method, on the host."""
        from lanczosplusplus_tpu_torch.engine import rahul

        parts = bra_op_ket.split("|")
        if len(parts) != 3:
            raise ValueError("measure: only dressed brakets allowed")
        bra_idx = rahul.parse_braket_level(parts[0])
        ket_idx = rahul.parse_braket_level(parts[2])
        tokens = [t for t in parts[1].split(";") if t]
        op_list, sites = [], []
        for t in tokens:
            op, site = rahul.parse_op_token(t)
            op_list.append(op)
            sites.append(site)
        ket = self.eigenvector(ket_idx).cpu().numpy()
        psi_new = rahul.rahul_apply(self.basis, op_list, sites, ket)
        bra = self.eigenvector(bra_idx).cpu().numpy()
        return complex(np.vdot(bra, psi_new))
