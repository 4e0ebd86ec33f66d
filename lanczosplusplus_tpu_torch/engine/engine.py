"""Engine: sector diagonalization on construction, then observables.

Counterpart of ``lanczosplusplus_tpu/engine/engine.py``: the ground state
(``Engine.__init__``, ``hamiltonian``, ``energies``, ``eigenvector``), the
sector caches, operator application across sectors
(``apply_operator_map``, ``acc_modified_state``), continued-fraction
spectral functions serial and batched (``spectral_function``,
``spectral_functions_batched``), and the static observables
(``two_point``, ``many_point``, ``measure``); itself a functional
re-design of the reference Engine (reference: src/Engine/Engine.h:84-98
ctor diagonalizes; 601-657 computeAllStatesBelow; observable entry points
113-389).  Symmetry sectors, factored forms and the KPM and FTLM
estimators are not ported yet and raise.

States are tensors on the configured device; operator index maps are
built on the host in numpy and applied there as ``index_add_`` scatters.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.config import Config
from lanczosplusplus_tpu_torch.engine import operators as ops
from lanczosplusplus_tpu_torch.engine.operators import LabeledOperator
from lanczosplusplus_tpu_torch.engine.spectral import (
    ContinuedFraction, ContinuedFractionCollection)
from lanczosplusplus_tpu_torch.solver import lanczos as lz
from lanczosplusplus_tpu_torch.utils.progress import ProgressIndicator

COMPLEX_ON_CARD = ("the CUDA kernels take no complex values yet (ROADMAP "
                   "Queue 2 items 1-2): a useComplex spectral run needs "
                   "--device cpu")


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
    labels on ``cuda``; `v0` is an optional start vector for the solve."""

    def __init__(self, model, inp, config: Config | None = None, v0=None):
        self.progress = ProgressIndicator("Engine")
        self.model = model
        self.inp = inp
        self.config = config or Config.from_input(inp)
        self.excited = inp.integer("Excited", default=0)
        if (inp.integer("UseTranslationSymmetry", default=0) or
                inp.integer("UseReflectionSymmetry", default=0)):
            raise NotImplementedError(
                "symmetry sectors are not ported yet (ROADMAP Queue 1 "
                "item 12)")
        if "factored" in inp.solver_options():
            raise NotImplementedError(
                "SolverOptions=factored is not ported yet (ROADMAP Queue 1 "
                "item 10)")
        self.parts = model.default_parts(inp)
        self.basis = model.create_basis(self.parts)
        self._flat_ham = None
        with self.progress.phase(
                f"diagonalization dim={self.basis.size}"):
            self._energies, self._vectors, info = lz.lowest_states(
                self.hamiltonian, num_states=self.excited + 1,
                seed=self.config.seed,
                max_steps=self.config.lanczos_steps,
                return_info=True, v0=v0)
            self._log_solve(info)

    def _log_solve(self, info):
        """Reference-style convergence report (Engine.h:624-639 prints
        'lanczos solver failed ... trying fullDiag')."""
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
        """A sector's Hamiltonian on the configured device.  On CUDA the
        Kronecker one-spin factors are densified, so every matvec runs as
        two ``factor_matmul`` GEMMs, or raises where a factor does not
        fit; the CPU keeps the gather form.  The form taken is logged."""
        ham = self.model.hamiltonian(basis, dtype=self.config.scalar_dtype,
                                     device=self.config.device)
        if self.config.device.type == "cuda":
            ham = ham.densify_factors()
        f = ham.factorized
        if f is not None:
            dense = [tuple(d.shape) for d in (f.up_dense, f.dn_dense)
                     if d is not None]
            self.progress(
                f"one-spin factors on {ham.device}: "
                + (f"dense {dense} through factor_matmul" if dense
                   else "gather form (plain PyTorch)"))
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
        if parts == self.parts:
            return self.hamiltonian
        if not hasattr(self, "_ham_cache"):
            self._ham_cache = {}
        if parts not in self._ham_cache:
            self._ham_cache[parts] = self._build_hamiltonian(
                self._cached_basis(parts))
        return self._ham_cache[parts]

    def _cached_dense_hamiltonian(self, parts):
        """Dense-factor (GEMM) form of a sector Hamiltonian for batched
        recurrences, on every device: the gather form would materialize
        an (R, dim) intermediate per hop bond, the densified factors make
        each block step two GEMMs.  On CUDA ``_cached_hamiltonian`` is
        this form already."""
        if not hasattr(self, "_dense_ham_cache"):
            self._dense_ham_cache = {}
        if parts not in self._dense_ham_cache:
            self._dense_ham_cache[parts] = \
                self._cached_hamiltonian(parts).densify_factors()
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

    def _refuse_complex_on_card(self):
        if self.config.use_complex and self.config.device.type == "cuda":
            raise NotImplementedError(COMPLEX_ON_CARD)

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
        self._refuse_complex_on_card()
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
        self._refuse_complex_on_card()
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
