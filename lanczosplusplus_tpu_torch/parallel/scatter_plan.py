"""Distributed sector-changing operator application.

Counterpart of ``lanczosplusplus_tpu/parallel/scatter_plan.py``.  A
c|gs>-style operator maps between two differently sharded index spaces.
``SectorScatterPlan`` precomputes on the host, from the operator's (tgt,
amp) index map (``model.operator_map``, the vectorized accModifiedState_,
reference: Engine.h:416-458):

- per (source rank -> destination rank) bucket: local source gather
  indices and amplitudes, padded to the largest bucket so one
  ``all_to_all_single`` moves them (padding has amplitude 0);
- per (destination rank <- source rank) local destination indices.

The tables come from the native host runtime's single pass
(``native.scatter_plan_tables``) where it builds, else from the JAX
package's numpy bucketing, copied (a host path either way).  An apply is
a local gather and multiply, one all-to-all of the contributions and a
local scatter-add (``index_add_``, whose order of addition on CUDA is not
fixed: results agree to rounding, not to the bit).
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosplusplus_tpu_torch.parallel.mesh import Mesh, _pad_to, _to_device


class SectorScatterPlan:
    """z[tgt[i]] += factor * amp[i] * x[i] across row-sharded ranks."""

    def __init__(self, tgt, amp, src_dim: int, dst_dim: int, ndev: int):
        from lanczosplusplus_tpu_torch import native

        tgt = np.asarray(tgt)
        amp = np.asarray(amp)
        self.src_dim = src_dim
        self.dst_dim = dst_dim
        self.src_pad = _pad_to(src_dim, ndev)
        self.dst_pad = _pad_to(dst_dim, ndev)
        self.ndev = ndev
        s_src = self.src_pad // ndev
        s_dst = self.dst_pad // ndev
        self.s_src, self.s_dst = s_src, s_dst

        tables = native.scatter_plan_tables(tgt, amp, s_src, s_dst, ndev)
        if tables is not None:
            (self.send_src, self.send_amp, self.dst_idx,
             self.maxcount) = tables
            return

        # numpy: whole-array bucketing (bincount and prefix-sum position
        # arithmetic, the HaloPlan pattern)
        valid = np.nonzero(tgt >= 0)[0]
        t_v = tgt[valid].astype(np.int64)
        d_of = (valid // s_src).astype(np.int64)
        o_of = t_v // s_dst
        key = d_of * ndev + o_of
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        counts = np.bincount(key_s, minlength=ndev * ndev)
        maxcount = max(int(counts.max(initial=0)), 1)
        offsets = np.zeros(ndev * ndev + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos = np.arange(key_s.shape[0], dtype=np.int64) - offsets[key_s]
        d_s = key_s // ndev
        o_s = key_s % ndev
        send_src = np.zeros((ndev, ndev, maxcount), np.int32)
        send_amp = np.zeros((ndev, ndev, maxcount), amp.dtype)
        dst_idx = np.zeros((ndev, ndev, maxcount), np.int32)
        send_src[d_s, o_s, pos] = valid[order] - d_s * s_src
        send_amp[d_s, o_s, pos] = amp[valid][order]
        dst_idx[o_s, d_s, pos] = t_v[order] - o_s * s_dst  # receiver-major
        self.send_src = send_src
        self.send_amp = send_amp
        self.dst_idx = dst_idx
        self.maxcount = maxcount

    def device_arrays(self, mesh: Mesh):
        """This rank's (send_src, send_amp, dst_idx), each (ndev,
        maxcount), on its device."""
        r = mesh.rank
        return (_to_device(self.send_src[r], mesh, torch.int64),
                _to_device(self.send_amp[r], mesh),
                _to_device(self.dst_idx[r], mesh, torch.int64))

    def apply(self, mesh: Mesh, x, factor=1.0, out_dtype=None):
        """x: this rank's rows (s_src,) of the padded source vector.
        Returns this rank's rows (s_dst,) of the padded result."""
        send_src, send_amp, dst_idx = self.device_arrays(mesh)
        x = torch.as_tensor(x, device=mesh.device)
        out_dtype = out_dtype or torch.promote_types(
            torch.promote_types(x.dtype, send_amp.dtype),
            torch.as_tensor(factor).dtype)
        vals = (send_amp * x[send_src]).to(out_dtype)   # (ndev, maxcount)
        recv = mesh.all_to_all(vals)
        z = torch.zeros(self.s_dst, dtype=out_dtype, device=mesh.device)
        z.index_add_(0, dst_idx.reshape(-1), recv.reshape(-1))
        return z * torch.as_tensor(factor, dtype=out_dtype)


def distributed_apply_operator_map(tgt, amp, dst_dim, x, mesh: Mesh,
                                   factor=1.0):
    """Distributed ``engine.apply_operator_map``: x is the whole source
    vector (array or tensor); returns the whole unpadded (dst_dim,)
    result on every rank."""
    plan = SectorScatterPlan(tgt, amp, len(np.asarray(tgt)), dst_dim,
                             mesh.size)
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    out = plan.apply(mesh, mesh.local_rows(x, plan.src_pad), factor=factor)
    return mesh.gather_rows(out)[:dst_dim]
