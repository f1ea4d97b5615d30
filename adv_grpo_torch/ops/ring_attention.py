"""Ring and context-parallel attention over a ``torch.distributed`` group.

Port of adv_grpo_tpu/ops/ring_attention.py. The JAX ops run inside
``shard_map`` over a mesh axis, with q/k/v sharded along the sequence
(B, H, S_local, D); here each rank of a process group holds its shard, and
the group stands for the mesh axis (``group=None``: the default group, or a
single process when none is initialized).

  ring_attention              an online softmax over the KV blocks of every
                              rank, passed around the ring with
                              ``batch_isend_irecv`` (the JAX ``ppermute``);
                              plain torch in fp32, as in JAX (no kernel);
  context_parallel_attention  all-gather the KV shards along S, then
                              :func:`adv_grpo_torch.ops.attention.mha` on the
                              local queries: kernels #10 / #11 on the card.

Both are differentiable. At world size 1 the ring's step is local, as
``ppermute`` over one device is, and the gather is a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from adv_grpo_torch.ops.attention import mha
from adv_grpo_torch.parallel import mesh


def _ring_pass(tensors, group):
    """Send ``tensors`` to the next rank of the ring and receive the previous
    rank's (the JAX ``perm = [(i, (i + 1) % n)]``)."""
    n, r = mesh.world_size(group), mesh.rank(group)
    buf = torch.cat([t.reshape(-1) for t in tensors])
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, mesh.global_rank(group, (r + 1) % n), group),
           dist.P2POp(dist.irecv, out, mesh.global_rank(group, (r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    res, offset = [], 0
    for t in tensors:
        res.append(out[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return res


class _Ring(torch.autograd.Function):
    """Ring attention with its backward: the forward keeps fp32 m, l, o and
    the lse; the backward walks the ring again from the saved lse, and each
    block's fp32 dk, dv travel with it, one hop more than the block itself,
    back to the rank that owns it."""

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale):
        n = mesh.world_size(group)
        qf = q.float()
        b, h, s, _ = qf.shape
        m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, s, 1), device=q.device)
        o = torch.zeros(qf.shape, device=q.device)
        kb, vb = k, v
        for step in range(n):
            sc = qf @ kb.float().transpose(-1, -2) * sm_scale
            m_next = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(sc - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            o = alpha * o + p @ vb.float()
            m = m_next
            if step + 1 < n:
                kb, vb = _ring_pass((kb, vb), group)
        l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
        out = (o * l_inv).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, (m + torch.log(l)).squeeze(-1))
        ctx.group, ctx.sm_scale = group, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, sm_scale = ctx.group, ctx.sm_scale
        n = mesh.world_size(group)
        qf, dof = q.float(), do.float()
        di = (out.float() * dof).sum(-1, keepdim=True)
        lse = lse[..., None]
        dq = torch.zeros_like(qf)
        kb, vb = k, v
        dkb, dvb = torch.zeros(k.shape, device=k.device), torch.zeros(v.shape, device=v.device)
        for step in range(n):
            kf, vf = kb.float(), vb.float()
            p = torch.exp(qf @ kf.transpose(-1, -2) * sm_scale - lse)
            dvb = dvb + p.transpose(-1, -2) @ dof
            ds = p * (dof @ vf.transpose(-1, -2) - di) * sm_scale
            dq = dq + ds @ kf
            dkb = dkb + ds.transpose(-1, -2) @ qf
            if n > 1:  # the block moves on; after the last step only dk, dv go home
                if step + 1 < n:
                    kb, vb, dkb, dvb = _ring_pass((kb, vb, dkb, dvb), group)
                else:
                    dkb, dvb = _ring_pass((dkb, dvb), group)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None


def ring_attention(q, k, v, group=None, *, sm_scale: Optional[float] = None):
    """Bidirectional full attention over seq-sharded q/k/v (B, H, S_local,
    D): rank r holds tokens [r * S_local, (r + 1) * S_local) of each."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k.contiguous(), v.contiguous(), group, float(sm_scale))


def gather_seq(x, group=None):
    """The full sequence of seq-sharded (B, H, S_local, D) shards,
    differentiably: forward all-gather, backward reduce-scatter."""
    n = mesh.world_size(group)
    b, h, s, d = x.shape
    out = mesh.all_gather_dim0_with_grad(x, group)  # the ranks' shards along dim 0
    return out.view(n, b, h, s, d).permute(1, 2, 0, 3, 4).reshape(b, h, n * s, d)


def context_parallel_attention(q, k, v, group=None, *, sm_scale: Optional[float] = None,
                               kv_len: Optional[int] = None):
    """All-gather-KV context parallelism: gather the KV shards, then run
    :func:`mha` (kernels #10 / #11 on the card) on the local query shard.
    ``kv_len`` masks keys of the gathered sequence."""
    return mha(q, gather_seq(k, group), gather_seq(v, group), sm_scale=sm_scale,
               kv_len=kv_len)
