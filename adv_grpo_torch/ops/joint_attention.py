"""Joint two-stream attention with fused qk-RMS, and its single-stream variant.

Port of adv_grpo_tpu/ops/joint_attention.py. MMDiT's joint attention is
per-head RMS on q/k of each stream, concat [image ; text], full bidirectional
attention, split (the diffusers JointAttnProcessor contract); ``mha_rms`` is
the single-stream form used by SD3.5's dual self-attention.

Forward: on CUDA tensors both launch the wgmma + TMA kernel of
``csrc/attention_fwd_sm90.cu`` (#2 ``joint_attention_fwd_bf16``, #3
``mha_rms_fwd_bf16``), which walks the kv tiles of the image stream and then
of the text stream in one online softmax, straight from the (B, S, H*D)
projection layout (D = 64, SD3.5, with the qk-RMS fused; or D = 128, Flux,
whose qk-norm and RoPE come before), and writes the per-row log-sum-exp when
a backward will need it. With RMS weights the same C entry first writes the
normalised k into a scratch the wrapper keeps per stream (``rms_k_kernel``),
and normalises q inside the attention kernel. On CPU tensors they run the
plain versions, which follow the JAX ``backend="reference"`` path op for op:
RMS (cast back to the input dtype), concat, fp32 softmax, split.
:func:`joint_fwd_tiled_reference` is the kernel's twin: it rounds where the
kernel rounds.

Backward (``torch.autograd.Function``s mirroring the JAX ``_joint_mha_p`` /
``_mha_rms_p`` custom VJPs): di = sum o * do per row (:func:`bwd_row_stats`),
then the backward gives the cotangents of the NORMALISED q and k and of v,
and the closed-form RMS backward turns those into dq, dk and the RMS-weight
gradients. On CUDA tensors the C entries ``joint_attention_bwd_bf16`` (#4)
and ``mha_rms_bwd_bf16`` (#5) launch the wgmma + TMA backward of
``csrc/attention_bwd_sm90.cu`` in its joint mode: a pre-pass writes q^, q_s
and (with RMS weights) k^ of each stream into a scratch the wrapper keeps
per (device, stream) and zeroes the fp32 dq scratch beside it, then the
backward and the dq convert run. On CPU tensors the plain twin
:func:`attention_bwd_reference` runs, in the kernel's op order. q^ and k^
come from the same code as the forward's (:func:`joint_operands` here,
``csrc/sm90.cuh`` on the card), so the backward's p is the forward's. The
wgmma joint backward takes bf16 at D = 64 (with or without RMS) and D = 128
(without RMS, Flux's double blocks); the single-stream one D = 64.

Where :func:`adv_grpo_torch.ops.attention.attention_route` says "generic"
(fp32 at any head width up to 128, bf16 at the other widths up to 128, and
the backward of the single stream and of the fused RMS at 128), the same
wrappers launch the generic kernels of ``csrc/attention_generic_*.cu``
instead (:func:`_generic_fwd`, :func:`_generic_bwd`), in the twins' op
order, and count them in ``generic_launches``.
"""

from __future__ import annotations

import torch

from adv_grpo_torch.kernels import build as _kernels
from adv_grpo_torch.ops.attention import (
    LOG2E, attention_reference, bwd_row_stats, check_rows, check_stats, generic_attention,
    int64_array, route_of)
from adv_grpo_torch.ops.attention import from_bhsd as _from4
from adv_grpo_torch.ops.attention import to_bhsd as _to4
from adv_grpo_torch.ops.fused_norms import rms_bwd_closed, rms_reference

def joint_mha_reference(q_img, k_img, v_img, q_txt, k_txt, v_txt, *, num_heads,
                        rms_weights=None, eps=1e-6, sm_scale=None, return_lse=False):
    """Plain two-stream joint attention -> (o_img, o_txt), and with
    ``return_lse`` also (lse_img, lse_txt), fp32 (B, H, S) each."""
    s_i = q_img.shape[1]
    if sm_scale is None:
        sm_scale = (q_img.shape[-1] // num_heads) ** -0.5
    if rms_weights is not None:
        wq_i, wk_i, wq_t, wk_t = rms_weights
        q_img = rms_reference(q_img, wq_i, num_heads, eps, q_img.dtype)
        k_img = rms_reference(k_img, wk_i, num_heads, eps, k_img.dtype)
        q_txt = rms_reference(q_txt, wq_t, num_heads, eps, q_txt.dtype)
        k_txt = rms_reference(k_txt, wk_t, num_heads, eps, k_txt.dtype)
    q = torch.cat([_to4(q_img, num_heads), _to4(q_txt, num_heads)], dim=2)
    k = torch.cat([_to4(k_img, num_heads), _to4(k_txt, num_heads)], dim=2)
    v = torch.cat([_to4(v_img, num_heads), _to4(v_txt, num_heads)], dim=2)
    o4, lse = attention_reference(q, k, v, sm_scale=sm_scale, return_lse=True)
    o = _from4(o4)
    if return_lse:
        return o[:, :s_i], o[:, s_i:], lse[..., :s_i], lse[..., s_i:]
    return o[:, :s_i], o[:, s_i:]


def mha_rms_reference(q, k, v, *, num_heads, rms_weights=None, eps=1e-6,
                      sm_scale=None, return_lse=False):
    """Plain single-stream (B, S, H*D) attention with per-head qk-RMS; with
    ``return_lse`` -> (o, lse)."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if rms_weights is not None:
        wq, wk = rms_weights
        q = rms_reference(q, wq, num_heads, eps, q.dtype)
        k = rms_reference(k, wk, num_heads, eps, k.dtype)
    o, lse = attention_reference(_to4(q, num_heads), _to4(k, num_heads),
                                 _to4(v, num_heads), sm_scale=sm_scale, return_lse=True)
    return (_from4(o), lse) if return_lse else _from4(o)


# the forward kernel's kv tile (csrc/attention_fwd_sm90.cu kBKV)
KV_TILE = 128
LN2 = 0.6931471805599453


def _sum_sq(xf, halves):
    """Sum over the last dim of xf^2 in the forward kernel's order, (..., 1):
    each 8-column chunk summed in column order, then the chunk sums in chunk
    order; with ``halves`` (a q row, two threads in the kernel) the chunks
    c % 8 < 4 and the others summed apart, then the two added."""
    sq = xf * xf
    if sq.shape[-1] % 8:  # a partial last chunk: zeros add nothing
        sq = torch.nn.functional.pad(sq, (0, -sq.shape[-1] % 8))
    part = sq.unflatten(-1, (-1, 8))
    chunk = part[..., 0]
    for e in range(1, 8):
        chunk = chunk + part[..., e]
    n = chunk.shape[-1]
    groups = ([[c for c in range(n) if c % 8 < 4], [c for c in range(n) if c % 8 >= 4]]
              if halves else [list(range(n))])
    sums = []
    for g in filter(None, groups):  # a head narrower than 64 has one half
        ss = chunk[..., g[0]]
        for c in g[1:]:
            ss = ss + chunk[..., c]
        sums.append(ss)
    return (sums[0] if len(sums) == 1 else sums[0] + sums[1])[..., None]


def _operand(x, w, num_heads, eps, halves, scale=None):
    """(B, H, S, D) fp32 of the (B, S, H*D) ``x`` as the joint kernels read
    it: with the RMS weight ``w``, dt(x * 1 / sqrt(sum(x^2) * (1 / D) + eps) *
    w [* scale]), the sum of squares in the kernels' order (:func:`_sum_sq`,
    ``halves`` for q); without it dt(x * scale), or x as stored without a
    scale; dt is x's dtype."""
    xf = _to4(x, num_heads).float()
    if w is not None:
        ss = _sum_sq(xf, halves)
        xf = xf * (1.0 / torch.sqrt(ss * (1.0 / xf.shape[-1]) + eps)) * w.float()
    elif scale is None:
        return xf
    if scale is not None:
        xf = xf * scale
    return xf.to(x.dtype).float()


def joint_operands(qs, ks, *, num_heads, rms_weights=None, eps=1e-6, sm_scale=None):
    """Per token stream, (q^, q_s, k^) as the joint kernels form them, fp32
    (B, H, S_i, D) of values in the inputs' dtype dt: q^ = dt(yq * sm_scale *
    log2 e) (the scores' operand, in base 2), q_s = dt(yq * sm_scale) (the
    backward's dk operand) and k^ = dt(yk), with yq = rms(q) * wq and yk =
    rms(k) * wk in fp32 (q and k as stored without weights; k^ is then k
    itself), rms(x) = x * 1 / sqrt(sum(x^2) * (1 / D) + eps). The forward (q^ and
    k^) and the backward's pre-pass (all three) form them with one code on
    the card (``csrc/sm90.cuh``), and both twins take them from here: so the
    backward's p = exp2(q^ k^T - lse * log2 e) is the forward's. ``qs``,
    ``ks``: one (B, S_i, H*D) tensor per stream; ``rms_weights``: None or one
    (wq, wk) pair per stream."""
    if sm_scale is None:
        sm_scale = (qs[0].shape[-1] // num_heads) ** -0.5
    ws = rms_weights or [(None, None)] * len(qs)
    return [(_operand(q, w[0], num_heads, eps, True, sm_scale * LOG2E),
             _operand(q, w[0], num_heads, eps, True, sm_scale),
             _operand(k, w[1], num_heads, eps, False)) for q, k, w in zip(qs, ks, ws)]


def joint_fwd_tiled_reference(qs, ks, vs, *, num_heads, rms_weights=None, eps=1e-6,
                              sm_scale=None):
    """Plain twin of the joint forward kernel (#2, and #3 with one stream), in
    its op order: ([o per stream], [lse per stream]).

    ``qs``, ``ks``, ``vs``: one (B, S_i, H*D) tensor per token stream (image,
    then text; a single stream for ``mha_rms``); ``rms_weights``: None, or one
    (wq, wk) pair per stream. o comes back in the inputs' dtype, lse in fp32
    (B, H, S_i), natural log.

    Op order (the TPU's ``_joint_fwd_kernel`` / ``_single_fwd_kernel``): in
    fp32, q^ and k^ of :func:`joint_operands`, dt the inputs' dtype; s = q^
    k^T in fp32, in base 2; then the kernel's walk: an online softmax over 128-row kv tiles
    of the first stream and then of the second, with p = exp2(s - running
    max) cast to dt for p.v, the sum of the unrounded p, fp32 accumulation;
    o = acc / l (l == 0 divides by 1); lse = ln2 * (m + log2 max(l, 1e-37)).
    """
    dt = qs[0].dtype
    ops = joint_operands(qs, ks, num_heads=num_heads, rms_weights=rms_weights, eps=eps,
                         sm_scale=sm_scale)
    q = torch.cat([o[0] for o in ops], dim=2)
    tiles = [kv for (_, _, k), v in zip(ops, vs) if k.shape[2]
             for kv in zip(k.split(KV_TILE, dim=2),
                           _to4(v, num_heads).float().split(KV_TILE, dim=2))]
    m = torch.full(q.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k, v in tiles:
        s = q @ k.transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * a + p.sum(-1, keepdim=True)
        acc = acc * a + p.to(dt).float() @ v
        m = m_new
    o = acc / torch.where(l == 0, torch.ones_like(l), l)
    lse = ((m + torch.log2(l.clamp_min(1e-37))) * LN2)[..., 0]
    lens = [x.shape[1] for x in qs]
    return [_from4(c).to(dt) for c in o.split(lens, dim=2)], list(lse.split(lens, dim=-1))


def attention_bwd_reference(qs, ks, vs, dos, lses, dis, *, num_heads, rms_weights=None,
                            eps=1e-6, sm_scale=None):
    """Plain twin of the joint attention backward kernels (#4, #5), in their
    op order.

    ``qs``, ``ks``, ``vs``, ``dos``: one (B, S_i, H*D) tensor per token
    stream (image, then text; a single stream for ``mha_rms``); ``lses``,
    ``dis``: fp32 (B, H, S_i) per stream. ``rms_weights``: None, or one (wq,
    wk) pair per stream. Returns (dyq, dyk, dv) per stream — the cotangents
    of the normalised q and k, and of v — in the inputs' dtype.

    Op order (the TPU's fused bodies, adv_grpo_tpu/ops/joint_attention.py
    ``_joint_bwd_kernel`` / ``_single_bwd_kernel``), dt the inputs' dtype:
    q^, q_s and k^ of :func:`joint_operands` (the pre-pass's; q^ and k^ the
    forward's own); s = q^ k^T; p = exp2(s - lse * log2 e); dv = dt(p)^T do; dp = do v^T; t =
    dt(p * (dp - di)); dyk = t^T q_s; dyq = (t k^) * sm_scale — one rounding
    fewer than the TPU's t dt(k^ * sm_scale), equal to it when sm_scale is a
    power of two (head width 64); fp32 accumulation.
    """
    dt = qs[0].dtype
    if sm_scale is None:
        sm_scale = (qs[0].shape[-1] // num_heads) ** -0.5
    ops = joint_operands(qs, ks, num_heads=num_heads, rms_weights=rms_weights, eps=eps,
                         sm_scale=sm_scale)
    q_hat, q_s, k_hat = (torch.cat([o[i] for o in ops], dim=2) for i in range(3))
    v = torch.cat([_to4(a, num_heads) for a in vs], dim=2).float()
    do = torch.cat([_to4(a, num_heads) for a in dos], dim=2).float()
    lse2 = torch.cat(lses, dim=-1)[..., None].float() * LOG2E
    di = torch.cat(dis, dim=-1)[..., None].float()

    p = torch.exp2(q_hat @ k_hat.transpose(-1, -2) - lse2)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    t = (p * (do @ v.transpose(-1, -2) - di)).to(dt).float()
    dyk = t.transpose(-1, -2) @ q_s
    dyq = (t @ k_hat) * sm_scale

    q_lens, kv_lens = [q.shape[1] for q in qs], [k.shape[1] for k in ks]
    outs = [[_from4(c).to(dt) for c in torch.split(a, lens, dim=2)]
            for a, lens in ((dyq, q_lens), (dyk, kv_lens), (dv, kv_lens))]
    return [tuple(o[i] for o in outs) for i in range(len(qs))]


# ─────────────────────────── kernel wrappers ───────────────────────────


def _check_stream(what, tensors, batch, hd, device, dtype):
    """Validate one stream's (B, S, H*D) ``dtype`` tensors for a kernel;
    return S."""
    check_rows(what, tensors, device, dtype)
    length = tensors[0].shape[1]
    for t in tensors:
        if t.shape != (batch, length, hd):
            raise ValueError(f"{what}: expected {(batch, length, hd)}, got {tuple(t.shape)}")
    return length


def _check_weights(what, weights, n, d, device):
    """Validate the (d,) RMS weights; return their n device pointers (None if
    absent)."""
    if weights is None:
        return [None] * n
    if len(weights) != n:
        raise ValueError(f"{what}: expected {n} RMS weights, got {len(weights)}")
    for w in weights:
        if (w.device != device or w.dtype != torch.float32 or w.shape != (d,)
                or not w.is_contiguous()):
            raise ValueError(f"{what}: RMS weights must be contiguous fp32 ({d},) on {device}")
    return [w.data_ptr() for w in weights]


def _strides(*tensors):
    return int64_array([st for t in tensors for st in (t.stride(0), t.stride(1))])


def _geometry(what, q):
    """(batch, width) of a kernel call on the card; raises on an empty first
    stream."""
    b, s, hd = q.shape
    if s < 1:
        raise ValueError(f"{what}: empty image stream")
    return b, hd


def _generic_fwd(qs, ks, vs, rms_weights, num_heads, d, eps, sm_scale, want_lse):
    """The generic forward on one or two streams (lists of (B, S_i, H*D));
    ``rms_weights``: None or one (wq, wk) pair per stream. Returns ([o per
    stream], [lse per stream or None])."""
    b, _, hd = qs[0].shape
    dev, dt = qs[0].device, qs[0].dtype
    streams = []
    for i, (q, k, v) in enumerate(zip(qs, ks, vs)):
        s = q.shape[1]
        wq, wk = rms_weights[i] if rms_weights else (None, None)
        streams.append(dict(
            q_rows=s, kv_rows=k.shape[1], kv_valid=k.shape[1], q=q, k=k, v=v,
            o=torch.empty((b, s, hd), dtype=dt, device=dev),
            lse=_lse_out(b, num_heads, s, dev, want_lse), wq=wq, wk=wk,
            qhat=torch.empty((b, s, hd), dtype=dt, device=dev),
            khat=None if wk is None else torch.empty(k.shape, dtype=dt, device=dev)))
    generic_attention("fwd", "joint", streams, batch=b, num_heads=num_heads, d=d,
                      sm_scale=sm_scale, eps=eps)
    return [st["o"] for st in streams], [st["lse"] for st in streams]


def _generic_bwd(qs, ks, vs, dos, lses, dis, rms_weights, num_heads, d, eps, sm_scale):
    """The generic backward on one or two streams: [(dyq, dyk, dv) per
    stream], as :func:`attention_bwd_reference` gives them."""
    b, _, hd = qs[0].shape
    dev, dt = qs[0].device, qs[0].dtype
    streams = []
    for i, (q, k, v, do, lse, di) in enumerate(zip(qs, ks, vs, dos, lses, dis)):
        wq, wk = rms_weights[i] if rms_weights else (None, None)
        streams.append(dict(
            q_rows=q.shape[1], kv_rows=k.shape[1], kv_valid=k.shape[1], q=q, k=k, v=v, do=do,
            dq=torch.empty(q.shape, dtype=dt, device=dev),
            dk=torch.empty(k.shape, dtype=dt, device=dev),
            dv=torch.empty(v.shape, dtype=dt, device=dev), lse=lse, di=di, wq=wq, wk=wk,
            qhat=torch.empty(q.shape, dtype=dt, device=dev),
            # the fp32 kernels read q^ for dk too: no q_s scratch
            qs=None if dt == torch.float32 else torch.empty(q.shape, dtype=dt, device=dev),
            khat=None if wk is None else torch.empty(k.shape, dtype=dt, device=dev)))
    generic_attention("bwd", "joint", streams, batch=b, num_heads=num_heads, d=d,
                      sm_scale=sm_scale, eps=eps)
    return [(st["dq"], st["dk"], st["dv"]) for st in streams]


def _lse_out(b, num_heads, s, dev, want):
    return torch.empty((b, num_heads, s), dtype=torch.float32, device=dev) if want else None


def _ptr(t):
    return None if t is None else t.data_ptr()


# the C entries' scratch, per (name, device, stream): reused from call to
# call (an entry writes it and reads it back before any later launch on
# that stream runs), grown when a call needs more
_SCRATCH = {}


def _scratch(name, n, dtype, dev, stream):
    """A 1-D ``dtype`` tensor of at least ``n`` elements on ``dev``, kept for
    ``stream``."""
    buf = _SCRATCH.get((name, dev, stream))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[name, dev, stream] = torch.empty((n,), dtype=dtype, device=dev)
    return buf


def _khat_ptrs(rms_weights, b, lens, hd, dev, stream):
    """Device pointers of the bf16 (B, S, H*D) scratch, one per stream,
    into which the forward's C entry writes the normalised k before the
    attention reads it; Nones without RMS weights."""
    if rms_weights is None:
        return [None] * len(lens)
    base, ptrs = _scratch("khat", b * sum(lens) * hd, torch.bfloat16, dev, stream).data_ptr(), []
    for n in lens:
        ptrs.append(base)
        base += 2 * b * n * hd
    return ptrs


def joint_attention_fwd(q_img, k_img, v_img, q_txt, k_txt, v_txt, rms_weights, num_heads,
                   eps, sm_scale, want_lse):
    """(o_img, o_txt, lse_img, lse_txt): the kernel on CUDA, the plain version
    on the CPU; the lse are None unless ``want_lse``."""
    route, d = route_of("joint_mha", q_img, num_heads, mode="joint",
                        rms=rms_weights is not None)
    if route == "plain":
        out = joint_mha_reference(q_img, k_img, v_img, q_txt, k_txt, v_txt,
                                  num_heads=num_heads, rms_weights=rms_weights, eps=eps,
                                  sm_scale=sm_scale, return_lse=want_lse)
        return out if want_lse else (*out, None, None)
    b, hd = _geometry("joint_mha", q_img)
    dev = q_img.device
    s_i = _check_stream("joint_mha", (q_img, k_img, v_img), b, hd, dev, q_img.dtype)
    s_t = _check_stream("joint_mha", (q_txt, k_txt, v_txt), b, hd, dev, q_img.dtype)
    w = _check_weights("joint_mha", rms_weights, 4, d, dev)
    if route == "generic":
        pairs = None if rms_weights is None else [tuple(rms_weights[:2]),
                                                  tuple(rms_weights[2:])]
        (o_img, o_txt), (lse_img, lse_txt) = _generic_fwd(
            [q_img, q_txt], [k_img, k_txt], [v_img, v_txt], pairs, num_heads, d, eps,
            sm_scale, want_lse)
        joint_mha.generic_launches += 1
        return o_img, o_txt, lse_img, lse_txt
    o_img = torch.empty((b, s_i, hd), dtype=torch.bfloat16, device=dev)
    o_txt = torch.empty((b, s_t, hd), dtype=torch.bfloat16, device=dev)
    lse_img = _lse_out(b, num_heads, s_i, dev, want_lse)
    lse_txt = _lse_out(b, num_heads, s_t, dev, want_lse)
    stream = _kernels.stream_ptr(dev)
    khat = _khat_ptrs(rms_weights, b, (s_i, s_t), hd, dev, stream)
    strides = _strides(q_img, k_img, v_img, o_img, q_txt, k_txt, v_txt, o_txt)
    rc = _kernels.lib().joint_attention_fwd_bf16(
        q_img.data_ptr(), k_img.data_ptr(), v_img.data_ptr(), o_img.data_ptr(),
        _ptr(lse_img), s_i, q_txt.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(),
        o_txt.data_ptr(), _ptr(lse_txt), s_t, strides, *w, *khat, b, num_heads, d,
        float(sm_scale * LOG2E), float(eps), stream)
    _kernels.check(rc, "joint_mha")
    joint_mha.launches += 1
    return o_img, o_txt, lse_img, lse_txt


def mha_rms_fwd(q, k, v, rms_weights, num_heads, eps, sm_scale, want_lse):
    """(o, lse): the kernel on CUDA, the plain version on the CPU."""
    route, d = route_of("mha_rms", q, num_heads, mode="single", rms=rms_weights is not None)
    if route == "plain":
        out = mha_rms_reference(q, k, v, num_heads=num_heads, rms_weights=rms_weights,
                                eps=eps, sm_scale=sm_scale, return_lse=want_lse)
        return out if want_lse else (out, None)
    b, hd = _geometry("mha_rms", q)
    dev = q.device
    s = _check_stream("mha_rms", (q, k, v), b, hd, dev, q.dtype)
    w = _check_weights("mha_rms", rms_weights, 2, d, dev)
    if route == "generic":
        (o,), (lse,) = _generic_fwd([q], [k], [v], None if rms_weights is None
                                    else [tuple(rms_weights)], num_heads, d, eps, sm_scale,
                                    want_lse)
        mha_rms.generic_launches += 1
        return o, lse
    o = torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev)
    lse = _lse_out(b, num_heads, s, dev, want_lse)
    stream = _kernels.stream_ptr(dev)
    (khat,) = _khat_ptrs(rms_weights, b, (s,), hd, dev, stream)
    rc = _kernels.lib().mha_rms_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), s,
        _strides(q, k, v, o), *w, khat, b, num_heads, d, float(sm_scale * LOG2E), float(eps),
        stream)
    _kernels.check(rc, "mha_rms")
    mha_rms.launches += 1
    return o, lse


def _bwd_scratch_ptrs(b, lens, hd, rms, dev, stream):
    """Device pointers of the joint backward's scratch: the bf16 operands
    its pre-pass writes (per stream q^, q_s and, with RMS weights, k^) and
    the fp32 dq accumulator it zeroes."""
    rows = b * sum(lens) * hd
    return (_scratch("bwd_operands", (3 if rms else 2) * rows, torch.bfloat16, dev,
                     stream).data_ptr(),
            _scratch("bwd_dq", rows, torch.float32, dev, stream).data_ptr())


def bwd_operands(q, lens, rms):
    """Per stream, (q^, q_s, k^ or None): the operands the joint backward's
    pre-pass wrote in its last call on the current stream of ``q``'s device,
    as bf16 (B, S, H*D) views of its scratch; ``q`` is a (B, S, H*D) input
    of that call, ``lens`` the streams' lengths, ``rms`` whether it had RMS
    weights."""
    b, _, hd = q.shape
    ops = _SCRATCH["bwd_operands", q.device, _kernels.stream_ptr(q.device)]
    out, base, n_ops = [], 0, 3 if rms else 2
    for s in lens:
        n = b * s * hd
        views = [ops[base + i * n:base + (i + 1) * n].view(b, s, hd) for i in range(n_ops)]
        base += n_ops * n
        out.append((views[0], views[1], views[2] if rms else None))
    return out


def joint_attention_bwd(q_img, k_img, v_img, q_txt, k_txt, v_txt, do_img, do_txt,
                        lse_img, lse_txt, di_img, di_txt, *, num_heads, rms_weights=None,
                        eps=1e-6, sm_scale=None):
    """(dyq_img, dyk_img, dv_img, dyq_txt, dyk_txt, dv_txt): the joint backward
    kernel on CUDA tensors, its plain twin :func:`attention_bwd_reference` on
    CPU tensors. lse/di: fp32 (B, H, S) per stream."""
    if sm_scale is None:
        sm_scale = (q_img.shape[-1] // num_heads) ** -0.5
    what = "joint_attention_bwd"
    route, d = route_of(what, q_img, num_heads, mode="joint", rms=rms_weights is not None,
                        direction="bwd")
    w = rms_weights
    pairs = None if w is None else [(w[0], w[1]), (w[2], w[3])]
    if route == "plain":
        img, txt = attention_bwd_reference(
            [q_img, q_txt], [k_img, k_txt], [v_img, v_txt], [do_img, do_txt],
            [lse_img, lse_txt], [di_img, di_txt], num_heads=num_heads,
            rms_weights=pairs, eps=eps, sm_scale=sm_scale)
        return (*img, *txt)
    b, hd = _geometry(what, q_img)
    dev = q_img.device
    s_i = _check_stream(what, (q_img, k_img, v_img, do_img), b, hd, dev, q_img.dtype)
    s_t = _check_stream(what, (q_txt, k_txt, v_txt, do_txt), b, hd, dev,
                        q_img.dtype)
    check_stats(what, (lse_img, di_img), b, num_heads, s_i, dev)
    check_stats(what, (lse_txt, di_txt), b, num_heads, s_t, dev)
    w = _check_weights(what, rms_weights, 4, d, dev)
    if route == "generic":
        img, txt = _generic_bwd([q_img, q_txt], [k_img, k_txt], [v_img, v_txt],
                                [do_img, do_txt], [lse_img, lse_txt], [di_img, di_txt], pairs,
                                num_heads, d, eps, sm_scale)
        joint_attention_bwd.generic_launches += 1
        return (*img, *txt)
    outs = [torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev)
            for s in (s_i, s_i, s_i, s_t, s_t, s_t)]
    strides = _strides(q_img, k_img, v_img, do_img, q_txt, k_txt, v_txt, do_txt)
    stream = _kernels.stream_ptr(dev)
    scratch = _bwd_scratch_ptrs(b, (s_i, s_t), hd, rms_weights is not None, dev, stream)
    rc = _kernels.lib().joint_attention_bwd_bf16(
        q_img.data_ptr(), k_img.data_ptr(), v_img.data_ptr(), do_img.data_ptr(),
        lse_img.data_ptr(), di_img.data_ptr(), *(o.data_ptr() for o in outs[:3]), s_i,
        q_txt.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(), do_txt.data_ptr(),
        lse_txt.data_ptr(), di_txt.data_ptr(), *(o.data_ptr() for o in outs[3:]), s_t,
        strides, *w, *scratch, b, num_heads, d, float(sm_scale), float(sm_scale * LOG2E),
        float(eps), stream)
    _kernels.check(rc, what)
    joint_attention_bwd.launches += 1
    return tuple(outs)


joint_attention_bwd.launches = joint_attention_bwd.generic_launches = 0


def mha_rms_bwd(q, k, v, do, lse, di, *, num_heads, rms_weights=None, eps=1e-6,
                sm_scale=None):
    """(dyq, dyk, dv): the single-stream backward kernel on CUDA tensors, its
    plain twin on CPU tensors."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    what = "mha_rms_bwd"
    route, d = route_of(what, q, num_heads, mode="single", rms=rms_weights is not None,
                        direction="bwd")
    pairs = None if rms_weights is None else [tuple(rms_weights)]
    if route == "plain":
        return attention_bwd_reference([q], [k], [v], [do], [lse], [di],
                                       num_heads=num_heads, rms_weights=pairs, eps=eps,
                                       sm_scale=sm_scale)[0]
    b, hd = _geometry(what, q)
    dev = q.device
    s = _check_stream(what, (q, k, v, do), b, hd, dev, q.dtype)
    check_stats(what, (lse, di), b, num_heads, s, dev)
    w = _check_weights(what, rms_weights, 2, d, dev)
    if route == "generic":
        (out,) = _generic_bwd([q], [k], [v], [do], [lse], [di], pairs, num_heads, d, eps,
                              sm_scale)
        mha_rms_bwd.generic_launches += 1
        return out
    outs = [torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev) for _ in range(3)]
    stream = _kernels.stream_ptr(dev)
    scratch = _bwd_scratch_ptrs(b, (s,), hd, rms_weights is not None, dev, stream)
    rc = _kernels.lib().mha_rms_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), *(o.data_ptr() for o in outs), s, _strides(q, k, v, do), *w, *scratch,
        b, num_heads, float(sm_scale), float(sm_scale * LOG2E), float(eps), stream)
    _kernels.check(rc, what)
    mha_rms_bwd.launches += 1
    return tuple(outs)


mha_rms_bwd.launches = mha_rms_bwd.generic_launches = 0


# ─────────────────────────── autograd ───────────────────────────


def _rms_grads(ctx, first, pairs, num_heads, eps):
    """dx (and dw where ``ctx.needs_input_grad`` asks) for each (x, w, dy) of
    ``pairs``; the w's are inputs ``first``, ``first + 1``, ... of the
    Function. Without weights, dy is dx."""
    dxs, dws = [], []
    for i, (x, w, dy) in enumerate(pairs):
        if w is None:
            dxs.append(dy)
            continue
        dx, dw = rms_bwd_closed(x, w, dy, num_heads, eps)
        dxs.append(dx)
        dws.append(dw if ctx.needs_input_grad[first + i] else None)
    return dxs, dws


class _JointMHA(torch.autograd.Function):
    """The JAX ``_joint_mha_p`` custom VJP. Inputs: num_heads, eps, sm_scale,
    the six (B, S, H*D) streams, then the four RMS weights if any."""

    @staticmethod
    def forward(ctx, num_heads, eps, sm_scale, q_i, k_i, v_i, q_t, k_t, v_t, *weights):
        o_i, o_t, lse_i, lse_t = joint_attention_fwd(q_i, k_i, v_i, q_t, k_t, v_t,
                                                weights or None, num_heads, eps, sm_scale,
                                                want_lse=True)
        ctx.save_for_backward(q_i, k_i, v_i, q_t, k_t, v_t, o_i, o_t, lse_i, lse_t,
                              *weights)
        ctx.args = (num_heads, eps, sm_scale)
        return o_i, o_t

    @staticmethod
    def backward(ctx, do_i, do_t):
        num_heads, eps, sm_scale = ctx.args
        q_i, k_i, v_i, q_t, k_t, v_t, o_i, o_t, lse_i, lse_t, *w = ctx.saved_tensors
        do_i, do_t = do_i.contiguous(), do_t.contiguous()
        dyq_i, dyk_i, dv_i, dyq_t, dyk_t, dv_t = joint_attention_bwd(
            q_i, k_i, v_i, q_t, k_t, v_t, do_i, do_t, lse_i, lse_t,
            bwd_row_stats(o_i, do_i, num_heads), bwd_row_stats(o_t, do_t, num_heads),
            num_heads=num_heads, rms_weights=w or None, eps=eps, sm_scale=sm_scale)
        wq_i, wk_i, wq_t, wk_t = w or (None,) * 4
        (dq_i, dk_i, dq_t, dk_t), dws = _rms_grads(
            ctx, 9, [(q_i, wq_i, dyq_i), (k_i, wk_i, dyk_i), (q_t, wq_t, dyq_t),
                     (k_t, wk_t, dyk_t)], num_heads, eps)
        return (None, None, None, dq_i, dk_i, dv_i, dq_t, dk_t, dv_t, *dws)


class _MhaRms(torch.autograd.Function):
    """The JAX ``_mha_rms_p`` custom VJP. Inputs: num_heads, eps, sm_scale, q,
    k, v, then the two RMS weights if any."""

    @staticmethod
    def forward(ctx, num_heads, eps, sm_scale, q, k, v, *weights):
        o, lse = mha_rms_fwd(q, k, v, weights or None, num_heads, eps, sm_scale,
                                 want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, *weights)
        ctx.args = (num_heads, eps, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        num_heads, eps, sm_scale = ctx.args
        q, k, v, o, lse, *w = ctx.saved_tensors
        do = do.contiguous()
        dyq, dyk, dv = mha_rms_bwd(q, k, v, do, lse, bwd_row_stats(o, do, num_heads),
                                   num_heads=num_heads, rms_weights=w or None, eps=eps,
                                   sm_scale=sm_scale)
        wq, wk = w or (None, None)
        (dq, dk), dws = _rms_grads(ctx, 6, [(q, wq, dyq), (k, wk, dyk)], num_heads, eps)
        return (None, None, None, dq, dk, dv, *dws)


def _needs_grad(tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def joint_mha(q_img, k_img, v_img, q_txt, k_txt, v_txt, *, num_heads,
              rms_weights=None, eps: float = 1e-6, sm_scale=None):
    """Two-stream joint attention -> (o_img, o_txt), streams never concatenated.

    Inputs are (B, S_img, H*D) and (B, S_txt, H*D); ``rms_weights`` is None or
    (wq_img, wk_img, wq_txt, wk_txt), each (D,) — SD3.5's norm_q / norm_k /
    norm_added_q / norm_added_k. Differentiable in all of them.
    """
    if sm_scale is None:
        sm_scale = (q_img.shape[-1] // num_heads) ** -0.5
    streams = (q_img, k_img, v_img, q_txt, k_txt, v_txt)
    weights = tuple(rms_weights or ())
    if _needs_grad(streams + weights):
        return _JointMHA.apply(num_heads, eps, sm_scale, *streams, *weights)
    return joint_attention_fwd(*streams, rms_weights, num_heads, eps, sm_scale,
                          want_lse=False)[:2]


joint_mha.launches = joint_mha.generic_launches = 0


def mha_rms(q, k, v, *, num_heads, rms_weights=None, eps: float = 1e-6,
            sm_scale=None):
    """Single-stream (B, S, H*D) attention with fused per-head qk-RMS — SD3.5's
    dual self-attention. ``rms_weights``: None or (wq, wk), each (D,)."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    weights = tuple(rms_weights or ())
    if _needs_grad((q, k, v) + weights):
        return _MhaRms.apply(num_heads, eps, sm_scale, q, k, v, *weights)
    return mha_rms_fwd(q, k, v, rms_weights, num_heads, eps, sm_scale,
                           want_lse=False)[0]


mha_rms.launches = mha_rms.generic_launches = 0
