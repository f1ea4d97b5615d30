"""Joint two-stream attention with fused qk-RMS, and its single-stream variant.

Port of adv_grpo_tpu/ops/joint_attention.py. MMDiT's joint attention is
per-head RMS on q/k of each stream, concat [image ; text], full bidirectional
attention, split (the diffusers JointAttnProcessor contract); ``mha_rms`` is
the single-stream form used by SD3.5's dual self-attention.

Forward: on CUDA tensors both launch the kernel in ``csrc/joint_attention.cu``,
which walks the two streams as separate kv tiles of one online softmax,
straight from the (B, S, H*D) projection layout (D = 64, SD3.5, with the
qk-RMS fused; or D = 128, Flux, whose qk-norm and RoPE come before), and
writes the per-row log-sum-exp when a backward will need it. On CPU tensors they run the plain
versions, which follow the JAX ``backend="reference"`` path op for op: RMS
(cast back to the input dtype), concat, fp32 softmax, split.

Backward (``torch.autograd.Function``s mirroring the JAX ``_joint_mha_p`` /
``_mha_rms_p`` custom VJPs): di = sum o * do per row (:func:`bwd_row_stats`),
then the backward kernel in ``csrc/joint_attention_bwd.cu`` (CUDA) or its plain
twin (CPU) — both in the TPU kernel's op order — gives the cotangents of the
NORMALISED q and k and of v, and the closed-form RMS backward turns those into
dq, dk and the RMS-weight gradients. The joint backward takes D = 64 (with or
without RMS) and D = 128 (without RMS, Flux's double blocks); the
single-stream RMS backward takes D = 64; other widths raise.
"""

from __future__ import annotations

import torch

from adv_grpo_torch.kernels import build as _kernels
from adv_grpo_torch.ops.attention import (
    HEAD_DIMS, LOG2E, attention_bwd_reference, attention_reference, bwd_row_stats, check_rows,
    check_stats, head_dim_of, int64_array)
from adv_grpo_torch.ops.attention import from_bhsd as _from4
from adv_grpo_torch.ops.attention import to_bhsd as _to4
from adv_grpo_torch.ops.fused_norms import rms_bwd_closed, rms_reference

# the joint backward's head widths: 64 (SD3.5-M, qk-RMS fused) and 128
# (Flux.1-dev, no RMS: its qk-norm and RoPE come before); the single-stream
# RMS backward takes 64 only
_BWD_HEAD_DIMS = (64, 128)
_RMS_BWD_HEAD_DIMS = (64,)


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


# ─────────────────────────── kernel wrappers ───────────────────────────


def _check_stream(what, tensors, batch, hd, device):
    """Validate one stream's (B, S, H*D) tensors for a kernel; return S."""
    check_rows(what, tensors, device)
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


def _geometry(what, q, num_heads, dims=HEAD_DIMS):
    """(batch, width, head width) of a kernel call; raises on a device, a
    head width or an empty stream the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, s, hd = q.shape
    d = head_dim_of(what, hd, num_heads, dims)
    if s < 1:
        raise ValueError(f"{what}: empty image stream")
    return b, hd, d


def _lse_out(b, num_heads, s, dev, want):
    return torch.empty((b, num_heads, s), dtype=torch.float32, device=dev) if want else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def joint_attention_fwd(q_img, k_img, v_img, q_txt, k_txt, v_txt, rms_weights, num_heads,
                   eps, sm_scale, want_lse):
    """(o_img, o_txt, lse_img, lse_txt): the kernel on CUDA, the plain version
    on the CPU; the lse are None unless ``want_lse``."""
    if q_img.device.type == "cpu":
        out = joint_mha_reference(q_img, k_img, v_img, q_txt, k_txt, v_txt,
                                  num_heads=num_heads, rms_weights=rms_weights, eps=eps,
                                  sm_scale=sm_scale, return_lse=want_lse)
        return out if want_lse else (*out, None, None)
    b, hd, d = _geometry("joint_mha", q_img, num_heads)
    dev = q_img.device
    s_i = _check_stream("joint_mha", (q_img, k_img, v_img), b, hd, dev)
    s_t = _check_stream("joint_mha", (q_txt, k_txt, v_txt), b, hd, dev)
    w = _check_weights("joint_mha", rms_weights, 4, d, dev)
    o_img = torch.empty((b, s_i, hd), dtype=torch.bfloat16, device=dev)
    o_txt = torch.empty((b, s_t, hd), dtype=torch.bfloat16, device=dev)
    lse_img = _lse_out(b, num_heads, s_i, dev, want_lse)
    lse_txt = _lse_out(b, num_heads, s_t, dev, want_lse)
    strides = _strides(q_img, k_img, v_img, o_img, q_txt, k_txt, v_txt, o_txt)
    rc = _kernels.lib().joint_attention_fwd_bf16(
        q_img.data_ptr(), k_img.data_ptr(), v_img.data_ptr(), o_img.data_ptr(),
        _ptr(lse_img), s_i, q_txt.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(),
        o_txt.data_ptr(), _ptr(lse_txt), s_t, strides, *w, b, num_heads, d,
        float(sm_scale * LOG2E), float(eps), _kernels.stream_ptr(dev))
    _kernels.check(rc, "joint_mha")
    joint_mha.launches += 1
    return o_img, o_txt, lse_img, lse_txt


def mha_rms_fwd(q, k, v, rms_weights, num_heads, eps, sm_scale, want_lse):
    """(o, lse): the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        out = mha_rms_reference(q, k, v, num_heads=num_heads, rms_weights=rms_weights,
                                eps=eps, sm_scale=sm_scale, return_lse=want_lse)
        return out if want_lse else (out, None)
    b, hd, d = _geometry("mha_rms", q, num_heads)
    dev = q.device
    s = _check_stream("mha_rms", (q, k, v), b, hd, dev)
    w = _check_weights("mha_rms", rms_weights, 2, d, dev)
    o = torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev)
    lse = _lse_out(b, num_heads, s, dev, want_lse)
    rc = _kernels.lib().mha_rms_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), s,
        _strides(q, k, v, o), *w, b, num_heads, d, float(sm_scale * LOG2E), float(eps),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "mha_rms")
    mha_rms.launches += 1
    return o, lse


def joint_attention_bwd(q_img, k_img, v_img, q_txt, k_txt, v_txt, do_img, do_txt,
                        lse_img, lse_txt, di_img, di_txt, *, num_heads, rms_weights=None,
                        eps=1e-6, sm_scale=None):
    """(dyq_img, dyk_img, dv_img, dyq_txt, dyk_txt, dv_txt): the joint backward
    kernel on CUDA tensors, its plain twin :func:`attention_bwd_reference` on
    CPU tensors. lse/di: fp32 (B, H, S) per stream."""
    if sm_scale is None:
        sm_scale = (q_img.shape[-1] // num_heads) ** -0.5
    if q_img.device.type == "cpu":
        w = rms_weights
        pairs = None if w is None else [(w[0], w[1]), (w[2], w[3])]
        img, txt = attention_bwd_reference(
            [q_img, q_txt], [k_img, k_txt], [v_img, v_txt], [do_img, do_txt],
            [lse_img, lse_txt], [di_img, di_txt], num_heads=num_heads,
            rms_weights=pairs, eps=eps, sm_scale=sm_scale)
        return (*img, *txt)
    what = "joint_attention_bwd"
    b, hd, d = _geometry(what, q_img, num_heads, _BWD_HEAD_DIMS)
    if d != 64 and rms_weights is not None:
        raise ValueError(f"{what}: the fused qk-RMS backward takes head width 64, got {d}")
    dev = q_img.device
    s_i = _check_stream(what, (q_img, k_img, v_img, do_img), b, hd, dev)
    s_t = _check_stream(what, (q_txt, k_txt, v_txt, do_txt), b, hd, dev)
    check_stats(what, (lse_img, di_img), b, num_heads, s_i, dev)
    check_stats(what, (lse_txt, di_txt), b, num_heads, s_t, dev)
    w = _check_weights(what, rms_weights, 4, d, dev)
    outs = [torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev)
            for s in (s_i, s_i, s_i, s_t, s_t, s_t)]
    strides = _strides(q_img, k_img, v_img, do_img, q_txt, k_txt, v_txt, do_txt)
    rc = _kernels.lib().joint_attention_bwd_bf16(
        q_img.data_ptr(), k_img.data_ptr(), v_img.data_ptr(), do_img.data_ptr(),
        lse_img.data_ptr(), di_img.data_ptr(), *(o.data_ptr() for o in outs[:3]), s_i,
        q_txt.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(), do_txt.data_ptr(),
        lse_txt.data_ptr(), di_txt.data_ptr(), *(o.data_ptr() for o in outs[3:]), s_t,
        strides, *w, b, num_heads, d, float(sm_scale), float(eps), _kernels.stream_ptr(dev))
    _kernels.check(rc, what)
    joint_attention_bwd.launches += 1
    return tuple(outs)


joint_attention_bwd.launches = 0


def mha_rms_bwd(q, k, v, do, lse, di, *, num_heads, rms_weights=None, eps=1e-6,
                sm_scale=None):
    """(dyq, dyk, dv): the single-stream backward kernel on CUDA tensors, its
    plain twin on CPU tensors."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if q.device.type == "cpu":
        pairs = None if rms_weights is None else [tuple(rms_weights)]
        return attention_bwd_reference([q], [k], [v], [do], [lse], [di],
                                       num_heads=num_heads, rms_weights=pairs, eps=eps,
                                       sm_scale=sm_scale)[0]
    what = "mha_rms_bwd"
    b, hd, d = _geometry(what, q, num_heads, _RMS_BWD_HEAD_DIMS)
    dev = q.device
    s = _check_stream(what, (q, k, v, do), b, hd, dev)
    check_stats(what, (lse, di), b, num_heads, s, dev)
    w = _check_weights(what, rms_weights, 2, d, dev)
    outs = [torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev) for _ in range(3)]
    rc = _kernels.lib().mha_rms_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), *(o.data_ptr() for o in outs), s, _strides(q, k, v, do), *w, b,
        num_heads, float(sm_scale), float(eps), _kernels.stream_ptr(dev))
    _kernels.check(rc, what)
    mha_rms_bwd.launches += 1
    return tuple(outs)


mha_rms_bwd.launches = 0


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


joint_mha.launches = 0


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


mha_rms.launches = 0
