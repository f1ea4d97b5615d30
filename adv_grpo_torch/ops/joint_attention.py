"""Joint two-stream attention with fused qk-RMS, and its single-stream variant.

Port of adv_grpo_tpu/ops/joint_attention.py (forward only). MMDiT's joint
attention is per-head RMS on q/k of each stream, concat [image ; text], full
bidirectional attention, split (the diffusers JointAttnProcessor contract);
``mha_rms`` is the single-stream form used by SD3.5's dual self-attention.

On CUDA tensors both launch the kernel in ``csrc/joint_attention.cu``, which
walks the two streams as separate kv tiles of one online softmax, straight
from the (B, S, H*64) projection layout. On CPU tensors they run the plain
versions, which follow the JAX ``backend="reference"`` path op for op: RMS
(cast back to the input dtype), concat, fp32 softmax, split.
"""

from __future__ import annotations

import ctypes

import torch

from adv_grpo_torch.kernels import build as _kernels
from adv_grpo_torch.ops.fused_norms import rms_reference

_LOG2E = 1.4426950408889634  # the kernel's softmax runs in base 2
_HEAD_DIM = 64  # the one head width the kernel is built for (SD3.5)


def attention_reference(q, k, v, *, sm_scale):
    """Plain (B, H, S, D) softmax attention in fp32, cast back to q's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _to4(a, num_heads):
    b, s, hd = a.shape
    return a.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def _from4(o):
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def joint_mha_reference(q_img, k_img, v_img, q_txt, k_txt, v_txt, *, num_heads,
                        rms_weights=None, eps=1e-6, sm_scale=None):
    """Plain two-stream joint attention -> (o_img, o_txt)."""
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
    o = _from4(attention_reference(q, k, v, sm_scale=sm_scale))
    return o[:, :s_i], o[:, s_i:]


def mha_rms_reference(q, k, v, *, num_heads, rms_weights=None, eps=1e-6,
                      sm_scale=None):
    """Plain single-stream (B, S, H*D) attention with per-head qk-RMS."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if rms_weights is not None:
        wq, wk = rms_weights
        q = rms_reference(q, wq, num_heads, eps, q.dtype)
        k = rms_reference(k, wk, num_heads, eps, k.dtype)
    o = attention_reference(_to4(q, num_heads), _to4(k, num_heads),
                            _to4(v, num_heads), sm_scale=sm_scale)
    return _from4(o)


def _check_stream(what, tensors, batch, hd, device):
    """Validate one stream's q/k/v for the kernel; return its length."""
    length = tensors[0].shape[1]
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: all inputs must be on {device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bf16 q/k/v, got {t.dtype}")
        if t.ndim != 3 or t.shape != (batch, length, hd):
            raise ValueError(f"{what}: expected {(batch, length, hd)}, got {tuple(t.shape)}")
        # read in place through (batch, row) strides as 16-byte vectors: a
        # head's 64 columns must be contiguous and 16-byte aligned
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{what}: the last dim must be contiguous, with batch/row "
                             "strides that are multiples of 8 and a 16-byte aligned base")
    return length


def _check_weights(what, weights, n, device):
    """Validate the RMS weights; return their n device pointers (None if absent)."""
    if weights is None:
        return [None] * n
    if len(weights) != n:
        raise ValueError(f"{what}: expected {n} RMS weights, got {len(weights)}")
    for w in weights:
        if (w.device != device or w.dtype != torch.float32 or w.shape != (_HEAD_DIM,)
                or not w.is_contiguous()):
            raise ValueError(f"{what}: RMS weights must be contiguous fp32 ({_HEAD_DIM},) "
                             f"on {device}")
    return [w.data_ptr() for w in weights]


def _strides(*tensors):
    vals = [st for t in tensors for st in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _geometry(what, q, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, s, hd = q.shape
    if hd != num_heads * _HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes heads of {_HEAD_DIM}; got width "
                         f"{hd} for {num_heads} heads")
    if s < 1:
        raise ValueError(f"{what}: empty image stream")
    return b, hd


def joint_mha(q_img, k_img, v_img, q_txt, k_txt, v_txt, *, num_heads,
              rms_weights=None, eps: float = 1e-6, sm_scale=None):
    """Two-stream joint attention -> (o_img, o_txt), streams never concatenated.

    Inputs are (B, S_img, H*D) and (B, S_txt, H*D); ``rms_weights`` is None or
    (wq_img, wk_img, wq_txt, wk_txt), each (D,) — SD3.5's norm_q / norm_k /
    norm_added_q / norm_added_k.
    """
    if q_img.device.type == "cpu":
        return joint_mha_reference(q_img, k_img, v_img, q_txt, k_txt, v_txt,
                                   num_heads=num_heads, rms_weights=rms_weights,
                                   eps=eps, sm_scale=sm_scale)
    b, hd = _geometry("joint_mha", q_img, num_heads)
    dev = q_img.device
    s_i = _check_stream("joint_mha", (q_img, k_img, v_img), b, hd, dev)
    s_t = _check_stream("joint_mha", (q_txt, k_txt, v_txt), b, hd, dev)
    w = _check_weights("joint_mha", rms_weights, 4, dev)
    if sm_scale is None:
        sm_scale = _HEAD_DIM ** -0.5
    o_img = torch.empty((b, s_i, hd), dtype=torch.bfloat16, device=dev)
    o_txt = torch.empty((b, s_t, hd), dtype=torch.bfloat16, device=dev)
    strides = _strides(q_img, k_img, v_img, o_img, q_txt, k_txt, v_txt, o_txt)
    rc = _kernels.lib().joint_attention_fwd_bf16(
        q_img.data_ptr(), k_img.data_ptr(), v_img.data_ptr(), o_img.data_ptr(), s_i,
        q_txt.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(), o_txt.data_ptr(), s_t,
        strides, *w, b, num_heads, float(sm_scale * _LOG2E), float(eps),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "joint_mha")
    joint_mha.launches += 1
    return o_img, o_txt


joint_mha.launches = 0


def mha_rms(q, k, v, *, num_heads, rms_weights=None, eps: float = 1e-6,
            sm_scale=None):
    """Single-stream (B, S, H*D) attention with fused per-head qk-RMS — SD3.5's
    dual self-attention. ``rms_weights``: None or (wq, wk), each (D,)."""
    if q.device.type == "cpu":
        return mha_rms_reference(q, k, v, num_heads=num_heads,
                                 rms_weights=rms_weights, eps=eps, sm_scale=sm_scale)
    b, hd = _geometry("mha_rms", q, num_heads)
    dev = q.device
    s = _check_stream("mha_rms", (q, k, v), b, hd, dev)
    w = _check_weights("mha_rms", rms_weights, 2, dev)
    if sm_scale is None:
        sm_scale = _HEAD_DIM ** -0.5
    o = torch.empty((b, s, hd), dtype=torch.bfloat16, device=dev)
    rc = _kernels.lib().mha_rms_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), s,
        _strides(q, k, v, o), *w, b, num_heads, float(sm_scale * _LOG2E), float(eps),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "mha_rms")
    mha_rms.launches += 1
    return o


mha_rms.launches = 0
