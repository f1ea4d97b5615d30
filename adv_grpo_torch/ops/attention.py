"""Multi-head attention in the (B, S, H*D) projection layout, its plain
version, and the row statistics the fused attention backwards share.

Port of adv_grpo_tpu/ops/attention.py: ``attention_reference`` (with the
``kv_len`` key mask), ``mha_bshd`` (Flux's single-block attention) and
``bwd_row_stats``. On CUDA tensors ``mha_bshd`` launches the kernel in
``csrc/joint_attention.cu`` (``mha_bshd_fwd_bf16``), which reads q/k/v in place
through their strides; on CPU tensors it runs the plain version, which
follows the JAX ``backend="reference"`` path: fp32 scores, masked keys set to
the JAX package's finite mask value, fp32 softmax, cast back to q's dtype.

The TPU layout's lane broadcast of the statistics (``LSE_LANES``) and its
zero padding of S to a block multiple have no counterpart here: the
statistics stay (B, H, S), and the kernel masks ragged rows itself.
"""

from __future__ import annotations

import ctypes

import torch

from adv_grpo_torch.kernels import build as _kernels

# the JAX package's mask value (-0.7 * f32 max): finite, so a row never sees
# exp(-inf - -inf)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634  # the kernels' softmax runs in base 2
HEAD_DIMS = (64, 128)  # the head widths the forward kernels are built for


def attention_reference(q, k, v, *, sm_scale, kv_len=None, return_lse=False):
    """Plain (B, H, S, D) softmax attention in fp32, cast back to q's dtype;
    keys at or past ``kv_len`` are masked. With ``return_lse`` also the
    natural-log lse of each row, fp32 (B, H, S)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_len is not None and kv_len < k.shape[2]:
        mask = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def to_bhsd(a, num_heads):
    b, s, hd = a.shape
    return a.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def from_bhsd(o):
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def mha_bshd_reference(q, k, v, *, num_heads, sm_scale=None, kv_len=None,
                       return_lse=False):
    """Plain multi-head attention of (B, S, H*D) tensors; with ``return_lse``
    -> (o, lse (B, H, S_q))."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    o, lse = attention_reference(to_bhsd(q, num_heads), to_bhsd(k, num_heads),
                                 to_bhsd(v, num_heads), sm_scale=sm_scale, kv_len=kv_len,
                                 return_lse=True)
    return (from_bhsd(o), lse) if return_lse else from_bhsd(o)


def bwd_row_stats(o, do, num_heads):
    """di = sum_d o * do per (batch, head, row), fp32 (B, H, S), from o as the
    forward stored it (bf16 on the card) — the JAX ``bwd_row_stats``."""
    b, s, hd = o.shape
    di = (o.float() * do.float()).reshape(b, s, num_heads, hd // num_heads).sum(-1)
    return di.transpose(1, 2).contiguous()


# ─────────────────────────── kernel wrapper ───────────────────────────


def check_rows(what, tensors, device):
    """Validate bf16 (B, S, H*D) tensors that a kernel reads in place through
    their (batch, row) strides as 16-byte vectors."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: all inputs must be on {device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bf16 q/k/v, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{what}: expected (B, S, H*D), got {tuple(t.shape)}")
        # a head's columns must be contiguous and 16-byte aligned
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{what}: the last dim must be contiguous, with batch/row "
                             "strides that are multiples of 8 and a 16-byte aligned base")


def head_dim_of(what, width, num_heads, dims=HEAD_DIMS):
    """The head width of a (.., H*D) tensor; raises unless it is in ``dims``."""
    if num_heads < 1 or width % num_heads or width // num_heads not in dims:
        raise ValueError(f"{what}: the kernel takes heads of {' or '.join(map(str, dims))}; "
                         f"got width {width} for {num_heads} heads")
    return width // num_heads


def int64_array(vals):
    return (ctypes.c_longlong * len(vals))(*vals)


def mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse):
    """(o, lse): the kernel on CUDA tensors, the plain version on CPU
    tensors; lse is fp32 (B, H, S_q), or None unless ``want_lse``."""
    if q.device.type == "cpu":
        out = mha_bshd_reference(q, k, v, num_heads=num_heads, sm_scale=sm_scale,
                                 kv_len=kv_len, return_lse=want_lse)
        return out if want_lse else (out, None)
    what = "mha_bshd"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    check_rows(what, (q, k, v), q.device)
    b, sq, hd = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    d = head_dim_of(what, hd, num_heads)
    kv = skv if kv_len is None else min(int(kv_len), skv)
    if sq < 1 or kv < 1:
        raise ValueError(f"{what}: needs at least one query and one key (S_q={sq}, "
                         f"kv_len={kv})")
    o = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = int64_array([st for t in (q, k, v) for st in (t.stride(0), t.stride(1), d)]
                          + [o.stride(0), o.stride(1), d])
    rc = _kernels.lib().mha_bshd_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), sq, kv, strides, b, num_heads, d,
        float(sm_scale * LOG2E), _kernels.stream_ptr(q.device))
    _kernels.check(rc, what)
    mha_bshd.launches += 1
    return o, lse


def mha_bshd(q, k, v, *, num_heads, sm_scale=None, kv_len=None):
    """Bidirectional multi-head attention on (B, S, H*D) tensors, read in
    place (no transposes); keys at or past ``kv_len`` are masked.

    CPU tensors take the plain path (differentiable by autograd). CUDA
    tensors launch the forward kernel (bf16, head width 64 or 128) or raise;
    its backward (the TPU's ``_bshd_bwd``) is not ported yet, so a CUDA call
    that needs a gradient raises too.
    """
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if (q.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError("mha_bshd: the backward kernel (adv_grpo_tpu/ops/"
                                  "attention.py _bshd_bwd) is not yet ported")
    return mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse=False)[0]


mha_bshd.launches = 0
