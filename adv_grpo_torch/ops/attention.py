"""Multi-head attention in the (B, S, H*D) projection layout and in the
(B, H, S, D) layout, their plain versions and backwards, and the row
statistics and kernel-wrapper checks the fused attentions share.

Port of adv_grpo_tpu/ops/attention.py: ``attention_reference`` (with the
``kv_len`` key mask), ``mha_bshd`` (Flux's single-block and WAN's attention)
with its custom VJP (``_flash_mha_bshd``), ``mha`` (the (B, H, S, D) flash
attention that context-parallel attention runs) with its custom VJP
(``_flash_mha``), and ``bwd_row_stats``.

On CUDA tensors ``mha_bshd`` launches ``mha_bshd_fwd_bf16`` (kernel #8), the
wgmma + TMA forward of ``csrc/attention_fwd_sm90.cu``, which reads q/k/v in
place through their strides and, when a gradient is needed, writes the
per-row lse; the backward (``_MhaBshd``) computes di with
:func:`bwd_row_stats` and launches ``mha_bshd_bwd_bf16`` (kernel #9), the
wgmma + TMA kernel of ``csrc/attention_bwd_sm90.cu``. ``mha`` launches the
same forward kernel with BHSD strides (``mha_fwd_bf16``, kernel #10) and, in
its backward (``_FlashMha``), the same backward kernel as ``mha_bwd_bf16``
(kernel #11), whose p and ds stay at fp32 accuracy as in the TPU's
``_bwd_dkv_kernel`` / ``_bwd_dq_kernel``. On CPU tensors the forwards run
the plain version, which follows the JAX ``backend="reference"`` path (fp32
scores, masked keys set to the JAX package's finite mask value, fp32
softmax, cast back to q's dtype), and the backwards the kernels' plain twins
:func:`bshd_bwd_reference` and :func:`flash_bwd_reference`.

Which kernel a CUDA call takes is one pure function,
:func:`attention_route`, of (dtype, head width, fused RMS, mode,
direction): bf16 at head width 64 or 128 takes the wgmma + TMA kernels
above ("sm90"); fp32 at any width up to 128, bf16 at the other widths up
to 128, and the fused-RMS single-stream / joint backward at 128 take the
generic kernels of ``csrc/attention_generic_{fwd,bwd}.cu`` ("generic",
:func:`generic_attention`; fp32 on the tensor cores in a 3xTF32 split,
bf16 on FFMA, chosen by dtype in the kernels), each route with its own counter
(``launches``, ``generic_launches``). Only a head wider than 128, or one
that is not a whole number of 16-byte vectors, raises, as does a device
other than the card or the CPU.

The TPU layout's lane broadcast of the statistics (``LSE_LANES``) and its
zero padding of S to a block multiple have no counterpart here: the
statistics stay (B, H, S), and the kernels mask ragged rows themselves.
"""

from __future__ import annotations

import ctypes

import torch

from adv_grpo_torch.kernels import build as _kernels

# the JAX package's mask value (-0.7 * f32 max): finite, so a row never sees
# exp(-inf - -inf)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634  # the kernels' softmax runs in base 2
HEAD_DIMS = (64, 128)  # the head widths of the wgmma + TMA kernels (bf16)
GENERIC_MAX_HEAD_DIM = 128  # the widest head of the generic kernels
# the generic kernels' modes (csrc/attention_generic.cuh Mode); "single" is
# kJoint with one stream
GENERIC_MODES = {"joint": 0, "single": 0, "bshd": 1, "bhsd": 2}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


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


# ─────────────────────────── routing ───────────────────────────


def attention_route(device, dtype, d, *, mode, rms=False, direction="fwd", what="attention"):
    """The kernel an attention call takes: "plain" on the CPU (the plain
    versions, any geometry); on the card "sm90" (the wgmma + TMA kernels) or
    "generic" (csrc/attention_generic_{fwd,bwd}.cu).

    ``mode``: "joint", "single" (``mha_rms``), "bshd" or "bhsd"; ``rms``:
    the fused qk-RMS weights are given; ``direction``: "fwd" or "bwd". bf16
    at head width 64 or 128 takes "sm90", but for the single-stream backward
    and the joint backward with the fused RMS at 128, which the wgmma
    backward does not build; everything else within the limits takes
    "generic". Raises on a device other than the card or the CPU, a dtype
    other than fp32 or bf16, and a head width ``d`` over
    GENERIC_MAX_HEAD_DIM or not a whole number of 16-byte vectors."""
    if mode not in GENERIC_MODES or direction not in ("fwd", "bwd"):
        raise ValueError(f"{what}: unknown mode {mode!r} or direction {direction!r}")
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    if dtype not in _ELEMENT_BYTES:
        raise TypeError(f"{what}: the kernels take fp32 or bf16, got {dtype}")
    vec = 16 // _ELEMENT_BYTES[dtype]
    if not 1 <= d <= GENERIC_MAX_HEAD_DIM or d % vec:
        raise ValueError(f"{what}: the kernels take head widths up to "
                         f"{GENERIC_MAX_HEAD_DIM} that are whole 16-byte vectors (multiples "
                         f"of {vec} in {dtype}); got {d}")
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        wgmma_bwd = d == 64 or mode in ("bshd", "bhsd") or (mode == "joint" and not rms)
        return "sm90" if direction == "fwd" or wgmma_bwd else "generic"
    return "generic"


def route_of(what, x, num_heads, **kw):
    """(route, head width) of a call on the (.., H*D) tensor ``x``
    (:func:`attention_route`); the width is checked to split into
    ``num_heads`` heads first, on the card (None on the CPU)."""
    if x.device.type == "cpu":
        return attention_route(x.device, x.dtype, 0, what=what, **kw), None
    d = head_dim_of(what, x.shape[-1], num_heads)
    return attention_route(x.device, x.dtype, d, what=what, **kw), d


# ─────────────────────────── kernel wrapper ───────────────────────────


def check_rows(what, tensors, device, dtype):
    """Validate ``dtype`` (fp32 or bf16) (B, S, H*D) tensors that a kernel
    reads in place through their (batch, row) strides as 16-byte vectors."""
    vec = 16 // _ELEMENT_BYTES[dtype]
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: all inputs must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: the kernel takes {dtype} q/k/v here, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{what}: expected (B, S, H*D), got {tuple(t.shape)}")
        # a head's columns must be contiguous and 16-byte aligned
        if t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"{what}: the last dim must be contiguous, with batch/row "
                             f"strides that are multiples of {vec} and a 16-byte aligned "
                             "base")


def check_stats(what, stats, batch, num_heads, length, device):
    """Validate fp32 contiguous (B, H, S) row statistics (lse, di)."""
    for t in stats:
        if (t.device != device or t.dtype != torch.float32
                or t.shape != (batch, num_heads, length) or not t.is_contiguous()):
            raise ValueError(f"{what}: row statistics must be contiguous fp32 "
                             f"{(batch, num_heads, length)} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def head_dim_of(what, width, num_heads):
    """The head width of a (.., H*D) tensor; raises unless ``num_heads``
    heads split it."""
    if num_heads < 1 or width % num_heads:
        raise ValueError(f"{what}: width {width} does not split into {num_heads} heads")
    return width // num_heads


def int64_array(vals):
    return (ctypes.c_longlong * len(vals))(*vals)


# the generic kernels' per-stream descriptor (csrc/attention_generic.cuh
# Desc): lengths, then (pointer, batch, row and head strides) per tensor,
# then pointers
_DESC_LEN = 42
_DESC_INTS = {"q_rows": 0, "kv_rows": 1, "kv_valid": 2}
_DESC_VIEWS = {"q": 3, "k": 7, "v": 11, "o": 15, "do": 19, "dq": 23, "dk": 27, "dv": 31}
_DESC_PTRS = {"lse": 35, "di": 36, "wq": 37, "wk": 38, "qhat": 39, "qs": 40, "khat": 41}


def _generic_view(t, mode, d):
    """(pointer, batch, row, head strides) of a (B, S, H*D) tensor, or of a
    (B, H, S, D) one in mode "bhsd"."""
    if mode == "bhsd":
        return (t.data_ptr(), t.stride(0), t.stride(2), t.stride(1))
    return (t.data_ptr(), t.stride(0), t.stride(1), d)


def generic_attention(direction, mode, streams, *, batch, num_heads, d, sm_scale, eps=0.0):
    """Launch the generic forward or backward (``direction`` "fwd" / "bwd")
    on one or two streams. Each stream is a dict of the descriptor's slots:
    ``q_rows``, ``kv_rows``, ``kv_valid`` (ints); the tensors ``q``, ``k``,
    ``v`` and ``o`` (forward) or ``do``, ``dq``, ``dk``, ``dv`` (backward),
    written in place; ``lse`` (fp32 (B, H, q_rows)), ``di``, the RMS weights
    ``wq`` / ``wk`` and, in the joint modes, the operand scratches ``qhat``,
    ``qs`` (backward) and ``khat`` (with ``wk``), contiguous (B, S, H*D) of
    q's dtype; a slot left out is null. The wrapper has checked the tensors
    (dtype, strides, alignment)."""
    desc = [0] * (_DESC_LEN * len(streams))
    for i, st in enumerate(streams):
        base = i * _DESC_LEN
        for key, val in st.items():
            if val is None:
                continue
            if key in _DESC_INTS:
                desc[base + _DESC_INTS[key]] = int(val)
            elif key in _DESC_VIEWS:
                desc[base + _DESC_VIEWS[key]:base + _DESC_VIEWS[key] + 4] = _generic_view(
                    val, mode, d)
            else:
                desc[base + _DESC_PTRS[key]] = val.data_ptr()
    q = streams[0]["q"]
    dtype_code = 0 if q.dtype == torch.float32 else 1
    args = (int64_array(desc), len(streams), dtype_code, GENERIC_MODES[mode], batch, num_heads,
            d, float(sm_scale * LOG2E))
    lib, stream = _kernels.lib(), _kernels.stream_ptr(q.device)
    if direction == "fwd":
        rc = lib.attention_generic_fwd(*args, float(eps), stream)
    else:
        rc = lib.attention_generic_bwd(*args, float(sm_scale), float(eps), stream)
    _kernels.check(rc, f"attention_generic_{direction} ({mode})")


def _check_bshd(what, q, k, v, num_heads, kv_len):
    """Validate a (q, k, v) kernel call; return (batch, S_q, S_kv, head width,
    kv_len clamped to S_kv)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    check_rows(what, (q, k, v), q.device, q.dtype)
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
    return b, sq, skv, d, kv


def bwd_scratch(b, h, sq, skv, d, device):
    """The fp32 scratch the backward kernel (#9, #11) reduce-adds into, zeroed:
    dq's (B, H, S_q, D), and (q_splits, dk/dv's (2, B, H, S_kv, D) or None).

    The kernel runs one CTA per (128-row kv tile, head, batch item). Where
    those CTAs fill less than half the card's SMs and each walks many q
    tiles (WAN's cross-attention: 48 CTAs over 127 q tiles), q_splits CTAs
    share each kv tile's walk, each over at least 16 q tiles, and add their
    dk and dv into the second scratch."""
    ctas = b * h * -(-skv // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(sms // ctas, -(-sq // 64) // 16))
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=device)
    dkv_acc = (torch.zeros((2, b, h, skv, d), dtype=torch.float32, device=device)
               if splits > 1 else None)
    return dq_acc, splits, dkv_acc


def _bshd_strides(tensors, d):
    """The (batch, row, head) strides of (B, S, H*D) tensors, heads D apart."""
    return int64_array([st for t in tensors for st in (t.stride(0), t.stride(1), d)])


def mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse):
    """(o, lse): the kernel on CUDA tensors, the plain version on CPU
    tensors; lse is fp32 (B, H, S_q), or None unless ``want_lse``."""
    what = "mha_bshd"
    route, _ = route_of(what, q, num_heads, mode="bshd")
    if route == "plain":
        out = mha_bshd_reference(q, k, v, num_heads=num_heads, sm_scale=sm_scale,
                                 kv_len=kv_len, return_lse=want_lse)
        return out if want_lse else (out, None)
    b, sq, skv, d, kv = _check_bshd(what, q, k, v, num_heads, kv_len)
    if route == "generic":
        o = torch.empty((b, sq, q.shape[2]), dtype=q.dtype, device=q.device)
        lse = (torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
               if want_lse else None)
        generic_attention("fwd", "bshd", [dict(q_rows=sq, kv_rows=skv, kv_valid=kv, q=q, k=k,
                                               v=v, o=o, lse=lse)],
                          batch=b, num_heads=num_heads, d=d, sm_scale=sm_scale)
        mha_bshd.generic_launches += 1
        return o, lse
    o = torch.empty((b, sq, q.shape[2]), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    rc = _kernels.lib().mha_bshd_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), sq, kv, _bshd_strides((q, k, v, o), d), b,
        num_heads, d, float(sm_scale * LOG2E), _kernels.stream_ptr(q.device))
    _kernels.check(rc, what)
    mha_bshd.launches += 1
    mha_bshd.cross_launches += sq != skv
    return o, lse


def mha_bshd_bwd(q, k, v, do, lse, di, *, num_heads, sm_scale=None, kv_len=None):
    """(dq, dk, dv) of :func:`mha_bshd` from the forward's lse and di = sum
    o * do (fp32 (B, H, S_q) each): kernel #9 on CUDA tensors, its plain twin
    :func:`bshd_bwd_reference` on CPU tensors. Rows of dk and dv at or past
    ``kv_len`` are zero."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    what = "mha_bshd_bwd"
    route, _ = route_of(what, q, num_heads, mode="bshd", direction="bwd")
    if route == "plain":
        return bshd_bwd_reference(q, k, v, do, lse, di, num_heads=num_heads,
                                  sm_scale=sm_scale, kv_len=kv_len)
    b, sq, skv, d, kv = _check_bshd(what, q, k, v, num_heads, kv_len)
    check_rows(what, (do,), q.device, q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} and q {tuple(q.shape)} differ")
    check_stats(what, (lse, di), b, num_heads, sq, q.device)
    if route == "generic":
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        dk, dv = (torch.empty((b, skv, q.shape[2]), dtype=q.dtype, device=q.device)
                  for _ in range(2))
        generic_attention("bwd", "bshd", [dict(q_rows=sq, kv_rows=skv, kv_valid=kv, q=q, k=k,
                                               v=v, do=do, dq=dq, dk=dk, dv=dv, lse=lse,
                                               di=di)],
                          batch=b, num_heads=num_heads, d=d, sm_scale=sm_scale)
        mha_bshd_bwd.generic_launches += 1
        return dq, dk, dv
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk, dv = (torch.empty((b, skv, q.shape[2]), dtype=torch.bfloat16, device=q.device)
              for _ in range(2))
    acc, splits, dkv_acc = bwd_scratch(b, num_heads, sq, skv, d, q.device)
    rc = _kernels.lib().mha_bshd_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), acc.data_ptr(),
        None if dkv_acc is None else dkv_acc.data_ptr(), splits, sq, skv, kv,
        _bshd_strides((q, k, v, do, dq, dk, dv), d), b, num_heads, d, float(sm_scale),
        _kernels.stream_ptr(q.device))
    _kernels.check(rc, what)
    mha_bshd_bwd.launches += 1
    mha_bshd_bwd.cross_launches += sq != skv
    return dq, dk, dv


# launches of the wgmma + TMA kernel, and of those the ones with S_q != S_kv
# (cross-attention); launches of the generic kernel
mha_bshd_bwd.launches = mha_bshd_bwd.cross_launches = mha_bshd_bwd.generic_launches = 0


class _MhaBshd(torch.autograd.Function):
    """The JAX ``_flash_mha_bshd`` custom VJP. Inputs: num_heads, sm_scale,
    kv_len, q, k, v."""

    @staticmethod
    def forward(ctx, num_heads, sm_scale, kv_len, q, k, v):
        o, lse = mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (num_heads, sm_scale, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        num_heads, sm_scale, kv_len = ctx.args
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = mha_bshd_bwd(q, k, v, do, lse, bwd_row_stats(o, do, num_heads),
                                  num_heads=num_heads, sm_scale=sm_scale, kv_len=kv_len)
        return None, None, None, dq, dk, dv


def mha_bshd(q, k, v, *, num_heads, sm_scale=None, kv_len=None):
    """Bidirectional multi-head attention on (B, S, H*D) tensors, read in
    place (no transposes); keys at or past ``kv_len`` are masked.

    CPU tensors take the plain path; CUDA tensors launch the forward kernel
    of :func:`attention_route` (bf16 at head width 64 or 128: #8; fp32, or
    bf16 at another width up to 128: the generic kernel) or raise.
    Differentiable in q, k and v: the backward launches #9 or the generic
    backward on CUDA tensors and runs its plain twin on CPU tensors.
    """
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MhaBshd.apply(num_heads, sm_scale, kv_len, q, k, v)
    return mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse=False)[0]


mha_bshd.launches = mha_bshd.cross_launches = mha_bshd.generic_launches = 0


# ───────────────────── (B, H, S, D): mha, kernels #10 / #11 ─────────────────────


def flash_bwd_reference(q, k, v, o, lse, do, *, sm_scale, kv_len=None, di=None,
                        round_to=None):
    """Plain twin of the ``mha`` backward kernel (#11), all in fp32 in the
    TPU body's order (adv_grpo_tpu/ops/attention.py ``_bwd_dkv_kernel`` /
    ``_bwd_dq_kernel``, ``_flash_bwd``): s = q k^T * sm_scale, keys at or past
    ``kv_len`` get the finite mask value; p = exp(s - lse); dv = p^T do; dp =
    do v^T; di = sum_d o * do from o as stored (or ``di``, fp32 (B, H, S_q),
    when given); ds = p (dp - di) sm_scale; dk = ds^T q; dq = ds k. p and ds
    are never rounded, unless ``round_to`` names a dtype: then p (for dv) and
    t = p (dp - di) (before the sm_scale) are rounded to it, #9's order. q,
    k, v, o, do: (B, H, S, D); lse: fp32 (B, H, S_q), natural log. Returns
    (dq, dk, dv) in q's dtype."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf @ kf.transpose(-1, -2) * sm_scale
    if kv_len is not None and kv_len < k.shape[2]:
        mask = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.exp(s - lse.float()[..., None])

    def rounded(x):
        return x if round_to is None else x.to(round_to).float()

    dv = rounded(p).transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    di = (o.float() * dof).sum(-1, keepdim=True) if di is None else di.float()[..., None]
    ds = rounded(p * (dp - di)) * sm_scale
    dk = ds.transpose(-1, -2) @ qf
    dq = ds @ kf
    return tuple(a.to(q.dtype) for a in (dq, dk, dv))


def bshd_bwd_reference(q, k, v, do, lse, di, *, num_heads, sm_scale=None, kv_len=None):
    """Plain twin of ``mha_bshd``'s backward kernel (#9), in its op order:
    :func:`flash_bwd_reference` on the (B, H, S, D) views of the (B, S, H*D)
    q, k, v, do, from the forward's lse and di (fp32 (B, H, S_q)), with p and
    t rounded to the inputs' dtype (bf16 on the card; a no-op in fp32) before
    their products; s is scaled in fp32 and dk, dq by sm_scale after the
    products, as in the TPU's split bodies (adv_grpo_tpu/ops/attention.py
    ``_bshd_bwd_dkv_kernel`` / ``_bshd_bwd_dq_kernel``), which keep p and t in
    fp32. Returns (dq, dk, dv) as (B, S, H*D) in q's dtype."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    qh, kh, vh, doh = (to_bhsd(t, num_heads) for t in (q, k, v, do))
    grads = flash_bwd_reference(qh, kh, vh, None, lse, doh, sm_scale=sm_scale, kv_len=kv_len,
                                di=di, round_to=q.dtype)
    return tuple(from_bhsd(g) for g in grads)


def _check_bhsd(what, q, k, v, kv_len):
    """Validate an ``mha`` kernel call on contiguous (B, H, S, D) tensors of
    q's dtype; return (batch, heads, S_q, S_kv, head width, kv_len clamped to
    S_kv)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: the kernel takes q/k/v of one dtype, got {t.dtype} "
                            f"beside {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{what}: expected (B, H, S, D), got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel takes contiguous (B, H, S, D) tensors "
                             "with a 16-byte aligned base")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    kv = skv if kv_len is None else min(int(kv_len), skv)
    if sq < 1 or kv < 1:
        raise ValueError(f"{what}: needs at least one query and one key (S_q={sq}, "
                         f"kv_len={kv})")
    return b, h, sq, skv, d, kv


def mha_fwd(q, k, v, sm_scale, kv_len, want_lse):
    """(o, lse) of :func:`mha`: kernel #10 (``mha_fwd_bf16``) on CUDA
    tensors, :func:`attention_reference` on CPU tensors; lse is fp32 (B, H,
    S_q), or None unless ``want_lse``."""
    what = "mha"
    route, _ = route_of(what, q, 1, mode="bhsd")
    if route == "plain":
        out = attention_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len,
                                  return_lse=want_lse)
        return out if want_lse else (out, None)
    b, h, sq, skv, d, kv = _check_bhsd(what, q, k, v, kv_len)
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if route == "generic":
        generic_attention("fwd", "bhsd", [dict(q_rows=sq, kv_rows=skv, kv_valid=kv, q=q, k=k,
                                               v=v, o=o, lse=lse)],
                          batch=b, num_heads=h, d=d, sm_scale=sm_scale)
        mha.generic_launches += 1
        return o, lse
    rc = _kernels.lib().mha_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), sq, skv, kv, b, h, d,
        float(sm_scale * LOG2E), _kernels.stream_ptr(q.device))
    _kernels.check(rc, what)
    mha.launches += 1
    mha.cross_launches += sq != skv
    return o, lse


def mha_bwd(q, k, v, o, lse, do, *, sm_scale, kv_len=None):
    """(dq, dk, dv) of :func:`mha` from the forward's o and lse: kernel #11
    (``mha_bwd_bf16``, p and ds to fp32 accuracy) on CUDA tensors, its plain
    twin :func:`flash_bwd_reference` on CPU tensors. di = sum_d o * do is
    taken from o as stored, as the TPU's ``_flash_bwd`` takes it."""
    what = "mha_bwd"
    route, _ = route_of(what, q, 1, mode="bhsd", direction="bwd")
    if route == "plain":
        return flash_bwd_reference(q, k, v, o, lse, do, sm_scale=sm_scale, kv_len=kv_len)
    b, h, sq, skv, d, kv = _check_bhsd(what, q, k, v, kv_len)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} and q "
                         f"{tuple(q.shape)} differ")
    _check_bhsd(what, q, o, do, None)  # o and do: contiguous, q's dtype and shape
    check_stats(what, (lse,), b, h, sq, q.device)
    di = (o.float() * do.float()).sum(-1)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if route == "generic":
        generic_attention("bwd", "bhsd", [dict(q_rows=sq, kv_rows=skv, kv_valid=kv, q=q, k=k,
                                               v=v, do=do, dq=dq, dk=dk, dv=dv, lse=lse,
                                               di=di)],
                          batch=b, num_heads=h, d=d, sm_scale=sm_scale)
        mha_bwd.generic_launches += 1
        return dq, dk, dv
    acc, splits, dkv_acc = bwd_scratch(b, h, sq, skv, d, q.device)
    rc = _kernels.lib().mha_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), acc.data_ptr(),
        None if dkv_acc is None else dkv_acc.data_ptr(), splits, sq, skv, kv, b, h, d,
        float(sm_scale), _kernels.stream_ptr(q.device))
    _kernels.check(rc, what)
    mha_bwd.launches += 1
    mha_bwd.cross_launches += sq != skv
    return dq, dk, dv


# launches of #11, and of those the ones with S_q != S_kv; of the generic
# kernel
mha_bwd.launches = mha_bwd.cross_launches = mha_bwd.generic_launches = 0


class _FlashMha(torch.autograd.Function):
    """The JAX ``_flash_mha`` custom VJP. Inputs: sm_scale, kv_len, q, k, v."""

    @staticmethod
    def forward(ctx, sm_scale, kv_len, q, k, v):
        o, lse = mha_fwd(q, k, v, sm_scale, kv_len, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        sm_scale, kv_len = ctx.args
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, o, lse, do.contiguous(), sm_scale=sm_scale,
                             kv_len=kv_len)
        return None, None, dq, dk, dv


def mha(q, k, v, *, sm_scale=None, kv_len=None):
    """Bidirectional multi-head attention on (B, H, S, D) tensors; S_q may
    differ from S_kv; keys at or past ``kv_len`` are masked (``kv_len >=
    S_kv`` is no mask).

    CPU tensors take the plain path; CUDA tensors (contiguous) launch kernel
    #10 (bf16, head width 64 or 128) or the generic kernel (fp32, or bf16 at
    another width up to 128), or raise. Differentiable in q, k and v: the
    backward launches #11 or the generic backward on CUDA tensors and runs
    its plain twin on CPU tensors.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if kv_len is not None and kv_len >= k.shape[2]:
        kv_len = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMha.apply(sm_scale, kv_len, q, k, v)
    return mha_fwd(q, k, v, sm_scale, kv_len, want_lse=False)[0]


mha.launches = mha.cross_launches = mha.generic_launches = 0
