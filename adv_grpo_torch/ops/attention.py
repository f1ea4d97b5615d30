"""Multi-head attention in the (B, S, H*D) projection layout and in the
(B, H, S, D) layout, their plain versions and backwards, and the row
statistics and backward twin the fused attention backwards share.

Port of adv_grpo_tpu/ops/attention.py: ``attention_reference`` (with the
``kv_len`` key mask), ``mha_bshd`` (Flux's single-block and WAN's attention)
with its custom VJP (``_flash_mha_bshd``), ``mha`` (the (B, H, S, D) flash
attention that context-parallel attention runs) with its custom VJP
(``_flash_mha``), and ``bwd_row_stats``.

On CUDA tensors ``mha_bshd`` launches the forward kernel in
``csrc/joint_attention.cu`` (``mha_bshd_fwd_bf16``), which reads q/k/v in
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
:func:`bshd_bwd_reference` and :func:`flash_bwd_reference`;
:func:`attention_bwd_reference` is the twin of the joint backwards
(``ops/joint_attention.py``).

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
    :275-320 and ops/attention.py:516-545): RMS in fp32, then x w; qs2 = dt(yq
    * sm_scale * log2 e); s = qs2 . dt(yk); p = exp2(s - lse * log2 e); dv =
    dt(p)^T do; dp = do v^T; t = dt(p * (dp - di)); dyk = t^T dt(yq *
    sm_scale); dyq = (t dt(yk)) * sm_scale — the kernel's order, one rounding
    fewer than the TPU's t dt(dt(yk) * sm_scale), equal to it when sm_scale is
    a power of two (head width 64); fp32 accumulation.
    """
    dt = qs[0].dtype
    d = qs[0].shape[-1] // num_heads
    if sm_scale is None:
        sm_scale = d ** -0.5

    def norm(x, w):  # (B, H, S, D) fp32 of the (optionally) RMS-normalised x
        xf = to_bhsd(x, num_heads).float()
        if w is None:
            return xf
        return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w.float()

    ws = rms_weights or [(None, None)] * len(qs)
    yq = torch.cat([norm(q, w[0]) for q, w in zip(qs, ws)], dim=2)
    yk = torch.cat([norm(k, w[1]) for k, w in zip(ks, ws)], dim=2).to(dt).float()
    v = torch.cat([to_bhsd(a, num_heads) for a in vs], dim=2).float()
    do = torch.cat([to_bhsd(a, num_heads) for a in dos], dim=2).float()
    lse2 = torch.cat(lses, dim=-1)[..., None].float() * LOG2E
    di = torch.cat(dis, dim=-1)[..., None].float()

    qs2 = (yq * (sm_scale * LOG2E)).to(dt).float()
    yq_s = (yq * sm_scale).to(dt).float()
    p = torch.exp2(qs2 @ yk.transpose(-1, -2) - lse2)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    t = (p * (do @ v.transpose(-1, -2) - di)).to(dt).float()
    dyk = t.transpose(-1, -2) @ yq_s
    dyq = (t @ yk) * sm_scale

    q_lens, kv_lens = [q.shape[1] for q in qs], [k.shape[1] for k in ks]
    outs = [[from_bhsd(c).to(dt) for c in torch.split(a, lens, dim=2)]
            for a, lens in ((dyq, q_lens), (dyk, kv_lens), (dv, kv_lens))]
    return [tuple(o[i] for o in outs) for i in range(len(qs))]


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


def check_stats(what, stats, batch, num_heads, length, device):
    """Validate fp32 contiguous (B, H, S) row statistics (lse, di)."""
    for t in stats:
        if (t.device != device or t.dtype != torch.float32
                or t.shape != (batch, num_heads, length) or not t.is_contiguous()):
            raise ValueError(f"{what}: row statistics must be contiguous fp32 "
                             f"{(batch, num_heads, length)} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def head_dim_of(what, width, num_heads, dims=HEAD_DIMS):
    """The head width of a (.., H*D) tensor; raises unless it is in ``dims``."""
    if num_heads < 1 or width % num_heads or width // num_heads not in dims:
        raise ValueError(f"{what}: the kernel takes heads of {' or '.join(map(str, dims))}; "
                         f"got width {width} for {num_heads} heads")
    return width // num_heads


def int64_array(vals):
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_bshd(what, q, k, v, num_heads, kv_len):
    """Validate a (q, k, v) kernel call; return (batch, S_q, S_kv, head width,
    kv_len clamped to S_kv)."""
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
    if q.device.type == "cpu":
        out = mha_bshd_reference(q, k, v, num_heads=num_heads, sm_scale=sm_scale,
                                 kv_len=kv_len, return_lse=want_lse)
        return out if want_lse else (out, None)
    what = "mha_bshd"
    b, sq, skv, d, kv = _check_bshd(what, q, k, v, num_heads, kv_len)
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
    if q.device.type == "cpu":
        return bshd_bwd_reference(q, k, v, do, lse, di, num_heads=num_heads,
                                  sm_scale=sm_scale, kv_len=kv_len)
    what = "mha_bshd_bwd"
    b, sq, skv, d, kv = _check_bshd(what, q, k, v, num_heads, kv_len)
    check_rows(what, (do,), q.device)
    if do.shape != q.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} and q {tuple(q.shape)} differ")
    check_stats(what, (lse, di), b, num_heads, sq, q.device)
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


# launches, and of those the ones with S_q != S_kv (cross-attention)
mha_bshd_bwd.launches = mha_bshd_bwd.cross_launches = 0


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
    (bf16, head width 64 or 128) or raise. Differentiable in q, k and v: the
    backward launches ``mha_bshd_bwd_bf16`` on CUDA tensors and runs its plain
    twin on CPU tensors.
    """
    if sm_scale is None:
        sm_scale = (q.shape[-1] // num_heads) ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MhaBshd.apply(num_heads, sm_scale, kv_len, q, k, v)
    return mha_bshd_fwd(q, k, v, num_heads, sm_scale, kv_len, want_lse=False)[0]


mha_bshd.launches = mha_bshd.cross_launches = 0


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
    """Validate an ``mha`` kernel call on contiguous bf16 (B, H, S, D)
    tensors; return (batch, heads, S_q, S_kv, head width, kv_len clamped to
    S_kv)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bf16 q/k/v, got {t.dtype}")
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
    head_dim_of(what, d, 1)
    kv = skv if kv_len is None else min(int(kv_len), skv)
    if sq < 1 or kv < 1:
        raise ValueError(f"{what}: needs at least one query and one key (S_q={sq}, "
                         f"kv_len={kv})")
    return b, h, sq, skv, d, kv


def mha_fwd(q, k, v, sm_scale, kv_len, want_lse):
    """(o, lse) of :func:`mha`: kernel #10 (``mha_fwd_bf16``) on CUDA
    tensors, :func:`attention_reference` on CPU tensors; lse is fp32 (B, H,
    S_q), or None unless ``want_lse``."""
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len,
                                  return_lse=want_lse)
        return out if want_lse else (out, None)
    what = "mha"
    b, h, sq, skv, d, kv = _check_bhsd(what, q, k, v, kv_len)
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
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
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, sm_scale=sm_scale, kv_len=kv_len)
    what = "mha_bwd"
    b, h, sq, skv, d, kv = _check_bhsd(what, q, k, v, kv_len)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} and q "
                         f"{tuple(q.shape)} differ")
    _check_bhsd(what, q, o, do, None)  # o and do: contiguous bf16 of q's shape
    check_stats(what, (lse,), b, h, sq, q.device)
    di = (o.float() * do.float()).sum(-1)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
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


# launches, and of those the ones with S_q != S_kv
mha_bwd.launches = mha_bwd.cross_launches = 0


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

    CPU tensors take the plain path; CUDA tensors launch kernel #10 (bf16,
    contiguous, head width 64 or 128) or raise. Differentiable in q, k and v:
    the backward launches kernel #11 on CUDA tensors and runs its plain twin
    on CPU tensors.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if kv_len is not None and kv_len >= k.shape[2]:
        kv_len = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMha.apply(sm_scale, kv_len, q, k, v)
    return mha_fwd(q, k, v, sm_scale, kv_len, want_lse=False)[0]


mha.launches = mha.cross_launches = 0
