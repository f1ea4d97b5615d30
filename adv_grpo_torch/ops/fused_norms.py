"""Row norms: the modulated LayerNorm, plain LayerNorm and per-head RMS
kernels, and the plain norms beside them.

Port of adv_grpo_tpu/ops/fused_norms.py. ``modulated_layer_norm`` is the
AdaLN ``LN(x) * (1 + scale[:, None]) + shift[:, None]`` (no affine, fp32
statistics) that the MMDiT runs 109 times per forward, Flux.1-dev 115 times
and Wan2.1-T2V-1.3B 61 times; ``layer_norm`` is the plain no-affine LN of
WAN's cross-attention input, 30 times per forward; ``rms_norm_heads`` is the
per-head RMS qk-norm that Flux runs on its own (RoPE sits between the norm
and the attention), 152 times per forward, and WAN across all heads (one
head of the whole row), 120 times. On a CUDA tensor each launches its
hand-written kernel in ``csrc/fused_norms.cu``, on a CPU tensor it runs the
plain version (:func:`lnmod_reference`, :func:`ln_reference`,
:func:`rms_reference`). Each kernel has a bf16 entry (the main path) and an
fp32 one (``*_f32``: the fp32 tiny presets and ``mixed_precision=fp32``),
chosen by the input's dtype (:func:`_entry`). Their backwards, which the fused attention
backwards share, are the JAX package's closed forms in plain PyTorch (they
are plain XLA there too).

The plain versions are device-agnostic tensor code, so they also serve as the
reference the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

from adv_grpo_torch.kernels import build as _kernels

# the kernels' element types: the C entry's suffix, and the elements in a
# 16-byte vector (the unit the kernels load and store)
_DTYPES = {torch.bfloat16: ("bf16", 8), torch.float32: ("f32", 4)}


def _entry(what, name, dtypes):
    """(C entry's name, elements per 16-byte vector) of kernel ``name`` for
    tensors of ``dtypes`` (inputs and output), which must all be bf16 or all
    fp32."""
    dt = set(dtypes)
    if len(dt) != 1 or next(iter(dt)) not in _DTYPES:
        raise TypeError(f"{what}: the kernel takes bf16 or fp32 inputs and output of one "
                        f"dtype; got {', '.join(map(str, dtypes))}")
    suffix, vec = _DTYPES[next(iter(dt))]
    return f"{name}_{suffix}", vec


def ln_reference(x, eps, out_dtype):
    """No-affine LayerNorm over the last dim, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(out_dtype)


def rms_reference(x, w, num_heads, eps, out_dtype):
    """Per-head RMS norm of (B, S, H*D) with a shared (D,) weight, fp32."""
    b, s, hd = x.shape
    xf = x.reshape(b, s, num_heads, hd // num_heads).float()
    m2 = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(m2 + eps) * w.float()
    return y.reshape(b, s, hd).to(out_dtype)


def lnmod_reference(x, scale, shift, eps, out_dtype):
    """Plain ``LN(x) * (1 + scale) + shift``; x (B, S, D), scale/shift (B, D)."""
    y = ln_reference(x, eps, torch.float32)
    y = y * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return y.to(out_dtype)


def _ln_dx(x, g, eps):
    """(dx, xhat) of a no-affine LN at x for the fp32 cotangent g of its
    output: dx = rsig * (g - mean(g) - xhat * mean(g * xhat)), fp32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    xhat = xc * rsig
    return rsig * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True)), xhat


def ln_bwd_closed(x, dy, eps):
    """Closed-form backward of the no-affine LN (the JAX package's
    ``_layer_norm_p_bwd``): dx in x's dtype, fp32 inside."""
    return _ln_dx(x, dy.float(), eps)[0].to(x.dtype)


def lnmod_bwd_closed(x, scale, dy, eps):
    """Closed-form backward of ``LN(x) * (1 + scale) + shift`` (the JAX
    package's ``_ln_mod_p_bwd``): with xhat = LN(x) and g = dy * (1 + scale),
    dx = rsig * (g - mean(g) - xhat * mean(g * xhat)), dscale = sum_s dy * xhat,
    dshift = sum_s dy; fp32 inside, each cast back to its input's dtype."""
    dyf = dy.float()
    dx, xhat = _ln_dx(x, dyf * (1.0 + scale.float()[:, None]), eps)
    return (dx.to(x.dtype), (dyf * xhat).sum(1).to(scale.dtype),
            dyf.sum(1).to(scale.dtype))


def rms_bwd_closed(x, w, dy, num_heads, eps):
    """Closed-form per-head RMS backward (the JAX package's ``rms_bwd_closed``):
    r = rsqrt(mean(x^2) + eps), y = x * r * w;
    dx = r * (w * dy) - x * r^3 / d * sum(x * w * dy), dw = sum(dy * x * r).
    x, dy: (B, S, H*D); w: (D,). Returns (dx in x's dtype, dw in w's dtype)."""
    b, s, hd = x.shape
    d = hd // num_heads
    xf = x.reshape(b, s, num_heads, d).float()
    g = dy.reshape(b, s, num_heads, d).float()
    wf = w.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    gw = g * wf
    dx = r * gw - xf * (r ** 3 / d) * (xf * gw).sum(-1, keepdim=True)
    dw = (g * xf * r).sum(dim=(0, 1, 2))
    return dx.reshape(b, s, hd).to(x.dtype), dw.to(w.dtype)


def _rms_forward(x, w, num_heads, eps, out_dtype):
    """The per-head RMS kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return rms_reference(x, w, num_heads, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_heads: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"rms_norm_heads: x must be (B, S, H*D), got {tuple(x.shape)}")
    b, s, hd = x.shape
    if num_heads < 1 or hd % num_heads:
        raise ValueError(f"rms_norm_heads: width {hd} does not split into {num_heads} heads")
    d = hd // num_heads
    fn, vec = _entry("rms_norm_heads", "rms_heads", (x.dtype, out_dtype))
    if (w.device != x.device or w.dtype != torch.float32 or w.shape != (d,)
            or not w.is_contiguous()):
        raise ValueError(f"rms_norm_heads: the weight must be contiguous fp32 ({d},) on "
                         f"{x.device}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    # a head's vectors are reduced by lane shuffles when they tile a warp
    # (d <= 32 vectors), by a block reduction when the head is the whole row
    if d % vec or not ((32 % (d // vec) == 0) or num_heads == 1) or hd // vec > 4096:
        widths = ", ".join(str(vec << i) for i in range(6))
        raise ValueError(f"rms_norm_heads: head width {d} of {num_heads} heads: the kernel "
                         f"takes d in ({widths}) in {x.dtype}, or one head of any "
                         f"multiple of {vec} up to {4096 * vec}")
    # rows read in place through (batch, row) strides, as 16-byte vectors
    if x.stride(2) != 1 or x.stride(0) % vec or x.stride(1) % vec or x.data_ptr() % 16:
        raise ValueError("rms_norm_heads: the last dim must be contiguous, with batch/row "
                         f"strides that are multiples of {vec} and a 16-byte aligned base")
    y = torch.empty((b, s, hd), dtype=x.dtype, device=x.device)
    if y.numel():
        rc = getattr(_kernels.lib(), fn)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b * s, s, hd, d, x.stride(0),
            x.stride(1), float(eps), _kernels.stream_ptr(x.device))
        _kernels.check(rc, "rms_norm_heads")
        rms_norm_heads.launches += 1
    return y


class _RmsNormHeads(torch.autograd.Function):
    """The JAX ``_rms_heads_p`` custom VJP: forward the kernel (CUDA) or the
    plain version (CPU); backward the closed form :func:`rms_bwd_closed`."""

    @staticmethod
    def forward(ctx, x, w, num_heads, eps, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.args = (num_heads, eps)
        return _rms_forward(x, w, num_heads, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return (*rms_bwd_closed(x, w, dy, *ctx.args), None, None, None)


def rms_norm_heads(x, w, *, num_heads: int, eps: float = 1e-6, out_dtype=None):
    """Per-head RMS norm of (B, S, H*D) with a shared fp32 (D,) weight:
    statistics in fp32, ``x * rsqrt(mean(x^2) + eps) * w``, cast to
    ``out_dtype`` — the Flux / WAN qk-norm (``num_heads=1`` normalises the
    whole row, WAN's across-heads norm).

    CPU tensors take the plain path; CUDA tensors launch the kernel in
    ``csrc/fused_norms.cu`` (bf16 or fp32, the output in x's dtype, rows
    read through their strides) or raise. Differentiable in x and w.
    """
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RmsNormHeads.apply(x, w, num_heads, eps, out_dtype)
    return _rms_forward(x, w, num_heads, eps, out_dtype)


rms_norm_heads.launches = 0


def _check_ln_rows(what, x, vec):
    """The LayerNorm kernels' input checks on a CUDA x: (B, S, D) with D a
    multiple of ``vec`` (the elements of a 16-byte vector) and at most vec *
    4096, contiguous, 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"{what}: x must be (B, S, D), got {tuple(x.shape)}")
    d = x.shape[2]
    if d % vec or d // vec > 4096:
        raise ValueError(f"{what}: D={d} must be a multiple of {vec} and at most {4096 * vec}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous with a 16-byte aligned base")


def _lnmod_forward(x, scale, shift, eps, out_dtype):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lnmod_reference(x, scale, shift, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x.device}")
    fn, vec = _entry("modulated_layer_norm", "lnmod",
                     (x.dtype, scale.dtype, shift.dtype, out_dtype))
    _check_ln_rows("modulated_layer_norm", x, vec)
    b, s, d = x.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (b, d):
            raise ValueError(f"modulated_layer_norm: {name} must be {(b, d)}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"modulated_layer_norm: {name} on {t.device}, x on {x.device}")
    # scale/shift may be chunks of one modulation matmul: rows read through
    # their stride, 16-byte vectors along D
    if any(t.stride(1) != 1 or t.stride(0) % vec or t.data_ptr() % 16 for t in (scale, shift)):
        raise ValueError("modulated_layer_norm: scale and shift need unit stride along D "
                         "and 16-byte aligned rows")
    y = torch.empty_like(x)
    if y.numel():
        rc = getattr(_kernels.lib(), fn)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            b * s, s, d, scale.stride(0), shift.stride(0), float(eps),
            _kernels.stream_ptr(x.device))
        _kernels.check(rc, "modulated_layer_norm")
        modulated_layer_norm.launches += 1
    return y


class _ModulatedLayerNorm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU); backward: the
    closed form :func:`lnmod_bwd_closed`, plain PyTorch on both devices, as the
    JAX package's backward is plain XLA."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _lnmod_forward(x, scale, shift, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return (*lnmod_bwd_closed(x, scale, dy, ctx.eps), None, None)


def modulated_layer_norm(x, scale, shift, *, eps: float = 1e-6, out_dtype=None):
    """Fused ``LN(x) * (1 + scale[:, None]) + shift[:, None]``.

    x: (B, S, D); scale, shift: (B, D). CPU tensors take the plain path; CUDA
    tensors launch the kernel (bf16 or fp32 in and out, one dtype, x
    contiguous, D a whole number of 16-byte vectors) or raise.
    Differentiable in x, scale and shift.
    """
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        return _ModulatedLayerNorm.apply(x, scale, shift, eps, out_dtype)
    return _lnmod_forward(x, scale, shift, eps, out_dtype)


modulated_layer_norm.launches = 0


def _ln_forward(x, eps, out_dtype):
    """The no-affine LN kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return ln_reference(x, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    fn, vec = _entry("layer_norm", "ln", (x.dtype, out_dtype))
    _check_ln_rows("layer_norm", x, vec)
    y = torch.empty_like(x)
    if y.numel():
        rc = getattr(_kernels.lib(), fn)(x.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1],
                                         x.shape[2], float(eps), _kernels.stream_ptr(x.device))
        _kernels.check(rc, "layer_norm")
        layer_norm.launches += 1
    return y


class _LayerNorm(torch.autograd.Function):
    """The JAX ``_layer_norm_p`` custom VJP: forward the kernel (CUDA) or the
    plain version (CPU); backward the closed form :func:`ln_bwd_closed`, plain
    PyTorch on both devices."""

    @staticmethod
    def forward(ctx, x, eps, out_dtype):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _ln_forward(x, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return ln_bwd_closed(x, dy, ctx.eps), None, None


def layer_norm(x, *, eps: float = 1e-6, out_dtype=None):
    """No-affine LayerNorm over the last dim of (B, S, D), fp32 statistics:
    ``(x - mean) * rsqrt(var + eps)`` with the centred variance, cast to
    ``out_dtype``.

    CPU tensors take the plain path; CUDA tensors launch the kernel (bf16 or
    fp32 in and out, one dtype, x contiguous, D a whole number of 16-byte
    vectors) or raise. Differentiable in x.
    """
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        return _LayerNorm.apply(x, eps, out_dtype)
    return _ln_forward(x, eps, out_dtype)


layer_norm.launches = 0
