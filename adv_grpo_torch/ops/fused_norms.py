"""Row norms: the modulated LayerNorm kernel and the plain norms beside it.

Port of adv_grpo_tpu/ops/fused_norms.py. ``modulated_layer_norm`` is the
AdaLN ``LN(x) * (1 + scale[:, None]) + shift[:, None]`` (no affine, fp32
statistics) that the MMDiT runs 109 times per forward; on a CUDA tensor it
launches the hand-written kernel in ``csrc/fused_norms.cu``, on a CPU tensor it
runs the plain version :func:`lnmod_reference`.

The plain versions are device-agnostic tensor code, so they also serve as the
reference the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

from adv_grpo_torch.kernels import build as _kernels


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


def modulated_layer_norm(x, scale, shift, *, eps: float = 1e-6, out_dtype=None):
    """Fused ``LN(x) * (1 + scale[:, None]) + shift[:, None]``.

    x: (B, S, D); scale, shift: (B, D). CPU tensors take the plain path; CUDA
    tensors launch the kernel (bf16 in and out, x contiguous, D a multiple of
    8) or raise.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return lnmod_reference(x, scale, shift, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"modulated_layer_norm: x must be (B, S, D), got {tuple(x.shape)}")
    b, s, d = x.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (b, d):
            raise ValueError(f"modulated_layer_norm: {name} must be {(b, d)}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"modulated_layer_norm: {name} on {t.device}, x on {x.device}")
    if {x.dtype, scale.dtype, shift.dtype, out_dtype} != {torch.bfloat16}:
        raise TypeError("modulated_layer_norm: the kernel takes bf16 x, scale, shift and "
                        f"output; got x {x.dtype}, scale {scale.dtype}, shift "
                        f"{shift.dtype}, out {out_dtype}")
    vec = 8  # bf16 elements per 16-byte vector
    if d % vec or d // vec > 4096:
        raise ValueError(f"modulated_layer_norm: D={d} must be a multiple of {vec} "
                         f"and at most {4096 * vec}")
    # scale/shift may be chunks of one modulation matmul: rows read through
    # their stride, 16-byte vectors along D
    if not x.is_contiguous() or x.data_ptr() % 16 or any(
            t.stride(1) != 1 or t.stride(0) % vec or t.data_ptr() % 16
            for t in (scale, shift)):
        raise ValueError("modulated_layer_norm: x must be contiguous; scale and shift "
                         "need unit stride along D and 16-byte aligned rows")
    y = torch.empty_like(x)
    if y.numel():
        rc = _kernels.lib().lnmod_bf16(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            b * s, s, d, scale.stride(0), shift.stride(0), float(eps),
            _kernels.stream_ptr(x.device))
        _kernels.check(rc, "modulated_layer_norm")
        modulated_layer_norm.launches += 1
    return y


modulated_layer_norm.launches = 0
