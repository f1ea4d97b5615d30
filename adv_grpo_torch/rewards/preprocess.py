"""Image preprocessing for the neural reward scorers, PIL-faithful, in torch.

Port of adv_grpo_tpu/rewards/preprocess.py. Scorer values feed advantages,
so the resize must be PIL's BICUBIC as the reference's tensor -> PIL ->
CLIPProcessor path applies it: antialiased on downscale (the filter support
scaled by the scale factor), filter weights snapped to PIL's int16 fixed
point, and each separable pass rounded back to uint8 (round half up,
horizontal pass first); the filter support is not scaled on upsampling
(DINO resizes 512 to 518). ``pil_resample_weights`` is the port's own copy
of the JAX package's numpy weights; the two passes are fp32 matmuls against
them, which need the full mantissa (the negative-lobe sums): TF32 must be
off, as ``rewards.scorers.PickScoreScorer`` sets it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

_PRECISION_BITS = 22  # PIL normalize_coeffs_8bpc: 32 - 8 - 2


def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic, a=-0.5 (PIL's BICUBIC filter)."""
    x = np.abs(x)
    return np.where(
        x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=64)
def pil_resample_weights(in_size: int, out_size: int,
                         fixed_point: bool = True) -> np.ndarray:
    """(out_size, in_size) PIL ImagingResampleHorizontal coefficient matrix.

    Reproduces PIL precompute_coeffs: per output pixel, center = (i+0.5)*scale,
    support = 2*max(scale,1) (antialias on downscale), normalised bicubic taps;
    ``fixed_point`` additionally snaps weights to the int16 grid PIL uses for
    8-bit images.
    """
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    W = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = _bicubic_kernel((xs - center + 0.5) / fs)
        w = w / w.sum()
        if fixed_point:
            w = np.round(w * (1 << _PRECISION_BITS)) / (1 << _PRECISION_BITS)
        W[i, xmin:xmax] = w
    return W.astype(np.float32)


def to_unit(images):
    """[-1, 1] -> [0, 1], clipped."""
    return (images * 0.5 + 0.5).clamp(0.0, 1.0)


def quantize_uint8(images01):
    """Snap to the uint8 grid of the reference's PIL round trip: PIL's
    clip8((ss + half) >> bits) rounds half up, not half to even."""
    return torch.floor(images01 * 255.0 + 0.5).clamp(0.0, 255.0) / 255.0


@functools.lru_cache(maxsize=16)
def _weights(in_size, out_size, device):
    return torch.from_numpy(pil_resample_weights(in_size, out_size)).to(device)


def resize_bicubic(images, size: int):
    """(B, 3, H, W) in [0, 1] -> (B, 3, size, size) fp32, PIL-BICUBIC-faithful:
    the horizontal pass, then the vertical one, each snapped to uint8."""
    ww = _weights(images.shape[3], size, images.device)
    wh = _weights(images.shape[2], size, images.device)
    h = quantize_uint8(images.float() @ ww.T)  # (B, C, H, size)
    return quantize_uint8(wh @ h).clamp(0.0, 1.0)


def preprocess(images, size: int, mean, std):
    """The whole scorer pipeline from [-1, 1]: to [0, 1], the uint8 snap (the
    PNG / PIL grid), the PIL resize with per-pass rounding, normalisation."""
    x = resize_bicubic(quantize_uint8(to_unit(images.float())), size)
    mean = torch.tensor(mean, dtype=torch.float32).view(1, 3, 1, 1).to(x.device)
    std = torch.tensor(std, dtype=torch.float32).view(1, 3, 1, 1).to(x.device)
    return (x - mean) / std
