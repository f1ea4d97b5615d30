"""The StyleGAN2-style image discriminator of the ``discriminator`` reward,
in PyTorch.

Port of adv_grpo_tpu/models/stylegan_d.py: a 1x1 ``from_rgb``, residual
downsampling blocks to 4x4 (a bias-free 1x1 skip, two 3x3 convs, 2x2 average
pools, the sum over sqrt(2)), the minibatch standard deviation as one more
channel, a 3x3 conv, then two Linears on the (h, w, c)-flattened features.
The convolutions run NCHW; the features are flattened in the JAX NHWC
order, so the Linear weights are the JAX kernels transposed.

``StyleGANScorer.score`` is the reference's ``discriminator`` reward
(adv_grpo/rewards.py:611-638): inputs in [0, 255] or [0, 1] renormalised to
[-1, 1] on the device (no host sync), resized to the D's resolution as
``jax.image.resize(..., "bilinear")`` resizes (a triangle filter widened by
the scale when downsampling: antialiased), then ``logits_to_scores``.
fp32 throughout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class StyleGANDConfig:
    image_size: int = 256
    base_channels: int = 32
    max_channels: int = 512
    mbstd_group_size: int = 4

    @property
    def num_blocks(self) -> int:
        """Blocks that halve the resolution down to 4x4."""
        n, size = 0, self.image_size
        while size > 4:
            size //= 2
            n += 1
        return n

    def block_channels(self) -> Tuple[int, ...]:
        return tuple(min(self.base_channels * 2 ** i, self.max_channels)
                     for i in range(self.num_blocks + 1))


def mbstd_group(batch: int, group_size: int = 4) -> int:
    """The JAX package's group: ``g = B // (B // min(group_size, B))``. It is
    not the largest divisor of B up to ``group_size``: at B = 5, 6, 7, 10 or
    15 it exceeds 4, and at B = 9, 11, 13 or 14 it does not divide B, where
    the JAX reshape raises; so does this (``ValueError`` naming both)."""
    g = min(group_size, batch)
    g = batch // (batch // g)
    if batch % g:
        raise ValueError(f"minibatch_stddev: the group {g} (B // (B // min({group_size}, B))) "
                         f"does not divide the batch B = {batch}")
    return g


def minibatch_stddev(x: torch.Tensor, group_size: int = 4) -> torch.Tensor:
    """Append the cross-sample feature stddev as one constant channel: (B, C,
    H, W) -> (B, C + 1, H, W). Sample b = i * (B / g) + j is in group j, as in
    the JAX reshape to (g, B / g, ...)."""
    B, C, H, W = x.shape
    g = mbstd_group(B, group_size)
    y = x.reshape(g, B // g, C, H, W)
    y = y - y.mean(0, keepdim=True)
    y = torch.sqrt(y.square().mean(0) + 1e-8)  # (B/g, C, H, W)
    y = y.mean((1, 2, 3)).view(1, B // g, 1, 1, 1).expand(g, B // g, 1, H, W)
    return torch.cat([x, y.reshape(B, 1, H, W)], dim=1)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.skip = nn.Conv2d(in_channels, out_channels, 1, bias=False, device=device)
        self.conv0 = nn.Conv2d(in_channels, in_channels, 3, padding=1, device=device)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device)

    def forward(self, x):
        skip = F.avg_pool2d(self.skip(x), 2)
        h = F.leaky_relu(self.conv0(x), 0.2)
        h = F.avg_pool2d(F.leaky_relu(self.conv1(h), 0.2), 2)
        return (h + skip) / 2.0 ** 0.5


class StyleGANDiscriminator(nn.Module):
    """images (B, 3, H, W) in [-1, 1] -> logits (B,)."""

    def __init__(self, cfg: StyleGANDConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_channels()
        self.from_rgb = nn.Conv2d(3, ch[0], 1, device=device)
        self.blocks = nn.ModuleList(ResidualBlock(ch[i], ch[i + 1], device)
                                    for i in range(cfg.num_blocks))
        self.conv_out = nn.Conv2d(ch[-1] + 1, ch[-1], 3, padding=1, device=device)
        side = cfg.image_size >> cfg.num_blocks
        self.fc0 = nn.Linear(side * side * ch[-1], ch[-1], device=device)
        self.fc_out = nn.Linear(ch[-1], 1, device=device)

    def forward(self, images):
        x = F.leaky_relu(self.from_rgb(images.float()), 0.2)
        for block in self.blocks:
            x = block(x)
        x = minibatch_stddev(x, self.cfg.mbstd_group_size)
        x = F.leaky_relu(self.conv_out(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the JAX (h, w, c) order
        x = F.leaky_relu(self.fc0(x), 0.2)
        return self.fc_out(x).squeeze(-1)


def logits_to_scores(logits: torch.Tensor) -> torch.Tensor:
    """The reference's shape dispatch (rewards.py:622-634): StyleGAN [B] or
    [B, 1] -> sigmoid; PatchGAN [B, 1, H', W'] -> mean(sigmoid)."""
    if logits.ndim == 1:
        return torch.sigmoid(logits)
    if logits.ndim == 2 and logits.shape[1] == 1:
        return torch.sigmoid(logits.squeeze(1))
    if logits.ndim == 4 and logits.shape[1] == 1:
        return torch.sigmoid(logits).mean((1, 2, 3))
    raise ValueError(f"unexpected discriminator logits shape: {tuple(logits.shape)}")


@functools.lru_cache(maxsize=16)
def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of ``jax.image.resize``'s bilinear
    method along one axis (``compute_weight_mat``, antialias on): the
    triangle kernel at (i + 0.5) / scale - 0.5, its support widened by
    1 / scale when downsampling, each column normalised by its sum."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0) * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), as ``jax.image.resize(images,
    (B, C, size, size), "bilinear")``; an axis already at ``size`` is left
    as it is."""
    x = images
    if x.shape[-2] != size:
        wh = torch.from_numpy(bilinear_weights(x.shape[-2], size)).to(x.device)
        x = torch.einsum("bchw,hy->bcyw", x, wh)
    if x.shape[-1] != size:
        ww = torch.from_numpy(bilinear_weights(x.shape[-1], size)).to(x.device)
        x = torch.einsum("bchw,wx->bchx", x, ww)
    return x


class StyleGANScorer:
    """The ``discriminator`` reward: sigmoid(D(images)) in [0, 1]. Its
    weights live in ``self.model``; scoring runs under ``torch.no_grad``,
    with TF32 off for its matmuls (process-wide, as the other scorers) and
    its convolutions (for the call)."""

    def __init__(self, model: StyleGANDiscriminator):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.eval().requires_grad_(False)
        self.cfg = model.cfg
        self.device = model.fc_out.weight.device

    @classmethod
    def random_init(cls, generator: torch.Generator, device,
                    cfg: StyleGANDConfig = None) -> "StyleGANScorer":
        """The D at ``cfg`` with random weights drawn from ``generator``
        (``rewards.scorers.random_init_``: normal with std 1 / sqrt(fan_in),
        zero biases)."""
        from adv_grpo_torch.rewards.scorers import random_init_

        model = StyleGANDiscriminator(cfg or StyleGANDConfig(), device="meta")
        return cls(random_init_(model.to_empty(device=device), generator))

    @classmethod
    def from_state_dict(cls, state_dict, device, cfg: StyleGANDConfig) -> "StyleGANScorer":
        model = StyleGANDiscriminator(cfg, device="meta").to_empty(device=device)
        model.load_state_dict(state_dict)
        return cls(model)

    @staticmethod
    def normalise(images: torch.Tensor) -> torch.Tensor:
        """[0, 255] -> [0, 1] where the largest |value| exceeds 1.5; then
        [0, 1] -> [-1, 1] where nothing is negative; both decided on the
        device."""
        images = images.float()
        images = torch.where(images.abs().amax() > 1.5, images / 255.0, images)
        return torch.where(images.amin() >= 0.0, (images - 0.5) * 2.0, images)

    @torch.no_grad()
    def score(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = resize_bilinear(self.normalise(images.to(self.device)), self.cfg.image_size)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # fp32 convs
            return logits_to_scores(self.model(x))
