"""SD3 / Flux AutoencoderKL (16-channel latents) in PyTorch, fp32.

Port of adv_grpo_tpu/models/vae.py, with diffusers ``AutoencoderKL``
state-dict names (``encoder.conv_in``, ``encoder.down_blocks.{i}.resnets.{j}``,
``encoder.down_blocks.{i}.downsamplers.0.conv``, ``encoder.mid_block``,
``encoder.conv_norm_out``, ``encoder.conv_out``; ``decoder.conv_in``,
``decoder.mid_block.resnets.{0,1}``, ``decoder.mid_block.attentions.0``,
``decoder.up_blocks.{i}.resnets.{j}``, ``decoder.up_blocks.{i}.upsamplers.0.conv``,
``decoder.conv_norm_out``, ``decoder.conv_out``), so a diffusers ``vae/``
directory loads whole:

  encoder: conv_in -> 4 down blocks (2 resnets each; pad (0, 1) and a
  stride-2 conv after the first 3) -> mid -> GroupNorm -> silu -> conv_out
  -> (mean, logvar)
  decoder: conv_in -> mid (resnet, single-head attention, resnet) -> 4 up
  blocks (3 resnets each; nearest-2x upsample + conv after the first 3) ->
  GroupNorm -> silu -> conv_out -> RGB in [-1, 1]

It runs in fp32 like the JAX model (decoded pixels feed reward scorers). The
JAX package has no Pallas kernel here, so this is plain torch. Convolutions
and float32 matmuls must not drop to TF32 for that to hold on the card:
``SD3Pipeline`` switches TF32 off. NCHW throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 1.5305
    shift_factor: float = 0.0609
    dtype: Any = torch.float32

    @classmethod
    def sd3(cls, **overrides) -> "VAEConfig":
        return cls(**overrides)

    @classmethod
    def flux(cls, **overrides) -> "VAEConfig":
        """Flux.1's VAE: the SD3 topology (16 latent channels) with its own
        latent normalisation (diffusers FLUX.1-dev vae/config.json)."""
        defaults = dict(scaling_factor=0.3611, shift_factor=0.1159)
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **overrides) -> "VAEConfig":
        defaults = dict(block_out_channels=(8, 16), layers_per_block=1,
                        norm_num_groups=4, latent_channels=4)
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def _gn(cfg, ch, device):
    return nn.GroupNorm(cfg.norm_num_groups, ch, eps=1e-6, dtype=cfg.dtype, device=device)


def _conv(cfg, cin, cout, k, device):
    return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=cfg.dtype, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.norm1 = _gn(cfg, in_ch, device)
        self.conv1 = _conv(cfg, in_ch, out_ch, 3, device)
        self.norm2 = _gn(cfg, out_ch, device)
        self.conv2 = _conv(cfg, out_ch, out_ch, 3, device)
        self.conv_shortcut = _conv(cfg, in_ch, out_ch, 1, device) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over (H*W) tokens, fp32 softmax."""

    def __init__(self, cfg: VAEConfig, ch: int, device=None):
        super().__init__()
        self.group_norm = _gn(cfg, ch, device)
        kw = dict(dtype=cfg.dtype, device=device)
        self.to_q, self.to_k = nn.Linear(ch, ch, **kw), nn.Linear(ch, ch, **kw)
        self.to_v = nn.Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch, **kw)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.bmm(q.float(), k.float().transpose(1, 2))
        p = torch.softmax(s * (C ** -0.5), dim=-1)
        o = torch.bmm(p, v.float()).to(x.dtype)
        o = self.to_out[0](o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, ch, ch, device),
                                      ResnetBlock(cfg, ch, ch, device)])
        self.attentions = nn.ModuleList([AttnBlock(cfg, ch, device)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Upsample(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int, device=None):
        super().__init__()
        self.conv = _conv(cfg, ch, ch, 3, device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UpBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, upsample: bool,
                 device=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch, device)
            for j in range(cfg.layers_per_block + 1)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(cfg, out_ch, device)])
        else:
            self.upsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Downsample(nn.Module):
    """diffusers Downsample2D: pad (0, 1) on the right and bottom, then a
    stride-2 3x3 conv without padding."""

    def __init__(self, cfg: VAEConfig, ch: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, dtype=cfg.dtype, device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class DownBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, downsample: bool,
                 device=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch, device)
            for j in range(cfg.layers_per_block)])
        self.downsamplers = (nn.ModuleList([Downsample(cfg, out_ch, device)])
                             if downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = _conv(cfg, cfg.in_channels, ch[0], 3, device)
        self.down_blocks = nn.ModuleList([
            DownBlock(cfg, ch[max(i - 1, 0)], ch[i], i < len(ch) - 1, device)
            for i in range(len(ch))])
        self.mid_block = MidBlock(cfg, ch[-1], device)
        self.conv_norm_out = _gn(cfg, ch[-1], device)
        self.conv_out = _conv(cfg, ch[-1], 2 * cfg.latent_channels, 3, device)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))  # mean ++ logvar


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = _conv(cfg, cfg.latent_channels, rev[0], 3, device)
        self.mid_block = MidBlock(cfg, rev[0], device)
        self.up_blocks = nn.ModuleList([
            UpBlock(cfg, rev[max(i - 1, 0)], rev[i], i < len(rev) - 1, device)
            for i in range(len(rev))])
        self.conv_norm_out = _gn(cfg, rev[-1], device)
        self.conv_out = _conv(cfg, rev[-1], cfg.out_channels, 3, device)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """decode(latents) and encode(images), NCHW at the API boundary. The
    decoder is registered first, so a seeded ``init_params_`` draws its
    weights as it did before the encoder was added."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg, device)
        self.encoder = Encoder(cfg, device)

    def decode(self, latents):
        """Raw latents (B, C_lat, h, w) -> images (B, 3, H, W) in [-1, 1] approx.

        Callers apply the reference's scaling first:
        ``z = latents / scaling_factor + shift_factor``.
        """
        return self.decoder(latents.to(self.cfg.dtype))

    def encode_moments(self, images):
        """images (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, C_lat, h, w),
        logvar clipped to [-30, 20]."""
        mean, logvar = self.encoder(images.to(self.cfg.dtype)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images, generator=None):
        """The posterior's mode (``generator`` None) or a sample drawn with
        ``generator``, normalised as the reference does: (z - shift) * scaling."""
        mean, logvar = self.encode_moments(images)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor
