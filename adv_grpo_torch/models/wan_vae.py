"""WAN 3D causal video VAE (diffusers ``AutoencoderKLWan``) in PyTorch, fp32.

Port of adv_grpo_tpu/models/wan_vae.py, with diffusers state-dict names
(``encoder.conv_in``, ``encoder.down_blocks.{n}`` a flat list of residual
blocks and resamplers, ``encoder.mid_block``, ``encoder.norm_out``,
``encoder.conv_out``, ``quant_conv``; ``post_quant_conv``,
``decoder.conv_in``, ``decoder.mid_block.{resnets.{0,1},attentions.0}``,
``decoder.up_blocks.{n}``, ``decoder.norm_out``, ``decoder.conv_out``) and
layout: channels first, (B, C, F, H, W), Conv3d weights (O, I, kt, kh, kw),
RMS ``gamma`` (C, 1, 1, 1).

diffusers encodes frame 0 alone, then chunks of 4 frames, and decodes one
latent frame at a time, with a 2-frame cache per causal conv; the JAX model
replaced each cached op by its whole-sequence equivalent, and so does this
one:

  * a causal conv left-pads 2 zero frames (and SAME-pads spatially);
  * the temporal downsample lets frame 0 through untouched and runs its
    stride-2 k=3 time conv over the whole sequence without padding: output
    j >= 1 reads frames 2j-2, 2j-1, 2j; the spatial downsample pads right and
    bottom by one and runs a stride-2 3x3 conv;
  * the temporal upsample zeroes frame 0, runs its time conv over the
    left-padded sequence, drops output 0, splits each 2C-channel output into
    an (earlier, later) frame pair and puts the untouched frame 0 first:
    1 + 2 (T - 1) frames out;
  * ``WanRMSNorm`` is x / max(||x||_C, 1e-12) * sqrt(C) * gamma (no eps inside
    the root).

The decoder runs that whole-sequence form over chunks of latent frames,
diffusers' scheme with longer chunks: each causal conv carries the last two
frames of its (padded) input from one chunk to the next, zeros before the
first; the temporal upsample applies its frame-0 rule in the first chunk
only; norms, per-frame attention and spatial resamples are frame-local. So
every chunking computes the same function. ``WanDecoder3d.chunk_frames``
takes the chunk from the shapes: the longest that keeps every intermediate
under 2^31 elements, spread evenly over the fewest chunks. That count is a
proxy for memory and time, not a limit PyTorch enforces (the whole-sequence
decode ran at 6.2e9 elements); it was chosen because it keeps 33 frames of
480^2 in one chunk and bounds the decode's peak. Up to 33 frames
of 480^2 that is one chunk (1.6e9 elements at most), the whole-sequence
decode; 81 frames of 480^2 take two chunks, of 480x832 three. On an H100
the whole-sequence decode of 81 frames of 480x832 took 11.6 s and 58 GiB
above the weights, the three chunks 8.3 s and 24 GiB (``chip_smoke.py
--wan-decode 81 480 832`` and ``--wan-81``).

The mid blocks' single-head attention is per frame over the H*W tokens. It
runs in fp32 like the JAX model (the JAX package has no Pallas kernel here,
so this is plain torch); ``WanPipeline`` switches TF32 off so the
convolutions stay fp32 on the card. ``encode`` draws its posterior sample
from a ``torch.Generator``, not a JAX key: the same distribution, other
bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """Field names and defaults of the diffusers AutoencoderKLWan config
    (Wan2.1: base 96, z 16, 8x spatial and 4x temporal)."""

    z_dim: int = 16
    base_dim: int = 96
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    # per downsample stage of the encoder; the decoder reads it reversed
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Tuple[float, ...] = (0.0,) * 16
    latents_std: Tuple[float, ...] = (1.0,) * 16
    dtype: Any = torch.float32

    @classmethod
    def wan(cls, **overrides) -> "WanVAEConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "WanVAEConfig":
        defaults = dict(z_dim=4, base_dim=8, dim_mult=(1, 2), temperal_downsample=(True,),
                        num_res_blocks=1, latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temperal_downsample)

    def latent_frames(self, frames: int) -> int:
        """T video frames (T = 1 mod temporal_factor) -> latent frames."""
        return 1 + (frames - 1) // self.temporal_factor


class WanRMSNorm(nn.Module):
    """x / max(||x||_2 over channels, 1e-12) * sqrt(C) * gamma; ``gamma``
    broadcasts over the trailing ``spatial`` dims."""

    def __init__(self, dim: int, spatial: int, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.empty((dim,) + (1,) * spatial, dtype=cfg.dtype,
                                             device=device))

    def forward(self, x):
        return F.normalize(x, dim=1) * self.scale * self.gamma


class WanCausalConv3d(nn.Conv3d):
    """Conv3d causal in time: 2 (kt - 1 = 2 for kt = 3) zero frames on the
    left, SAME spatially, no right time pad. With ``carry`` (a dict shared by
    the chunks of one sequence) the left frames are the last kt - 1 frames
    of the previous chunk's input, zeros before the first chunk."""

    def __init__(self, cin: int, cout: int, kernel, cfg: WanVAEConfig, device=None):
        super().__init__(cin, cout, kernel, dtype=cfg.dtype, device=device)
        kt, kh, kw = self.kernel_size
        self._pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)

    def forward(self, x, carry=None):
        kt1 = self._pad[4]
        if carry is None or not kt1:
            return super().forward(F.pad(x, self._pad) if any(self._pad) else x)
        prev = carry.get(self)
        x = (F.pad(x, self._pad) if prev is None
             else torch.cat([prev, F.pad(x, self._pad[:4])], dim=2))
        carry[self] = x[:, :, -kt1:].clone()
        return super().forward(x)


class WanResBlock(nn.Module):
    """rms -> silu -> conv3 twice, plus the (1x1x1 causal conv) shortcut."""

    def __init__(self, cin: int, cout: int, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.norm1 = WanRMSNorm(cin, 3, cfg, device)
        self.conv1 = WanCausalConv3d(cin, cout, 3, cfg, device)
        self.norm2 = WanRMSNorm(cout, 3, cfg, device)
        self.conv2 = WanCausalConv3d(cout, cout, 3, cfg, device)
        self.conv_shortcut = WanCausalConv3d(cin, cout, 1, cfg, device) if cin != cout else None

    def forward(self, x, carry=None):
        h = x if self.conv_shortcut is None else self.conv_shortcut(x)
        y = self.conv1(F.silu(self.norm1(x)), carry)
        return h + self.conv2(F.silu(self.norm2(y)), carry)


class WanAttnBlock(nn.Module):
    """Per-frame single-head attention over the H*W tokens: rms pre-norm,
    1x1 q/k/v and output projections, fp32 softmax, residual."""

    def __init__(self, dim: int, cfg: WanVAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm = WanRMSNorm(dim, 2, cfg, device)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x, carry=None):
        del carry  # frame-local
        B, C, T, H, W = x.shape
        y = self.norm(x.transpose(1, 2).reshape(B * T, C, H, W))
        tok = y.flatten(2).transpose(1, 2)  # (B*T, H*W, C)
        q, k, v = F.linear(tok, self.to_qkv.weight[:, :, 0, 0], self.to_qkv.bias).chunk(3, -1)
        a = torch.softmax((q @ k.transpose(1, 2)) / C ** 0.5, dim=-1)
        o = F.linear(a @ v, self.proj.weight[:, :, 0, 0], self.proj.bias)
        return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([WanResBlock(dim, dim, cfg, device),
                                      WanResBlock(dim, dim, cfg, device)])
        self.attentions = nn.ModuleList([WanAttnBlock(dim, cfg, device)])

    def forward(self, x, carry=None):
        return self.resnets[1](self.attentions[0](self.resnets[0](x, carry)), carry)


class WanUpsample(nn.Module):
    """diffusers WanResample ``upsample3d`` / ``upsample2d``: (3d) the
    frame-0-bypass time conv doubling the frames, then nearest 2x and a 3x3
    conv halving the channels, per frame."""

    def __init__(self, dim: int, temporal: bool, cfg: WanVAEConfig, device=None):
        super().__init__()
        # index 1 for the diffusers name ``resample.1`` (index 0 is its
        # parameter-free upsampler)
        self.resample = nn.ModuleList([
            nn.Identity(),
            nn.Conv2d(dim, dim // 2, 3, padding=1, dtype=cfg.dtype, device=device)])
        self.time_conv = (WanCausalConv3d(dim, 2 * dim, (3, 1, 1), cfg, device)
                          if temporal else None)

    def forward(self, x, carry=None):
        if self.time_conv is not None:
            B, C, T, H, W = x.shape
            # the chunk that holds frame 0: the sequence's first
            first = carry is None or self.time_conv not in carry
            z = x
            if first:
                z = x.clone()
                z[:, :, 0] = 0.0
            y = self.time_conv(z, carry)[:, :, 1 if first else 0:]
            n = y.shape[2]
            y = y.reshape(B, 2, C, n, H, W).permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * n, H, W)
            x = torch.cat([x[:, :, :1], y], dim=2) if first else y
        conv = self.resample[1]
        x = F.interpolate(x, scale_factor=(1.0, 2.0, 2.0), mode="nearest")
        return F.conv3d(x, conv.weight[:, :, None], conv.bias, padding=(0, 1, 1))


class WanDownsample(nn.Module):
    """diffusers WanResample ``downsample2d`` / ``downsample3d``: per frame,
    pad right and bottom by one and a stride-2 3x3 conv; (3d) then frame 0
    untouched and the stride-2 k=3 time conv over the whole sequence, no
    padding (under 3 frames it has no window: frame 0 alone comes out, as
    from the JAX model's empty VALID conv)."""

    def __init__(self, dim: int, temporal: bool, cfg: WanVAEConfig, device=None):
        super().__init__()
        # index 1 for the diffusers name ``resample.1`` (index 0 is its
        # ZeroPad2d)
        self.resample = nn.ModuleList([
            nn.Identity(),
            nn.Conv2d(dim, dim, 3, stride=2, dtype=cfg.dtype, device=device)])
        self.time_conv = (nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), dtype=cfg.dtype,
                                    device=device) if temporal else None)

    def forward(self, x):
        conv = self.resample[1]
        x = F.conv3d(F.pad(x, (0, 1, 0, 1)), conv.weight[:, :, None], conv.bias,
                     stride=(1, 2, 2))
        if self.time_conv is not None:
            x = (torch.cat([x[:, :, :1], self.time_conv(x)], dim=2) if x.shape[2] >= 3
                 else x[:, :, :1])
        return x


class WanEncoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        mults = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * u for u in (1,) + mults]
        self.conv_in = WanCausalConv3d(3, dims[0], 3, cfg, device)
        blocks, cin, scale = [], dims[0], 1.0
        for i, out_dim in enumerate(dims[1:]):
            for _ in range(cfg.num_res_blocks):
                blocks.append(WanResBlock(cin, out_dim, cfg, device))
                cin = out_dim
                if scale in cfg.attn_scales:
                    blocks.append(WanAttnBlock(out_dim, cfg, device))
            if i != len(mults) - 1:
                blocks.append(WanDownsample(out_dim, cfg.temperal_downsample[i], cfg, device))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(cin, cfg, device)
        self.norm_out = WanRMSNorm(cin, 3, cfg, device)
        self.conv_out = WanCausalConv3d(cin, 2 * cfg.z_dim, 3, cfg, device)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(self.mid_block(x))))


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        mults = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * u for u in (mults[-1],) + mults[::-1]]
        t_up = tuple(cfg.temperal_downsample)[::-1]
        self.conv_in = WanCausalConv3d(cfg.z_dim, dims[0], 3, cfg, device)
        self.mid_block = WanMidBlock(dims[0], cfg, device)
        blocks, cin, scale = [], dims[0], 1.0 / 2 ** (len(mults) - 2)
        for i, out_dim in enumerate(dims[1:]):
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(WanResBlock(cin, out_dim, cfg, device))
                cin = out_dim
                if scale in cfg.attn_scales:
                    blocks.append(WanAttnBlock(out_dim, cfg, device))
            if i != len(mults) - 1:
                blocks.append(WanUpsample(out_dim, t_up[i], cfg, device))
                cin = out_dim // 2
                scale *= 2.0
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(cin, 3, cfg, device)
        self.conv_out = WanCausalConv3d(cin, 3, 3, cfg, device)

    def forward(self, x, chunk=None):
        """(B, z, T, h, w) -> (B, 3, 1 + tf (T - 1), H, W), decoded over
        chunks of ``chunk`` latent frames (by default ``chunk_frames``)."""
        T = x.shape[2]
        chunk = chunk or self.chunk_frames(x.shape)
        carry = {} if chunk < T else None
        outs = []
        for t0 in range(0, T, chunk):
            h = self.mid_block(self.conv_in(x[:, :, t0:t0 + chunk], carry), carry)
            for block in self.up_blocks:
                h = block(h, carry)
            outs.append(self.conv_out(F.silu(self.norm_out(h)), carry))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

    def chunk_frames(self, shape) -> int:
        """The latent frames of a chunk for (B, z, T, h, w) latents: as many
        as keep every intermediate of a chunk under 2^31 elements, spread
        evenly over the fewest chunks. 2^31 elements is a proxy for the
        decode's memory and time, chosen because it keeps 33 frames of 480^2
        in one chunk (the whole-sequence decode) and cuts the peak at 81
        frames; PyTorch does not enforce it."""
        B, _, T, h, w = shape
        n = 1
        while n < T and self._largest(B, -(-T // n), h, w) >= 2 ** 31:
            n += 1
        return -(-T // n)

    def _largest(self, B, c, h, w) -> int:
        """Elements of the largest tensor a chunk of ``c`` latent frames makes
        (a later chunk's frame count, the 2 carried frames and the spatial
        pad included)."""
        def padded(ch, f, h, w):
            return ch * (f + 2) * (h + 2) * (w + 2)

        f, cin = c, self.conv_in.in_channels
        sizes = [padded(cin, f, h, w)]
        for block in [*self.mid_block.resnets, *self.mid_block.attentions, *self.up_blocks]:
            if isinstance(block, WanResBlock):
                sizes.append(padded(max(block.conv1.in_channels, block.conv1.out_channels),
                                    f, h, w))
                cin = block.conv1.out_channels
            elif isinstance(block, WanAttnBlock):
                sizes += [f * (h * w) ** 2, 3 * cin * f * h * w]
            elif isinstance(block, WanUpsample):
                if block.time_conv is not None:
                    sizes.append(padded(2 * cin, f, h, w))
                    f *= 2
                h, w = 2 * h, 2 * w
                sizes.append(cin * f * h * w)  # the nearest upsample's output
                cin //= 2
            else:
                raise TypeError(f"no size model for decoder block {type(block).__name__}")
        sizes.append(padded(cin, f, h, w))
        return B * max(sizes)


class WanVideoVAE(nn.Module):
    """The JAX ``WanVideoVAE``: ``encode`` returns the sampler's normalised
    latents, (mean - mu) / sigma, and ``decode`` takes them (denormalising
    with the per-channel stats first); ``encode_raw`` and ``decode_raw``
    speak the checkpoint's latent space. The encoder is registered after the
    decoder, so ``init_params_`` draws the decoder's bits first."""

    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = WanCausalConv3d(cfg.z_dim, cfg.z_dim, 1, cfg, device)
        self.decoder = WanDecoder3d(cfg, device)
        self.encoder = WanEncoder3d(cfg, device)
        self.quant_conv = WanCausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1, cfg, device)

    def _stats(self, device):
        c = self.cfg
        shape = (1, c.z_dim, 1, 1, 1)
        mu = torch.tensor(c.latents_mean, dtype=torch.float32, device=device)
        std = torch.tensor(c.latents_std, dtype=torch.float32, device=device)
        return mu.reshape(shape), std.reshape(shape)

    def encode_raw(self, videos):
        """videos (B, 3, F, H, W) in [-1, 1], F = 1 mod the temporal factor ->
        (mean, logvar), each (B, z, F', H/8, W/8) fp32, in the checkpoint's
        latent space; logvar clipped to [-30, 20]."""
        x = self.quant_conv(self.encoder(videos.to(self.cfg.dtype))).float()
        mean, logvar = x.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, videos, generator: torch.Generator = None):
        """Normalised latents: the posterior mean, or with ``generator`` a
        sample mean + exp(logvar / 2) * N(0, 1), then (x - mu) / sigma."""
        mean, logvar = self.encode_raw(videos)
        if generator is not None:
            mean = mean + torch.exp(0.5 * logvar) * torch.randn(
                mean.shape, generator=generator, device=mean.device, dtype=torch.float32)
        mu, std = self._stats(mean.device)
        return (mean - mu) / std

    def decode_raw(self, latents):
        """(B, z, F', H', W') checkpoint-space latents -> video (B, 3, F, H, W)
        clipped to [-1, 1]."""
        x = self.decoder(self.post_quant_conv(latents.to(self.cfg.dtype)))
        return x.float().clamp(-1.0, 1.0)

    def decode(self, latents):
        mu, std = self._stats(latents.device)
        return self.decode_raw(latents.float() * std + mu)
