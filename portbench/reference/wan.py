"""Wan2.1's text-to-video transformer, its 3D causal VAE decoder and the
WAN Flow-SDE sampler, plain.

Written from the published architecture (diffusers ``WanTransformer3DModel``:
patch (1, 2, 2), 3-axis RoPE on interleaved pairs, RMS qk-norm across all
heads, an affine LayerNorm before the cross-attention, per-block modulation
tables; ``AutoencoderKLWan``: causal 3x3x3 convolutions, RMS norms, per-frame
attention, the frame-0-preserving temporal upsample) over a dict of named
fp32 tensors. The VAE decodes the whole sequence at once. Attention runs a
block of query rows at a time; under autograd each block is recomputed in
the backward, so the scores of 19k-token rows never sit in memory whole.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import FP32, Precision
from portbench.reference.sd3 import _dtype, _ln, _time_embed

EPS = 1e-6
Q_BLOCK = 2048


def transformer_spec(cfg: dict):
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    pt, ph, pw = cfg["patch_size"]
    C, r = cfg["in_channels"], cfg["lora"]["rank"]
    bf, f32 = _dtype(cfg["compute_dtype"]), torch.float32
    out = []

    def lin(name, i, o, lora=False):
        out.extend([(f"{name}.weight", (o, i), bf), (f"{name}.bias", (o,), bf)])
        if lora and r:
            out.extend([(f"{name}.lora_a", (i, r), f32), (f"{name}.lora_b", (r, o), f32)])

    out.extend([("patch_embedding.weight", (D, C, pt, ph, pw), bf),
                ("patch_embedding.bias", (D,), bf)])
    ce = "condition_embedder"
    lin(f"{ce}.time_embedder.linear_1", 256, D)
    lin(f"{ce}.time_embedder.linear_2", D, D)
    lin(f"{ce}.time_proj", D, 6 * D)
    lin(f"{ce}.text_embedder.linear_1", cfg["text_dim"], D)
    lin(f"{ce}.text_embedder.linear_2", D, D)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{b}.{a}.{n}", D, D, lora=True)
            out.extend([(f"{b}.{a}.norm_q.weight", (D,), f32),
                        (f"{b}.{a}.norm_k.weight", (D,), f32)])
        if cfg["cross_attn_norm"]:
            out.extend([(f"{b}.norm2.weight", (D,), f32), (f"{b}.norm2.bias", (D,), f32)])
        lin(f"{b}.ffn.net.0.proj", D, cfg["ffn_dim"])
        lin(f"{b}.ffn.net.2", cfg["ffn_dim"], D)
        out.append((f"{b}.scale_shift_table", (1, 6, D), f32))
    out.append(("scale_shift_table", (1, 2, D), f32))
    lin("proj_out", D, pt * ph * pw * cfg["out_channels"])
    return out


def vae_decoder_spec(v: dict):
    """The decoder and ``post_quant_conv`` of AutoencoderKLWan."""
    f32 = torch.float32
    out = []

    def conv(name, cin, cout, k):
        out.extend([(f"{name}.weight", (cout, cin) + tuple(k), f32),
                    (f"{name}.bias", (cout,), f32)])

    def rms(name, ch, spatial=3):
        out.append((f"{name}.gamma", (ch,) + (1,) * spatial, f32))

    def res(name, cin, cout):
        rms(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, (3, 3, 3))
        rms(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, (3, 3, 3))
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, (1, 1, 1))

    z = v["z_dim"]
    conv("post_quant_conv", z, z, (1, 1, 1))
    mults = list(v["dim_mult"])
    dims = [v["base_dim"] * u for u in [mults[-1]] + mults[::-1]]
    t_up = list(v["temperal_downsample"])[::-1]
    d = "decoder"
    conv(f"{d}.conv_in", z, dims[0], (3, 3, 3))
    res(f"{d}.mid_block.resnets.0", dims[0], dims[0])
    rms(f"{d}.mid_block.attentions.0.norm", dims[0], 2)
    conv(f"{d}.mid_block.attentions.0.to_qkv", dims[0], 3 * dims[0], (1, 1))
    conv(f"{d}.mid_block.attentions.0.proj", dims[0], dims[0], (1, 1))
    res(f"{d}.mid_block.resnets.1", dims[0], dims[0])
    n, cin = 0, dims[0]
    for i, od in enumerate(dims[1:]):
        for _ in range(v["num_res_blocks"] + 1):
            res(f"{d}.up_blocks.{n}", cin, od)
            n, cin = n + 1, od
        if i != len(mults) - 1:
            conv(f"{d}.up_blocks.{n}.resample.1", od, od // 2, (3, 3))
            if t_up[i]:
                conv(f"{d}.up_blocks.{n}.time_conv", od, 2 * od, (3, 1, 1))
            n, cin = n + 1, od // 2
    rms(f"{d}.norm_out", cin)
    conv(f"{d}.conv_out", cin, 3, (3, 3, 3))
    return out


# ── the transformer ────────────────────────────────────────────────────────


def rope_angles(f: int, gh: int, gw: int, axes) -> np.ndarray:
    """(f*gh*gw, head_dim/2) angles: per axis (frame, row, col), position x
    10000^(-i/half)."""
    t, h, w = np.meshgrid(np.arange(f), np.arange(gh), np.arange(gw), indexing="ij")
    ids = np.stack([t, h, w], -1).reshape(-1, 3)
    outs = []
    for axis, dim in enumerate(axes):
        half = dim // 2
        outs.append(np.outer(ids[:, axis].astype(np.float64),
                             1.0 / (10000 ** (np.arange(half) / half))))
    return np.concatenate(outs, -1).astype(np.float32)


def _rope(x, cos, sin, heads):
    b, s, dd = x.shape
    xf = x.reshape(b, s, heads, dd // heads // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c, sn = cos[None, :, None], sin[None, :, None]
    return torch.stack([x1 * c - x2 * sn, x1 * sn + x2 * c], -1).reshape(b, s, dd)


def _rms(x, w):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + EPS) * w


def _attn_rows(q, k, v, prec: Precision):
    """(B, H, s, d) queries against all keys."""
    s = (prec.operand(q) @ prec.operand(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    return prec.operand(torch.softmax(s, -1)) @ prec.operand(v)


def attention(q, k, v, heads, prec: Precision):
    b, sq, dd = q.shape
    d = dd // heads
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, d).transpose(1, 2)
    outs = []
    for i in range(0, sq, Q_BLOCK):
        qb = qh[:, :, i:i + Q_BLOCK]
        if torch.is_grad_enabled() and qb.requires_grad:
            outs.append(checkpoint(_attn_rows, qb, kh, vh, prec, use_reentrant=False))
        else:
            outs.append(_attn_rows(qb, kh, vh, prec))
    return torch.cat(outs, 2).transpose(1, 2).reshape(b, sq, dd)


class WanTransformer:
    """forward(latents (B, C, F, H, W), t (B,), text (B, S, text_dim)) ->
    velocity (B, C, F, H, W), fp32; ``lora`` as for the MMDiT."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], prec: Precision = FP32):
        self.cfg, self.prec = cfg, prec
        self.w = {k: v.float() for k, v in weights.items()
                  if not k.endswith(("lora_a", "lora_b"))}
        self.heads = cfg["num_attention_heads"]
        self.scaling = cfg["lora"]["alpha"] / cfg["lora"]["rank"]

    def _lin(self, name, x, lora=None):
        y = self.prec.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))
        if lora is not None and name in lora:
            a, bb = lora[name]
            y = y + self.scaling * self.prec.linear(self.prec.linear(x, a.t()), bb.t())
        return y

    def block(self, i, x, text, temb6, cos, sin, lora):
        H, b = self.heads, f"blocks.{i}"
        table = self.w[f"{b}.scale_shift_table"][0]
        sh_sa, sc_sa, g_sa, sh_ff, sc_ff, g_ff = (table[j] + temb6[j] for j in range(6))
        a = f"{b}.attn1"
        h = _ln(x) * (1 + sc_sa[:, None]) + sh_sa[:, None]
        q = _rope(_rms(self._lin(f"{a}.to_q", h, lora), self.w[f"{a}.norm_q.weight"]), cos, sin, H)
        k = _rope(_rms(self._lin(f"{a}.to_k", h, lora), self.w[f"{a}.norm_k.weight"]), cos, sin, H)
        o = attention(q, k, self._lin(f"{a}.to_v", h, lora), H, self.prec)
        x = x + g_sa[:, None] * self._lin(f"{a}.to_out.0", o, lora)
        a = f"{b}.attn2"
        hq = _ln(x)
        if self.cfg["cross_attn_norm"]:
            hq = hq * self.w[f"{b}.norm2.weight"] + self.w[f"{b}.norm2.bias"]
        q = _rms(self._lin(f"{a}.to_q", hq, lora), self.w[f"{a}.norm_q.weight"])
        k = _rms(self._lin(f"{a}.to_k", text, lora), self.w[f"{a}.norm_k.weight"])
        o = attention(q, k, self._lin(f"{a}.to_v", text, lora), H, self.prec)
        x = x + self._lin(f"{a}.to_out.0", o, lora)
        h = _ln(x) * (1 + sc_ff[:, None]) + sh_ff[:, None]
        h = F.gelu(self._lin(f"{b}.ffn.net.0.proj", h), approximate="tanh")
        return x + g_ff[:, None] * self._lin(f"{b}.ffn.net.2", h)

    def forward(self, latents, t, text, lora=None):
        c = self.cfg
        pt, ph, pw = c["patch_size"]
        B, C, Fr, Hh, Ww = latents.shape
        f, gh, gw = Fr // pt, Hh // ph, Ww // pw
        D = self.heads * c["attention_head_dim"]
        x = latents.float().reshape(B, C, f, pt, gh, ph, gw, pw).permute(0, 2, 4, 6, 3, 5, 7, 1)
        x = x.reshape(B, f * gh * gw, pt * ph * pw * C)
        w = self.w["patch_embedding.weight"].permute(0, 2, 3, 4, 1).reshape(D, -1)
        x = self.prec.linear(x, w, self.w["patch_embedding.bias"])
        ce = "condition_embedder"
        txt = self._lin(f"{ce}.text_embedder.linear_2", F.gelu(
            self._lin(f"{ce}.text_embedder.linear_1", text.float()), approximate="tanh"))
        t_emb = self._lin(f"{ce}.time_embedder.linear_2",
                          F.silu(self._lin(f"{ce}.time_embedder.linear_1", _time_embed(t))))
        temb6 = self._lin(f"{ce}.time_proj", F.silu(t_emb)).chunk(6, -1)
        ang = torch.from_numpy(rope_angles(f, gh, gw, c["rope_axes_dims"])).to(latents.device)
        cos, sin = torch.cos(ang), torch.sin(ang)
        for i in range(c["num_layers"]):
            if torch.is_grad_enabled():
                x = checkpoint(self.block, i, x, txt, temb6, cos, sin, lora, use_reentrant=False)
            else:
                x = self.block(i, x, txt, temb6, cos, sin, lora)
        table = self.w["scale_shift_table"][0]
        shift, scale = table[0] + t_emb, table[1] + t_emb
        x = self._lin("proj_out", _ln(x) * (1 + scale[:, None]) + shift[:, None])
        x = x.reshape(B, f, gh, gw, pt, ph, pw, c["out_channels"])
        return x.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(B, c["out_channels"], Fr, Hh, Ww)


# ── the VAE decoder ────────────────────────────────────────────────────────


class WanVAEDecoder:
    """Normalised latents (B, z, T, h, w) -> video (B, 3, 1 + 4 (T - 1), 8h,
    8w) in [-1, 1]: denormalised by the published per-channel statistics,
    then the causal decoder over the whole sequence."""

    def __init__(self, v: dict, weights: Dict[str, torch.Tensor], prec: Precision = FP32):
        self.v, self.w, self.prec = v, weights, prec

    def _cconv(self, name, x):
        """Causal in time: kt - 1 zero frames on the left; SAME in space."""
        w = self.w[f"{name}.weight"]
        kt, kh, kw = w.shape[2:]
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0))
        return F.conv3d(x, w, self.w[f"{name}.bias"])

    def _rms(self, name, x):
        return F.normalize(x, dim=1) * math.sqrt(x.shape[1]) * self.w[f"{name}.gamma"]

    def _res(self, name, x):
        h = x if f"{name}.conv_shortcut.weight" not in self.w else self._cconv(
            f"{name}.conv_shortcut", x)
        y = self._cconv(f"{name}.conv1", F.silu(self._rms(f"{name}.norm1", x)))
        return h + self._cconv(f"{name}.conv2", F.silu(self._rms(f"{name}.norm2", y)))

    def _attn(self, name, x):
        B, C, T, H, W = x.shape
        y = self._rms(f"{name}.norm", x.transpose(1, 2).reshape(B * T, C, H, W))
        tok = y.flatten(2).transpose(1, 2)
        q, k, v = F.linear(tok, self.w[f"{name}.to_qkv.weight"][:, :, 0, 0],
                           self.w[f"{name}.to_qkv.bias"]).chunk(3, -1)
        o = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), -1) @ v
        o = F.linear(o, self.w[f"{name}.proj.weight"][:, :, 0, 0], self.w[f"{name}.proj.bias"])
        return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)

    def _up(self, name, x):
        if f"{name}.time_conv.weight" in self.w:
            B, C, T, H, W = x.shape
            z = x.clone()
            z[:, :, 0] = 0.0
            y = self._cconv(f"{name}.time_conv", z)[:, :, 1:]
            n = y.shape[2]
            y = y.reshape(B, 2, C, n, H, W).permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * n, H, W)
            x = torch.cat([x[:, :, :1], y], 2)
        x = F.interpolate(x, scale_factor=(1.0, 2.0, 2.0), mode="nearest")
        return F.conv3d(x, self.w[f"{name}.resample.1.weight"][:, :, None],
                        self.w[f"{name}.resample.1.bias"], padding=(0, 1, 1))

    @torch.no_grad()
    def __call__(self, latents):
        v = self.v
        with self.prec.tf32_scope():
            mu = torch.tensor(v["latents_mean"], device=latents.device).view(1, -1, 1, 1, 1)
            std = torch.tensor(v["latents_std"], device=latents.device).view(1, -1, 1, 1, 1)
            x = self._cconv("post_quant_conv", latents.float() * std + mu)
            d = "decoder"
            x = self._res(f"{d}.mid_block.resnets.0", self._cconv(f"{d}.conv_in", x))
            x = self._res(f"{d}.mid_block.resnets.1", self._attn(f"{d}.mid_block.attentions.0", x))
            n = 0
            while f"{d}.up_blocks.{n}.resample.1.weight" in self.w or \
                    f"{d}.up_blocks.{n}.conv1.weight" in self.w:
                name = f"{d}.up_blocks.{n}"
                x = self._up(name, x) if f"{name}.resample.1.weight" in self.w else \
                    self._res(name, x)
                n += 1
            x = self._cconv(f"{d}.conv_out", F.silu(self._rms(f"{d}.norm_out", x)))
            return x.clamp(-1.0, 1.0)


# ── the sampler ────────────────────────────────────────────────────────────


def unipc_flow_sigmas(n: int, shift: float = 3.0, ntt: int = 1000):
    """(sigmas (n+1,), timesteps (n,)) of diffusers' UniPCMultistepScheduler
    with flow sigmas: alphas = linspace(1, 1/T, n+1), sigma = shift s / (1 +
    (shift-1) s) of s = 1 - alpha, reversed, the last dropped, timesteps
    floor(sigma T), a terminal 0 appended."""
    alphas = np.linspace(1.0, 1.0 / ntt, n + 1, dtype=np.float64)
    base = 1.0 - alphas
    sig = np.flip(shift * base / (1.0 + (shift - 1.0) * base))[:-1]
    ts = np.floor(sig * ntt).astype(np.float32)
    return np.concatenate([sig, [0.0]]).astype(np.float32), ts


def wan_step(v, x, sigma, sigma_prev, sigma_min, sigma_max, noise=None, prev=None):
    """The WAN Flow-SDE transition and its Gaussian log-probability (mean
    over a sample's elements): (next, log-prob (B,), mean)."""
    dt = sigma_prev - sigma
    std = sigma_min + (sigma_max - sigma_min) * sigma
    mean = (x * (1 + std ** 2 / (2 * sigma) * dt)
            + v * (1 + std ** 2 * (1 - sigma) / (2 * sigma)) * dt)
    step_std = std * math.sqrt(-dt)
    if prev is None:
        prev = mean + step_std * noise
    lp = (-((prev.detach() - mean) ** 2) / (2 * step_std ** 2) - math.log(step_std)
          - math.log(math.sqrt(2 * math.pi)))
    return prev, lp.mean(dim=tuple(range(1, x.ndim))), mean
