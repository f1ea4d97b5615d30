"""SD3.5-Medium's MMDiT-X, its VAE decoder and the Flow-CPS sampler, plain.

Written from the published architecture (diffusers ``SD3Transformer2DModel``
with ``dual_attention_layers`` and ``qk_norm="rms_norm"``, ``AutoencoderKL``,
the flow-match Euler schedule with shift 3) over a dict of named fp32
tensors. Attention is softmax(q k^T / sqrt(d)) v on whole rows; callers keep
the batch small enough for the scores to fit.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import FP32, Precision

EPS = 1e-6


# ── parameter names and shapes ─────────────────────────────────────────────


def transformer_spec(cfg: dict):
    """(name, shape, dtype) of every MMDiT parameter, in the diffusers names
    (the LoRA factors A (in, r) and B (r, out) beside each joint projection)."""
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    hd = cfg["attention_head_dim"]
    p, C = cfg["patch_size"], cfg["in_channels"]
    r = cfg["lora"]["rank"]
    bf = _dtype(cfg["compute_dtype"])
    f32 = torch.float32
    out = []

    def lin(name, i, o, dt=bf, bias=True, lora=False):
        out.append((f"{name}.weight", (o, i), dt))
        if bias:
            out.append((f"{name}.bias", (o,), dt))
        if lora and r:
            out.append((f"{name}.lora_a", (i, r), f32))
            out.append((f"{name}.lora_b", (r, o), f32))

    out.append(("pos_embed.proj.weight", (D, C, p, p), bf))
    out.append(("pos_embed.proj.bias", (D,), bf))
    lin("time_text_embed.timestep_embedder.linear_1", 256, D)
    lin("time_text_embed.timestep_embedder.linear_2", D, D)
    lin("time_text_embed.text_embedder.linear_1", cfg["pooled_projection_dim"], D)
    lin("time_text_embed.text_embedder.linear_2", D, D)
    lin("context_embedder", cfg["joint_attention_dim"], D)
    L = cfg["num_layers"]
    for i in range(L):
        b = f"transformer_blocks.{i}"
        dual = i in cfg["dual_attention_layers"]
        last = i == L - 1
        lin(f"{b}.norm1.linear", D, (9 if dual else 6) * D)
        lin(f"{b}.norm1_context.linear", D, (2 if last else 6) * D)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"):
            lin(f"{b}.attn.{n}", D, D, lora=True)
        if not last:
            lin(f"{b}.attn.to_add_out", D, D, lora=True)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            out.append((f"{b}.attn.{n}.weight", (hd,), f32))
        if dual:
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{b}.attn2.{n}", D, D)
            for n in ("norm_q", "norm_k"):
                out.append((f"{b}.attn2.{n}.weight", (hd,), f32))
        lin(f"{b}.ff.net.0.proj", D, 4 * D)
        lin(f"{b}.ff.net.2", 4 * D, D)
        if not last:
            lin(f"{b}.ff_context.net.0.proj", D, 4 * D)
            lin(f"{b}.ff_context.net.2", 4 * D, D)
    lin("norm_out.linear", D, 2 * D)
    lin("proj_out", D, p * p * cfg["out_channels"])
    return out


def vae_decoder_spec(vcfg: dict):
    """(name, shape, dtype) of the AutoencoderKL decoder, prefixed ``decoder.``."""
    f32 = torch.float32
    out = []
    rev = list(reversed(vcfg["block_out_channels"]))

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), f32))
        out.append((f"{name}.bias", (cout,), f32))

    def gn(name, ch):
        out.append((f"{name}.weight", (ch,), f32))
        out.append((f"{name}.bias", (ch,), f32))

    def resnet(name, cin, cout):
        gn(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        gn(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, 1)

    d = "decoder"
    conv(f"{d}.conv_in", vcfg["latent_channels"], rev[0], 3)
    resnet(f"{d}.mid_block.resnets.0", rev[0], rev[0])
    gn(f"{d}.mid_block.attentions.0.group_norm", rev[0])
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        out.append((f"{d}.mid_block.attentions.0.{n}.weight", (rev[0], rev[0]), f32))
        out.append((f"{d}.mid_block.attentions.0.{n}.bias", (rev[0],), f32))
    resnet(f"{d}.mid_block.resnets.1", rev[0], rev[0])
    for i, ch in enumerate(rev):
        cin = rev[max(i - 1, 0)]
        for j in range(vcfg["layers_per_block"] + 1):
            resnet(f"{d}.up_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
        if i < len(rev) - 1:
            conv(f"{d}.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    gn(f"{d}.conv_norm_out", rev[-1])
    conv(f"{d}.conv_out", rev[-1], vcfg["out_channels"], 3)
    return out


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ── the transformer ────────────────────────────────────────────────────────


def _ln(x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def _modulate(x, scale, shift):
    return _ln(x) * (1.0 + scale[:, None]) + shift[:, None]


def _rms_heads(x, w, heads):
    b, s, dd = x.shape
    xh = x.reshape(b, s, heads, dd // heads)
    xh = xh / torch.sqrt((xh * xh).mean(-1, keepdim=True) + EPS) * w
    return xh.reshape(b, s, dd)


def _attention(q, k, v, heads, prec: Precision):
    """(B, S, H*d) -> (B, S, H*d): softmax over all keys, scale d^-0.5."""
    b, s, dd = q.shape
    d = dd // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = (prec.operand(qh) @ prec.operand(kh).transpose(-1, -2)) * d ** -0.5
    p = torch.softmax(scores, dim=-1)
    o = prec.operand(p) @ prec.operand(vh)
    return o.transpose(1, 2).reshape(b, s, dd)


def _sincos_pos(D: int, max_size: int, gh: int, gw: int) -> np.ndarray:
    """diffusers' 2-D sincos table [sincos(col), sincos(row)], centre-cropped."""
    top, left = (max_size - gh) // 2, (max_size - gw) // 2
    rows = np.arange(top, top + gh, dtype=np.float64)
    cols = np.arange(left, left + gw, dtype=np.float64)

    def one(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    hh, ww = np.meshgrid(rows, cols, indexing="ij")
    tab = np.concatenate([one(D // 2, ww), one(D // 2, hh)], axis=1)
    return tab.reshape(1, gh * gw, D).astype(np.float32)


def _time_embed(t, dim=256):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                          device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


class MMDiT:
    """forward(latents (B, C, h, w), t (B,), text (B, S, 4096), pooled (B,
    2048)) -> velocity (B, C, h, w), all fp32. ``lora`` maps a projection's
    name to its (A, B) factors (tensors that may require grad)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], prec: Precision = FP32):
        self.cfg = cfg
        self.w = {k: v.float() for k, v in weights.items()
                  if not k.endswith(("lora_a", "lora_b"))}
        self.prec = prec
        self.heads = cfg["num_attention_heads"]
        self.scaling = cfg["lora"]["alpha"] / cfg["lora"]["rank"]
        self._pos = {}

    def _lin(self, name, x, lora=None):
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        y = self.prec.linear(x, w, b)
        if lora is not None and name in lora:
            a, bb = lora[name]
            y = y + self.scaling * self.prec.linear(self.prec.linear(x, a.t()), bb.t())
        return y

    def _ff(self, name, x):
        h = F.gelu(self._lin(f"{name}.net.0.proj", x), approximate="tanh")
        return self._lin(f"{name}.net.2", h)

    def forward(self, latents, t, text, pooled, lora=None):
        cfg, H = self.cfg, self.heads
        p, C = cfg["patch_size"], cfg["in_channels"]
        B, _, h, w = latents.shape
        gh, gw = h // p, w // p
        D = H * cfg["attention_head_dim"]
        x = latents.float().reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        x = x.reshape(B, gh * gw, p * p * C)
        wt = self.w["pos_embed.proj.weight"].permute(0, 2, 3, 1).reshape(D, p * p * C)
        x = self.prec.linear(x, wt, self.w["pos_embed.proj.bias"])
        key = (gh, gw, latents.device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(_sincos_pos(D, cfg["pos_embed_max_size"], gh,
                                                          gw)).to(latents.device)
        x = x + self._pos[key]
        te = "time_text_embed"
        temb = (self._lin(f"{te}.timestep_embedder.linear_2",
                          F.silu(self._lin(f"{te}.timestep_embedder.linear_1", _time_embed(t))))
                + self._lin(f"{te}.text_embedder.linear_2",
                            F.silu(self._lin(f"{te}.text_embedder.linear_1", pooled.float()))))
        ctx = self._lin("context_embedder", text.float())
        for i in range(cfg["num_layers"]):
            x, ctx = self.block(i, x, ctx, temb, lora)
        oscale, oshift = self._lin("norm_out.linear", F.silu(temb)).chunk(2, dim=-1)
        x = self._lin("proj_out", _modulate(x, oscale, oshift))
        x = x.reshape(B, gh, gw, p, p, cfg["out_channels"])
        return x.permute(0, 5, 1, 3, 2, 4).reshape(B, cfg["out_channels"], h, w)

    def block(self, i, x, ctx, temb, lora):
        """One joint block (with SD3.5's second image self-attention where
        ``i`` is a dual-attention layer; the last block updates no text)."""
        cfg, H = self.cfg, self.heads
        b = f"transformer_blocks.{i}"
        dual = i in cfg["dual_attention_layers"]
        last = i == cfg["num_layers"] - 1
        st = F.silu(temb)
        mods = self._lin(f"{b}.norm1.linear", st).chunk(9 if dual else 6, dim=-1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:6]
        x_pre = x
        x_mod = _modulate(x, scale_msa, shift_msa)
        cm = self._lin(f"{b}.norm1_context.linear", st)
        if last:
            cscale, cshift = cm.chunk(2, dim=-1)
            ctx_mod = _modulate(ctx, cscale, cshift)
        else:
            c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                cm.chunk(6, dim=-1)
            ctx_mod = _modulate(ctx, c_scale_msa, c_shift_msa)

        a = f"{b}.attn"
        q, k, v = (self._lin(f"{a}.{n}", x_mod, lora) for n in ("to_q", "to_k", "to_v"))
        cq, ck, cv = (self._lin(f"{a}.{n}", ctx_mod, lora)
                      for n in ("add_q_proj", "add_k_proj", "add_v_proj"))
        q = _rms_heads(q, self.w[f"{a}.norm_q.weight"], H)
        k = _rms_heads(k, self.w[f"{a}.norm_k.weight"], H)
        cq = _rms_heads(cq, self.w[f"{a}.norm_added_q.weight"], H)
        ck = _rms_heads(ck, self.w[f"{a}.norm_added_k.weight"], H)
        s_img = x.shape[1]
        o = _attention(torch.cat([q, cq], 1), torch.cat([k, ck], 1), torch.cat([v, cv], 1),
                       H, self.prec)
        x = x + gate_msa[:, None] * self._lin(f"{a}.to_out.0", o[:, :s_img], lora)
        if dual:
            shift2, scale2, gate2 = mods[6:]
            h2 = _modulate(x_pre, scale2, shift2)
            a2 = f"{b}.attn2"
            q2 = _rms_heads(self._lin(f"{a2}.to_q", h2), self.w[f"{a2}.norm_q.weight"], H)
            k2 = _rms_heads(self._lin(f"{a2}.to_k", h2), self.w[f"{a2}.norm_k.weight"], H)
            o2 = _attention(q2, k2, self._lin(f"{a2}.to_v", h2), H, self.prec)
            x = x + gate2[:, None] * self._lin(f"{a2}.to_out.0", o2)
        x = x + gate_mlp[:, None] * self._ff(f"{b}.ff", _modulate(x, scale_mlp, shift_mlp))
        if last:
            return x, None
        ctx = ctx + c_gate_msa[:, None] * self._lin(f"{a}.to_add_out", o[:, s_img:], lora)
        ctx = ctx + c_gate_mlp[:, None] * self._ff(f"{b}.ff_context",
                                                   _modulate(ctx, c_scale_mlp, c_shift_mlp))
        return x, ctx


def lora_factors(weights: Dict[str, torch.Tensor]):
    """{projection name: (A, B)} of the LoRA factors in ``weights``, fp32."""
    out = {}
    for k, v in weights.items():
        if k.endswith(".lora_a"):
            base = k[: -len(".lora_a")]
            out[base] = (v.float(), weights[base + ".lora_b"].float())
    return out


# ── the VAE decoder ────────────────────────────────────────────────────────


class VAEDecoder:
    """Latents (B, 16, h, w) -> images (B, 3, 8h, 8w); the raw latents are
    unscaled first as the SD3 pipeline does: z / scaling + shift."""

    def __init__(self, vcfg: dict, weights: Dict[str, torch.Tensor], prec: Precision = FP32):
        self.cfg, self.w, self.prec = vcfg, weights, prec

    def _conv(self, name, x, padding=1):
        return F.conv2d(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"], padding=padding)

    def _gn(self, name, x):
        return F.group_norm(x, self.cfg["norm_num_groups"], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], eps=1e-6)

    def _resnet(self, name, x):
        h = self._conv(f"{name}.conv1", F.silu(self._gn(f"{name}.norm1", x)))
        h = self._conv(f"{name}.conv2", F.silu(self._gn(f"{name}.norm2", h)))
        if f"{name}.conv_shortcut.weight" in self.w:
            x = self._conv(f"{name}.conv_shortcut", x, padding=0)
        return x + h

    def _attn(self, name, x):
        B, C, H, W = x.shape
        h = self._gn(f"{name}.group_norm", x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = (F.linear(h, self.w[f"{name}.{n}.weight"], self.w[f"{name}.{n}.bias"])
                   for n in ("to_q", "to_k", "to_v"))
        p = torch.softmax(q @ k.transpose(1, 2) * C ** -0.5, dim=-1)
        o = F.linear(p @ v, self.w[f"{name}.to_out.0.weight"], self.w[f"{name}.to_out.0.bias"])
        return x + o.transpose(1, 2).reshape(B, C, H, W)

    def __call__(self, latents):
        c = self.cfg
        with self.prec.tf32_scope():
            z = latents.float() / c["scaling_factor"] + c["shift_factor"]
            d = "decoder"
            h = self._conv(f"{d}.conv_in", z)
            h = self._resnet(f"{d}.mid_block.resnets.0", h)
            h = self._attn(f"{d}.mid_block.attentions.0", h)
            h = self._resnet(f"{d}.mid_block.resnets.1", h)
            n_up = len(c["block_out_channels"])
            for i in range(n_up):
                for j in range(c["layers_per_block"] + 1):
                    h = self._resnet(f"{d}.up_blocks.{i}.resnets.{j}", h)
                if i < n_up - 1:
                    h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                    h = self._conv(f"{d}.up_blocks.{i}.upsamplers.0.conv", h)
            h = F.silu(self._gn(f"{d}.conv_norm_out", h))
            return self._conv(f"{d}.conv_out", h)


# ── the sampler ────────────────────────────────────────────────────────────


def flow_match_sigmas(n: int, shift: float = 3.0, ntt: int = 1000):
    """(sigmas (n+1,), timesteps (n,)) float32 of diffusers'
    FlowMatchEulerDiscreteScheduler with its static shift applied to the
    base table and again to the inference grid, and a terminal 0."""

    def sh(s):
        return shift * s / (1.0 + (shift - 1.0) * s)

    sigma_min = sh(np.array([1.0 / ntt]))[0]
    grid = np.linspace(1.0 * ntt, sigma_min * ntt, n, dtype=np.float64)
    sig = sh(grid / ntt)
    return (np.concatenate([sig, [0.0]]).astype(np.float32), (sig * ntt).astype(np.float32))


def cps_step(v, x, sigma, sigma_prev, noise_level, noise=None, prev=None):
    """The Flow-CPS transition: (next sample, log-prob (B,), mean). The
    log-prob is -mean((x_prev - mean)^2) over a sample's elements."""
    std = sigma_prev * math.sin(noise_level * math.pi / 2.0)
    x0 = x - sigma * v
    x1 = x + v * (1.0 - sigma)
    mean = x0 * (1.0 - sigma_prev) + x1 * math.sqrt(max(sigma_prev ** 2 - std ** 2, 0.0))
    if prev is None:
        prev = mean + std * noise
    lp = -((prev.detach() - mean) ** 2).mean(dim=tuple(range(1, x.ndim)))
    return prev, lp, mean


def guided(model: MMDiT, x, t: float, text, pooled, neg_text, neg_pooled, scale: float,
           lora=None):
    """The CFG velocity: one forward of [uncond ; cond], combined."""
    B = x.shape[0]
    tt = torch.full((2 * B,), t, device=x.device)
    v = model.forward(torch.cat([x, x]), tt, torch.cat([neg_text, text]),
                      torch.cat([neg_pooled, pooled]), lora)
    vu, vc = v.chunk(2)
    return vu + scale * (vc - vu)


def image_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Worst over rows of ||a - b|| / ||b||."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())

