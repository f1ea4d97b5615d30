"""MMDiT (SD3 / SD3.5 joint-stream diffusion transformer) in PyTorch.

Port of adv_grpo_tpu/models/mmdit.py with diffusers ``SD3Transformer2DModel``
state-dict names (``pos_embed.proj``, ``time_text_embed.*``,
``transformer_blocks.{i}.attn.to_q``, ``...ff.net.0.proj``, ``norm_out.linear``,
``proj_out``), so a diffusers checkpoint loads with no converter; the LoRA
factors of the joint-attention projections add ``lora_a`` / ``lora_b``.

Numerics follow the JAX model: every product runs in ``cfg.dtype`` (bf16 at
full size) with the weights held in that dtype; the per-head RMS qk-norm
weights stay fp32; the timestep sincos is computed in fp32 and then cast. The
modulated LayerNorms and the two attentions go through ``adv_grpo_torch.ops``
(hand-written kernels on the card, plain versions on the CPU).

With ``remat`` set, each block is checkpointed in a training forward as the
JAX model remats it (``remat_policy`` named as in JAX; ``models/remat.py``).
The JAX config's ``attention_backend`` and ``fused_qkv`` have no counterpart
here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.models.lora import LoRALinear
from adv_grpo_torch.models.remat import check_policy, run_block
from adv_grpo_torch.ops.fused_norms import modulated_layer_norm
from adv_grpo_torch.ops.joint_attention import joint_mha, mha_rms


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3.5-Medium defaults; shrink for tests."""

    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # text token width (T5 dim)
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 384
    # position scaling of the fixed sincos table (see cropped_pos_embed)
    pos_embed_base_size: Optional[int] = None
    qk_norm: bool = True
    dual_attention_layers: Tuple[int, ...] = tuple(range(13))
    sample_size: int = 128
    dtype: Any = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 1.0
    # checkpoint each block in a training forward (models/remat.py); off by
    # default here, on in the JAX config; every ported policy recomputes the
    # whole block
    remat: bool = False
    remat_policy: str = "save_attn"

    @property
    def hidden_dim(self) -> int:
        return self.attention_head_dim * self.num_attention_heads

    @classmethod
    def sd35_medium(cls, **overrides) -> "MMDiTConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "MMDiTConfig":
        """4-layer toy config for CPU tests."""
        defaults = dict(
            num_layers=4, attention_head_dim=32, num_attention_heads=4,
            joint_attention_dim=64, pooled_projection_dim=48,
            pos_embed_max_size=32, dual_attention_layers=(0, 1),
            dtype=torch.float32,
        )
        defaults.update(overrides)
        return cls(**defaults)


# ── fixed tables (numpy, identical to adv_grpo_tpu.models.mmdit) ─────────────


def sincos_timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Diffusers `Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)`,
    in fp32; t is the raw timestep (0..1000 for SD3)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _sincos_table(embed_dim: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """(len(rows), len(cols), embed_dim) sincos table for given grid coords."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    hh, ww = np.meshgrid(rows, cols, indexing="ij")
    # diffusers get_2d_sincos_pos_embed concatenates [sincos(col), sincos(row)]
    emb_c = _1d(embed_dim // 2, ww)
    emb_r = _1d(embed_dim // 2, hh)
    out = np.concatenate([emb_c, emb_r], axis=1).astype(np.float32)
    return out.reshape(len(rows), len(cols), embed_dim)


def cropped_pos_embed(embed_dim: int, max_size: int, gh: int, gw: int,
                      base_size: Optional[int] = None) -> np.ndarray:
    """Centre-cropped fixed table (diffusers PatchEmbed cropped_pos_embed
    semantics) computed only over the needed (gh, gw) window; ``base_size``
    scales positions by base_size/max_size (None keeps raw integer positions)."""
    top = (max_size - gh) // 2
    left = (max_size - gw) // 2
    rows = np.arange(top, top + gh, dtype=np.float64)
    cols = np.arange(left, left + gw, dtype=np.float64)
    if base_size is not None:
        rows = rows * (base_size / max_size)
        cols = cols * (base_size / max_size)
    return _sincos_table(embed_dim, rows, cols).reshape(1, gh * gw, embed_dim)


# ── modules ──────────────────────────────────────────────────────────────────


class HeadRMSNorm(nn.Module):
    """Holds the (d,) fp32 weight of a per-head RMS qk-norm; the norm itself is
    fused into the attention op (``adv_grpo_torch.ops.joint_attention``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32, device=device))


class AdaLNModulation(nn.Module):
    """silu(temb) -> Linear -> n_chunks modulation vectors."""

    def __init__(self, dim: int, n_chunks: int, dtype, device=None):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = nn.Linear(dim, n_chunks * dim, dtype=dtype, device=device)

    def forward(self, temb):
        return self.linear(F.silu(temb)).chunk(self.n_chunks, dim=-1)


class _GELUProj(nn.Module):
    def __init__(self, dim, inner_dim, dtype, device):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim, dtype=dtype, device=device)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """GELU-tanh MLP (``inner_dim`` wide, 4x by default); diffusers names
    ``net.0.proj`` and ``net.2``."""

    def __init__(self, dim: int, dtype, device=None, inner_dim=None):
        super().__init__()
        inner_dim = inner_dim or 4 * dim
        self.net = nn.ModuleList([_GELUProj(dim, inner_dim, dtype, device), nn.Identity(),
                                  nn.Linear(inner_dim, dim, dtype=dtype, device=device)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class JointAttention(nn.Module):
    """Joint image+text attention with per-head RMS qk-norm and LoRA on the 8
    projections (``context_pre_only`` blocks have no ``to_add_out``)."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False, device=None):
        super().__init__()
        self.cfg, self.context_pre_only = cfg, context_pre_only
        dim = cfg.hidden_dim

        def mk():
            return LoRALinear(dim, dim, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                              dtype=cfg.dtype, device=device)

        self.to_q, self.to_k, self.to_v = mk(), mk(), mk()
        self.add_q_proj, self.add_k_proj, self.add_v_proj = mk(), mk(), mk()
        self.to_out = nn.ModuleList([mk()])
        if not context_pre_only:
            self.to_add_out = mk()
        if cfg.qk_norm:
            d = cfg.attention_head_dim
            self.norm_q, self.norm_k = HeadRMSNorm(d, device), HeadRMSNorm(d, device)
            self.norm_added_q = HeadRMSNorm(d, device)
            self.norm_added_k = HeadRMSNorm(d, device)

    def forward(self, x, ctx, lora_scale: float = 1.0):
        c = self.cfg
        q, k, v = (m(x, lora_scale) for m in (self.to_q, self.to_k, self.to_v))
        cq, ck, cv = (m(ctx, lora_scale)
                      for m in (self.add_q_proj, self.add_k_proj, self.add_v_proj))
        rms_weights = None
        if c.qk_norm:
            rms_weights = (self.norm_q.weight, self.norm_k.weight,
                           self.norm_added_q.weight, self.norm_added_k.weight)
        o_img, o_txt = joint_mha(q, k, v, cq, ck, cv, num_heads=c.num_attention_heads,
                                 rms_weights=rms_weights)
        x_out = self.to_out[0](o_img, lora_scale)
        if self.context_pre_only:
            return x_out, None
        return x_out, self.to_add_out(o_txt, lora_scale)


class DualSelfAttention(nn.Module):
    """SD3.5's extra image-stream self-attention (attn2); no LoRA."""

    def __init__(self, cfg: MMDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_dim

        def mk():
            return nn.Linear(dim, dim, dtype=cfg.dtype, device=device)

        self.to_q, self.to_k, self.to_v = mk(), mk(), mk()
        self.to_out = nn.ModuleList([mk()])
        if cfg.qk_norm:
            d = cfg.attention_head_dim
            self.norm_q, self.norm_k = HeadRMSNorm(d, device), HeadRMSNorm(d, device)

    def forward(self, x):
        c = self.cfg
        rms_weights = (self.norm_q.weight, self.norm_k.weight) if c.qk_norm else None
        o = mha_rms(self.to_q(x), self.to_k(x), self.to_v(x),
                    num_heads=c.num_attention_heads, rms_weights=rms_weights)
        return self.to_out[0](o)


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dual_attention: bool = False,
                 context_pre_only: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.dual_attention, self.context_pre_only = dual_attention, context_pre_only
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.norm1 = AdaLNModulation(dim, 9 if dual_attention else 6, dt, device)
        self.norm1_context = AdaLNModulation(dim, 2 if context_pre_only else 6, dt, device)
        self.attn = JointAttention(cfg, context_pre_only, device)
        if dual_attention:
            self.attn2 = DualSelfAttention(cfg, device)
        self.ff = FeedForward(dim, dt, device)
        if not context_pre_only:
            self.ff_context = FeedForward(dim, dt, device)

    def forward(self, x, ctx, temb, lora_scale: float = 1.0):
        mods = self.norm1(temb)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:6]
        x_pre = x  # dual attention modulates the PRE-attention norm input
        x_mod = modulated_layer_norm(x, scale_msa, shift_msa)

        if self.context_pre_only:
            # AdaLayerNormContinuous on the context: chunk order [scale, shift]
            cscale, cshift = self.norm1_context(temb)
            ctx_mod = modulated_layer_norm(ctx, cscale, cshift)
        else:
            (c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp,
             c_gate_mlp) = self.norm1_context(temb)
            ctx_mod = modulated_layer_norm(ctx, c_scale_msa, c_shift_msa)

        attn_out, ctx_attn_out = self.attn(x_mod, ctx_mod, lora_scale)
        x = x + gate_msa[:, None] * attn_out

        if self.dual_attention:
            shift_msa2, scale_msa2, gate_msa2 = mods[6:]
            x_mod2 = modulated_layer_norm(x_pre, scale_msa2, shift_msa2)
            x = x + gate_msa2[:, None] * self.attn2(x_mod2)

        h = modulated_layer_norm(x, scale_mlp, shift_mlp)
        x = x + gate_mlp[:, None] * self.ff(h)

        if self.context_pre_only:
            return x, None
        ctx = ctx + c_gate_msa[:, None] * ctx_attn_out
        hc = modulated_layer_norm(ctx, c_scale_mlp, c_shift_mlp)
        ctx = ctx + c_gate_mlp[:, None] * self.ff_context(hc)
        return x, ctx


class PatchEmbed(nn.Module):
    """The patch projection (a Conv2d for the diffusers name and layout, run as
    the patchify + matmul of the JAX model) plus the cropped sincos table."""

    def __init__(self, cfg: MMDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_dim, p, stride=p,
                              dtype=cfg.dtype, device=device)
        self._pos = {}  # (gh, gw, device) -> table in cfg.dtype, built once

    def forward(self, latents):
        c = self.cfg
        p = c.patch_size
        B, C, h, w = latents.shape
        gh, gw = h // p, w // p
        # (B,C,h,w) -> (B, gh*gw, p*p*C), flattened (ph, pw, C) like the JAX Dense
        x = latents.reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        x = x.reshape(B, gh * gw, p * p * C).to(c.dtype)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(c.hidden_dim, p * p * C)
        x = F.linear(x, wt, self.proj.bias)
        key = (gh, gw, latents.device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(cropped_pos_embed(
                c.hidden_dim, c.pos_embed_max_size, gh, gw,
                base_size=c.pos_embed_base_size)).to(latents.device, c.dtype)
        return x + self._pos[key]


class _EmbedMLP(nn.Module):
    def __init__(self, in_dim, dim, dtype, device):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TimestepTextEmbed(nn.Module):
    """diffusers CombinedTimestepTextProjEmbeddings: timestep + pooled text."""

    def __init__(self, cfg: MMDiTConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.timestep_embedder = _EmbedMLP(256, cfg.hidden_dim, cfg.dtype, device)
        self.text_embedder = _EmbedMLP(cfg.pooled_projection_dim, cfg.hidden_dim,
                                       cfg.dtype, device)

    def forward(self, timestep, pooled):
        t_emb = sincos_timestep_embedding(timestep, 256).to(self.dtype)
        return self.timestep_embedder(t_emb) + self.text_embedder(pooled.to(self.dtype))


class MMDiT(nn.Module):
    """Velocity-prediction joint transformer.

    forward(latents (B,C,h,w), timestep (B,) raw 0..1000, encoder_hidden_states
    (B,S_txt,joint_attention_dim), pooled_projections (B,pooled_dim),
    lora_scale) -> velocity (B,C,h,w) in cfg.dtype
    """

    def __init__(self, cfg: MMDiTConfig, device=None):
        super().__init__()
        if cfg.remat:
            check_policy(cfg.remat_policy)
        self.cfg = cfg
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.pos_embed = PatchEmbed(cfg, device)
        self.time_text_embed = TimestepTextEmbed(cfg, device)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim, dtype=dt,
                                          device=device)
        self.transformer_blocks = nn.ModuleList([
            JointBlock(cfg, dual_attention=i in cfg.dual_attention_layers,
                       context_pre_only=i == cfg.num_layers - 1, device=device)
            for i in range(cfg.num_layers)])
        self.norm_out = AdaLNModulation(dim, 2, dt, device)
        self.proj_out = nn.Linear(dim, cfg.patch_size ** 2 * cfg.out_channels, dtype=dt,
                                  device=device)

    def forward(self, latents, timestep, encoder_hidden_states, pooled_projections,
                lora_scale: float = 1.0):
        c = self.cfg
        p = c.patch_size
        B, _, h, w = latents.shape
        x = self.pos_embed(latents)
        temb = self.time_text_embed(timestep, pooled_projections)
        ctx = self.context_embedder(encoder_hidden_states.to(c.dtype))
        for block in self.transformer_blocks:
            x, ctx = run_block(block, x, ctx, temb, lora_scale, remat=c.remat)
        # output head: AdaLayerNormContinuous (chunk order [scale, shift])
        oscale, oshift = self.norm_out(temb)
        x = self.proj_out(modulated_layer_norm(x, oscale, oshift))
        # unpatchify -> (B, C, h, w)
        x = x.reshape(B, h // p, w // p, p, p, c.out_channels)
        return x.permute(0, 5, 1, 3, 2, 4).reshape(B, c.out_channels, h, w)
