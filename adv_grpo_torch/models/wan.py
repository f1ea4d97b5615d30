"""WAN text-to-video diffusion transformer (Wan2.1 T2V) in PyTorch.

Port of adv_grpo_tpu/models/wan.py with diffusers ``WanTransformer3DModel``
state-dict names (``patch_embedding``, ``condition_embedder.{time_embedder.
linear_{1,2},time_proj,text_embedder.linear_{1,2}}``,
``blocks.{i}.{attn1,attn2}.{to_q,to_k,to_v,to_out.0,norm_q,norm_k}``,
``blocks.{i}.norm2``, ``blocks.{i}.ffn.net.{0.proj,2}``,
``blocks.{i}.scale_shift_table``, ``scale_shift_table``, ``proj_out``); the
LoRA factors of the eight attention projections add ``lora_a`` / ``lora_b``,
and the LoRA subtree is addressed by the JAX tree's flat paths
(:func:`wan_jax_lora_path`).

  * 5-D latents (B, C, F, H, W) patchified (1, 2, 2) into F * H/2 * W/2
    tokens, embedded by one product (the patch Conv3d as a matmul);
  * the sinusoid of the timestep through an MLP, plus a 6-way time
    projection added (in the compute dtype) to each block's learned
    scale-shift table;
  * per block: self-attention (modulated LN, fused q/k/v, RMS across all
    heads, 3-axis RoPE), cross-attention to the text (plain LN with the
    affine ``norm2`` applied after the cast, RMS qk-norms), GELU FFN;
  * the output modulation adds the time embedding itself (not its silu) to
    both rows of the root table, then ``proj_out`` and 3D unpatchify.

Numerics follow the JAX model: every product in ``cfg.dtype`` (bf16 at full
size), the tables, norm weights and LoRA factors fp32. The LayerNorms, the
RMS norms and both attentions go through ``adv_grpo_torch.ops`` (hand-written
kernels on the card, plain versions on the CPU). The JAX model pads the
sequence to a multiple of 128 and masks the padded keys; the kernels mask
ragged tiles themselves, so nothing is padded here. Each block is
checkpointed in a training forward with ``remat`` set, as the JAX model
remats it (the whole block recomputed; ``models/remat.py``). The JAX config's
``attention_backend`` and ``fused_qkv`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.models.flux import apply_rope_bshd, rope_freqs
from adv_grpo_torch.models.lora import LoRALinear, fused_qkv_proj
from adv_grpo_torch.models.mmdit import FeedForward, HeadRMSNorm, _EmbedMLP, \
    sincos_timestep_embedding
from adv_grpo_torch.models.remat import run_block
from adv_grpo_torch.ops.attention import mha_bshd
from adv_grpo_torch.ops.fused_norms import layer_norm, modulated_layer_norm, rms_norm_heads


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Wan2.1-T2V-1.3B defaults (diffusers WanTransformer3DModel); shrink for
    tests."""

    in_channels: int = 16
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_layers: int = 30
    attention_head_dim: int = 128
    num_attention_heads: int = 12
    text_dim: int = 4096
    ffn_dim: int = 8960
    rope_axes_dims: Tuple[int, ...] = (44, 42, 42)  # sums to the head width
    cross_attn_norm: bool = True  # norm2 is an affine LayerNorm
    dtype: Any = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 1.0
    remat: bool = False  # checkpoint each block in a training forward (JAX: on)

    @property
    def hidden_dim(self) -> int:
        return self.attention_head_dim * self.num_attention_heads

    @classmethod
    def t2v_1_3b(cls, **overrides) -> "WanConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "WanConfig":
        defaults = dict(num_layers=2, attention_head_dim=16, num_attention_heads=2,
                        text_dim=32, ffn_dim=64, rope_axes_dims=(8, 4, 4),
                        dtype=torch.float32)
        defaults.update(overrides)
        return cls(**defaults)


def make_video_ids(f: int, gh: int, gw: int) -> np.ndarray:
    """(S, 3) = (frame, row, col) token ids for the 3-axis RoPE."""
    t, h, w = np.meshgrid(np.arange(f), np.arange(gh), np.arange(gw), indexing="ij")
    return np.stack([t, h, w], axis=-1).reshape(-1, 3).astype(np.int32)


def wan_jax_lora_path(name: str) -> str:
    """Port LoRA parameter name -> the JAX WAN tree's flat path:
    ``blocks.3.attn1.to_out.0.lora_a`` -> ``block_3/to_out/lora_a``;
    ``blocks.3.attn2.to_k.lora_b`` -> ``block_3/cross_to_k/lora_b`` (the
    inverse of the names in ``models/convert.py wan_state_dict_from_jax``)."""
    m = re.fullmatch(r"blocks\.(\d+)\.attn([12])\.(to_q|to_k|to_v|to_out\.0)\.(lora_[ab])",
                     name)
    if not m:
        raise KeyError(f"{name} is not a WAN LoRA factor")
    proj = m[3].removesuffix(".0")
    return f"block_{m[1]}/{'cross_' if m[2] == '2' else ''}{proj}/{m[4]}"


class WanAttention(nn.Module):
    """The projections and RMS qk-norms (across all heads: one weight of the
    full width) of ``attn1`` or ``attn2``; the block runs them."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        dim = cfg.hidden_dim

        def mk():
            return LoRALinear(dim, dim, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                              dtype=cfg.dtype, device=device)

        self.to_q, self.to_k, self.to_v = mk(), mk(), mk()
        self.to_out = nn.ModuleList([mk()])
        self.norm_q, self.norm_k = HeadRMSNorm(dim, device), HeadRMSNorm(dim, device)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.attn1 = WanAttention(cfg, device)
        self.attn2 = WanAttention(cfg, device)
        if cfg.cross_attn_norm:
            # holds the fp32 affine; the kernel normalises, the affine follows
            # in the compute dtype
            self.norm2 = nn.LayerNorm(dim, eps=1e-6, dtype=torch.float32, device=device)
        self.ffn = FeedForward(dim, dt, device, inner_dim=cfg.ffn_dim)
        self.scale_shift_table = nn.Parameter(
            torch.empty(1, 6, dim, dtype=torch.float32, device=device))

    def _rms(self, x, norm):
        return rms_norm_heads(x, norm.weight, num_heads=1, out_dtype=self.cfg.dtype)

    def forward(self, x, text, temb6, cos, sin, lora_scale: float = 1.0):
        c = self.cfg
        dt, H = c.dtype, c.num_attention_heads
        # each modulation row: the table's row in the compute dtype plus the
        # time projection's chunk (a compute-dtype add, as in the JAX model)
        table = self.scale_shift_table[0]
        shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = (
            table[i].to(dt) + temb6[i] for i in range(6))

        a = self.attn1
        h = modulated_layer_norm(x, scale_sa, shift_sa, out_dtype=dt)
        q, k, v = fused_qkv_proj([a.to_q, a.to_k, a.to_v], h, lora_scale)
        q = apply_rope_bshd(self._rms(q, a.norm_q), cos, sin, H)
        k = apply_rope_bshd(self._rms(k, a.norm_k), cos, sin, H)
        x = x + gate_sa[:, None] * a.to_out[0](mha_bshd(q, k, v, num_heads=H), lora_scale)

        a = self.attn2
        hq = layer_norm(x, out_dtype=dt)
        if c.cross_attn_norm:
            hq = hq * self.norm2.weight.to(dt) + self.norm2.bias.to(dt)
        q = self._rms(a.to_q(hq, lora_scale), a.norm_q)
        k, v = fused_qkv_proj([a.to_k, a.to_v], text, lora_scale)
        k = self._rms(k, a.norm_k)
        x = x + a.to_out[0](mha_bshd(q, k, v, num_heads=H), lora_scale)

        h = modulated_layer_norm(x, scale_ff, shift_ff, out_dtype=dt)
        return x + gate_ff[:, None] * self.ffn(h)


class _TextProjection(nn.Module):
    """diffusers PixArtAlphaTextProjection(act_fn='gelu_tanh')."""

    def __init__(self, in_dim, dim, dtype, device):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class WanConditionEmbedder(nn.Module):
    """The timestep MLP, the 6-way time projection and the text projection."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.time_embedder = _EmbedMLP(256, dim, dt, device)
        self.time_proj = nn.Linear(dim, 6 * dim, dtype=dt, device=device)
        self.text_embedder = _TextProjection(cfg.text_dim, dim, dt, device)


class WanTransformer(nn.Module):
    """forward(latents (B, C, F, H, W), timestep (B,) on the 0..1000 scale,
    text_states (B, S_txt, text_dim), lora_scale) -> velocity (B, C, F, H, W)
    in cfg.dtype."""

    jax_lora_path = staticmethod(wan_jax_lora_path)  # read by models/lora.py lora_params

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.patch_embedding = nn.Conv3d(cfg.in_channels, dim, cfg.patch_size,
                                         stride=cfg.patch_size, dtype=dt, device=device)
        self.condition_embedder = WanConditionEmbedder(cfg, device)
        self.blocks = nn.ModuleList([WanBlock(cfg, device) for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(
            torch.empty(1, 2, dim, dtype=torch.float32, device=device))
        self.proj_out = nn.Linear(dim, math.prod(cfg.patch_size) * cfg.out_channels,
                                  dtype=dt, device=device)
        # (grid, device, inference mode) -> (cos, sin), built once; tensors made
        # under inference_mode cannot be saved for a backward, so a training
        # forward gets its own
        self._rope: Dict[tuple, tuple] = {}

    def rope(self, f: int, gh: int, gw: int, device):
        """fp32 (f*gh*gw, D/2) cos and sin of the video token ids."""
        key = (f, gh, gw, str(device), torch.is_inference_mode_enabled())
        if key not in self._rope:
            angles = torch.from_numpy(
                rope_freqs(make_video_ids(f, gh, gw), self.cfg.rope_axes_dims)).to(device)
            self._rope[key] = (torch.cos(angles), torch.sin(angles))
        return self._rope[key]

    def forward(self, latents, timestep, text_states, lora_scale: float = 1.0):
        c = self.cfg
        dt, dim = c.dtype, c.hidden_dim
        pt, ph, pw = c.patch_size
        B, C, Fr, Hh, Ww = latents.shape
        f, gh, gw = Fr // pt, Hh // ph, Ww // pw
        # (B,C,F,H,W) -> (B, f*gh*gw, pt*ph*pw*C), flattened (pt, ph, pw, C)
        # like the JAX Dense; the Conv3d weight in the same order
        x = latents.reshape(B, C, f, pt, gh, ph, gw, pw).permute(0, 2, 4, 6, 3, 5, 7, 1)
        x = x.reshape(B, f * gh * gw, pt * ph * pw * C).to(dt)
        wt = self.patch_embedding.weight.permute(0, 2, 3, 4, 1).reshape(dim, -1)
        x = F.linear(x, wt, self.patch_embedding.bias)

        ce = self.condition_embedder
        text = ce.text_embedder(text_states.to(dt))
        t_emb = ce.time_embedder(sincos_timestep_embedding(timestep, 256).to(dt))
        temb6 = ce.time_proj(F.silu(t_emb)).chunk(6, dim=-1)
        cos, sin = self.rope(f, gh, gw, latents.device)
        for block in self.blocks:
            x = run_block(block, x, text, temb6, cos, sin, lora_scale, remat=c.remat)

        # the output rows add the time embedding itself (diffusers
        # WanTransformer3DModel), in the compute dtype
        table = self.scale_shift_table[0]
        shift, scale = table[0].to(dt) + t_emb, table[1].to(dt) + t_emb
        x = self.proj_out(modulated_layer_norm(x, scale, shift, out_dtype=dt))
        x = x.reshape(B, f, gh, gw, pt, ph, pw, c.out_channels)
        return x.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(B, c.out_channels, Fr, Hh, Ww)
