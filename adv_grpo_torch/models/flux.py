"""Flux.1 rectified-flow transformer in PyTorch.

Port of adv_grpo_tpu/models/flux.py with diffusers ``FluxTransformer2DModel``
state-dict names (``x_embedder``, ``context_embedder``,
``time_text_embed.{timestep,guidance,text}_embedder.linear_{1,2}``,
``transformer_blocks.{i}.attn.{to_q,add_q_proj,norm_q,norm_added_q,to_out.0,
to_add_out,...}``, ``transformer_blocks.{i}.ff.net.{0.proj,2}``,
``single_transformer_blocks.{i}.{norm.linear,attn.to_q,proj_mlp,proj_out}``,
``norm_out.linear``, ``proj_out``); the LoRA factors of the attention
projections add ``lora_a`` / ``lora_b``, and the LoRA subtree is addressed by
the JAX tree's flat paths (:func:`flux_jax_lora_path`).

  * packed 2x2 latent tokens -> ``x_embedder``; text tokens ->
    ``context_embedder``; timestep (+ embedded guidance) + pooled text -> the
    AdaLN conditioning vector, timestep and guidance on the x1000 scale;
  * 3-axis RoPE over (t, row, col) token ids, axes (16, 56, 56), applied in
    fp32 on interleaved pairs after the per-head RMS qk-norm, then cast back;
  * 19 dual-stream blocks (joint attention, text first in RoPE order), then
    38 parallel single blocks over ``[txt ; img]`` (attention and MLP from one
    fused projection); AdaLayerNormContinuous head (chunk order scale,
    shift) -> ``proj_out``.

Numerics follow the JAX model: every product in ``cfg.dtype`` (bf16 at full
size), the RMS weights and LoRA factors fp32. The modulated LayerNorms, the
qk-norms and both attentions go through ``adv_grpo_torch.ops`` (hand-written
kernels on the card, plain versions on the CPU); sibling projections of one
input run as one product (``models/lora.py fused_qkv_proj``). Each block is
checkpointed in a training forward with ``remat`` set, as the JAX model
remats it (the whole block recomputed; ``models/remat.py``). The JAX config's
``attention_backend`` and ``fused_qkv`` have no counterpart here, and the
single blocks need no zero padding of the sequence: the attention kernel
masks ragged tiles itself.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.models.lora import LoRALinear, fused_qkv_proj
from adv_grpo_torch.models.mmdit import (
    AdaLNModulation, FeedForward, HeadRMSNorm, _EmbedMLP, sincos_timestep_embedding)
from adv_grpo_torch.models.remat import run_block
from adv_grpo_torch.ops.attention import mha_bshd
from adv_grpo_torch.ops.fused_norms import modulated_layer_norm, rms_norm_heads
from adv_grpo_torch.ops.joint_attention import joint_mha


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """Flux.1-dev defaults (11.84 B parameters); shrink for tests."""

    in_channels: int = 64  # packed 2x2 x 16
    num_double_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True  # Flux.1-dev; schnell: False
    rope_axes_dims: Tuple[int, ...] = (16, 56, 56)
    dtype: Any = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 1.0
    remat: bool = False  # checkpoint each block in a training forward (JAX: on)

    @property
    def hidden_dim(self) -> int:
        return self.attention_head_dim * self.num_attention_heads

    @classmethod
    def dev(cls, **overrides) -> "FluxConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "FluxConfig":
        defaults = dict(in_channels=16, num_double_layers=2, num_single_layers=2,
                        attention_head_dim=16, num_attention_heads=2,
                        joint_attention_dim=32, pooled_projection_dim=24,
                        rope_axes_dims=(4, 6, 6), dtype=torch.float32)
        defaults.update(overrides)
        return cls(**defaults)


def rope_freqs(ids: np.ndarray, axes_dims) -> np.ndarray:
    """(S, 3) integer ids -> (S, head_dim/2) rotation angles, float32: per
    axis, position x theta^(-i/half) with theta 10000 (computed in float64),
    the axes concatenated."""
    outs = []
    for axis, dim in enumerate(axes_dims):
        pos = ids[:, axis].astype(np.float64)
        half = dim // 2
        outs.append(np.outer(pos, 1.0 / (10000 ** (np.arange(half) / half))))
    return np.concatenate(outs, axis=-1).astype(np.float32)


def apply_rope_bshd(x, cos, sin, num_heads: int):
    """Rotate the interleaved pairs (2i, 2i+1) of each head of x (B, S, H*D)
    by the angles whose cos / sin are (S, D/2): in fp32, cast back to x's
    dtype."""
    b, s, hd = x.shape
    xf = x.reshape(b, s, num_heads, hd // num_heads // 2, 2).float()
    x1, x2 = xf[..., 0], xf[..., 1]
    c, sn = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    return out.reshape(b, s, hd).to(x.dtype)


def make_latent_ids(gh: int, gw: int) -> np.ndarray:
    """Packed-latent token ids (t=0, row, col), diffusers
    ``_prepare_latent_image_ids``."""
    ids = np.zeros((gh, gw, 3), np.int32)
    ids[..., 1] = np.arange(gh)[:, None]
    ids[..., 2] = np.arange(gw)[None, :]
    return ids.reshape(gh * gw, 3)


# the double blocks' attention projections: diffusers name -> JAX name
_JAX_ATTN_NAMES = {"add_q_proj": "add_to_q", "add_k_proj": "add_to_k",
                   "add_v_proj": "add_to_v", "to_out.0": "to_out"}


def flux_jax_lora_path(name: str) -> str:
    """Port LoRA parameter name -> the JAX Flux tree's flat path:
    ``transformer_blocks.3.attn.add_q_proj.lora_a`` ->
    ``double_3/attn/add_to_q/lora_a``; ``single_transformer_blocks.1.attn.to_v.lora_b``
    -> ``single_1/to_v/lora_b``; ``single_transformer_blocks.1.proj_mlp.lora_a``
    -> ``single_1/proj_mlp/lora_a`` (the inverse of the names in
    ``models/convert.py flux_state_dict_from_jax``)."""
    m = re.fullmatch(r"transformer_blocks\.(\d+)\.attn\.(.+)\.(lora_[ab])", name)
    if m:
        return f"double_{m[1]}/attn/{_JAX_ATTN_NAMES.get(m[2], m[2])}/{m[3]}"
    m = re.fullmatch(r"single_transformer_blocks\.(\d+)\.(?:attn\.)?(\w+)\.(lora_[ab])", name)
    if m:
        return f"single_{m[1]}/{m[2]}/{m[3]}"
    raise KeyError(f"{name} is not a Flux LoRA factor")


def _lora_linear(cfg: FluxConfig, n_in: int, n_out: int, device):
    return LoRALinear(n_in, n_out, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                      dtype=cfg.dtype, device=device)


def _qk_norm(x, norm: HeadRMSNorm, cfg: FluxConfig):
    return rms_norm_heads(x, norm.weight, num_heads=cfg.num_attention_heads,
                          out_dtype=cfg.dtype)


class FluxAttention(nn.Module):
    """Joint attention of a double block: LoRA projections of both streams,
    per-head RMS qk-norm, RoPE (text positions first), ``joint_mha``."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, d = cfg.hidden_dim, cfg.attention_head_dim

        def mk():
            return _lora_linear(cfg, dim, dim, device)

        self.to_q, self.to_k, self.to_v = mk(), mk(), mk()
        self.add_q_proj, self.add_k_proj, self.add_v_proj = mk(), mk(), mk()
        self.to_out = nn.ModuleList([mk()])
        self.to_add_out = mk()
        self.norm_q, self.norm_k = HeadRMSNorm(d, device), HeadRMSNorm(d, device)
        self.norm_added_q, self.norm_added_k = HeadRMSNorm(d, device), HeadRMSNorm(d, device)

    def forward(self, img_mod, txt_mod, cos, sin, lora_scale: float = 1.0):
        c = self.cfg
        H = c.num_attention_heads
        s_txt = txt_mod.shape[1]
        iq, ik, iv = fused_qkv_proj([self.to_q, self.to_k, self.to_v], img_mod, lora_scale)
        tq, tk, tv = fused_qkv_proj([self.add_q_proj, self.add_k_proj, self.add_v_proj],
                                    txt_mod, lora_scale)
        # RMS (kernel) -> RoPE (fp32) -> attention; the text tokens take the
        # first s_txt rotary positions, the image tokens the rest
        tq = apply_rope_bshd(_qk_norm(tq, self.norm_added_q, c), cos[:s_txt], sin[:s_txt], H)
        tk = apply_rope_bshd(_qk_norm(tk, self.norm_added_k, c), cos[:s_txt], sin[:s_txt], H)
        iq = apply_rope_bshd(_qk_norm(iq, self.norm_q, c), cos[s_txt:], sin[s_txt:], H)
        ik = apply_rope_bshd(_qk_norm(ik, self.norm_k, c), cos[s_txt:], sin[s_txt:], H)
        img_o, txt_o = joint_mha(iq, ik, iv, tq, tk, tv, num_heads=H)
        return self.to_out[0](img_o, lora_scale), self.to_add_out(txt_o, lora_scale)


class FluxDoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.norm1 = AdaLNModulation(dim, 6, dt, device)
        self.norm1_context = AdaLNModulation(dim, 6, dt, device)
        self.attn = FluxAttention(cfg, device)
        self.ff = FeedForward(dim, dt, device)
        self.ff_context = FeedForward(dim, dt, device)

    def forward(self, img, txt, temb, cos, sin, lora_scale: float = 1.0):
        # modulation chunks: shift, scale, gate (attention), then the MLP's
        im, tm = self.norm1(temb), self.norm1_context(temb)
        img_att, txt_att = self.attn(modulated_layer_norm(img, im[1], im[0]),
                                     modulated_layer_norm(txt, tm[1], tm[0]),
                                     cos, sin, lora_scale)
        img = img + im[2][:, None] * img_att
        txt = txt + tm[2][:, None] * txt_att
        img = img + im[5][:, None] * self.ff(modulated_layer_norm(img, im[4], im[3]))
        txt = txt + tm[5][:, None] * self.ff_context(modulated_layer_norm(txt, tm[4], tm[3]))
        return img, txt


class FluxSingleAttention(nn.Module):
    """The q/k/v projections and qk-norms of a single block (diffusers names
    ``attn.to_q`` ...); the block computes them with its ``proj_mlp``."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        dim, d = cfg.hidden_dim, cfg.attention_head_dim
        self.to_q, self.to_k, self.to_v = (_lora_linear(cfg, dim, dim, device)
                                           for _ in range(3))
        self.norm_q, self.norm_k = HeadRMSNorm(d, device), HeadRMSNorm(d, device)


class FluxSingleBlock(nn.Module):
    """Parallel attention + MLP over the fused [txt ; img] sequence: one
    modulation, one fused q/k/v/MLP projection, ``mha_bshd``, one output
    projection of [attention ; gelu(mlp)]."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_dim
        self.norm = AdaLNModulation(dim, 3, cfg.dtype, device)
        self.attn = FluxSingleAttention(cfg, device)
        self.proj_mlp = _lora_linear(cfg, dim, 4 * dim, device)
        self.proj_out = _lora_linear(cfg, 5 * dim, dim, device)

    def forward(self, x, temb, cos, sin, lora_scale: float = 1.0):
        c, a = self.cfg, self.attn
        H = c.num_attention_heads
        shift, scale, gate = self.norm(temb)
        h = modulated_layer_norm(x, scale, shift)
        q, k, v, mlp_h = fused_qkv_proj([a.to_q, a.to_k, a.to_v, self.proj_mlp], h,
                                        lora_scale)
        q = apply_rope_bshd(_qk_norm(q, a.norm_q, c), cos, sin, H)
        k = apply_rope_bshd(_qk_norm(k, a.norm_k, c), cos, sin, H)
        att = mha_bshd(q, k, v, num_heads=H)
        mlp = F.gelu(mlp_h, approximate="tanh")
        out = self.proj_out(torch.cat([att, mlp], dim=-1), lora_scale)
        return x + gate[:, None] * out


class TimestepGuidanceTextEmbed(nn.Module):
    """diffusers CombinedTimestepGuidanceTextProjEmbeddings: the sinusoid of
    the timestep (already on the 0..1000 scale) and of guidance x 1000, each
    through its MLP, plus the pooled text's MLP."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.dtype = dt
        self.timestep_embedder = _EmbedMLP(256, dim, dt, device)
        self.guidance_embedder = (_EmbedMLP(256, dim, dt, device) if cfg.guidance_embeds
                                  else None)
        self.text_embedder = _EmbedMLP(cfg.pooled_projection_dim, dim, dt, device)

    def forward(self, timestep, guidance, pooled):
        temb = self.timestep_embedder(sincos_timestep_embedding(timestep, 256).to(self.dtype))
        if self.guidance_embedder is not None:
            g = guidance if guidance is not None else torch.full_like(timestep.float(), 3.5)
            temb = temb + self.guidance_embedder(
                sincos_timestep_embedding(g.float() * 1000.0, 256).to(self.dtype))
        return temb + self.text_embedder(pooled.to(self.dtype))


class FluxTransformer(nn.Module):
    """forward(packed latents (B, S, in_channels), timestep (B,) on the
    0..1000 scale, encoder_hidden_states (B, S_txt, joint_attention_dim),
    pooled (B, pooled_dim), img_ids (S, 3) numpy, txt_ids (S_txt, 3) numpy,
    guidance (B,) or None, lora_scale) -> velocity (B, S, in_channels) in
    cfg.dtype."""

    jax_lora_path = staticmethod(flux_jax_lora_path)  # read by models/lora.py lora_params

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, dt = cfg.hidden_dim, cfg.dtype
        self.x_embedder = nn.Linear(cfg.in_channels, dim, dtype=dt, device=device)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim, dtype=dt,
                                          device=device)
        self.time_text_embed = TimestepGuidanceTextEmbed(cfg, device)
        self.transformer_blocks = nn.ModuleList(
            [FluxDoubleBlock(cfg, device) for _ in range(cfg.num_double_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleBlock(cfg, device) for _ in range(cfg.num_single_layers)])
        self.norm_out = AdaLNModulation(dim, 2, dt, device)
        self.proj_out = nn.Linear(dim, cfg.in_channels, dtype=dt, device=device)
        # (ids, device, inference mode) -> (cos, sin), built once; tensors made
        # under inference_mode cannot be saved for a backward, so a training
        # forward gets its own
        self._rope: Dict[tuple, tuple] = {}

    def rope(self, txt_ids: np.ndarray, img_ids: np.ndarray, device):
        """fp32 (S_txt + S, D/2) cos and sin of the [txt ; img] token ids."""
        ids = np.concatenate([np.asarray(txt_ids), np.asarray(img_ids)], axis=0)
        key = (ids.shape, ids.tobytes(), str(device), torch.is_inference_mode_enabled())
        if key not in self._rope:
            angles = torch.from_numpy(rope_freqs(ids, self.cfg.rope_axes_dims)).to(device)
            self._rope[key] = (torch.cos(angles), torch.sin(angles))
        return self._rope[key]

    def forward(self, latents, timestep, encoder_hidden_states, pooled,
                img_ids: np.ndarray, txt_ids: np.ndarray, guidance=None,
                lora_scale: float = 1.0):
        c = self.cfg
        img = self.x_embedder(latents.to(c.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(c.dtype))
        temb = self.time_text_embed(timestep, guidance, pooled)
        cos, sin = self.rope(txt_ids, img_ids, latents.device)
        for block in self.transformer_blocks:
            img, txt = run_block(block, img, txt, temb, cos, sin, lora_scale, remat=c.remat)
        s_txt = txt.shape[1]
        x = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            x = run_block(block, x, temb, cos, sin, lora_scale, remat=c.remat)
        # output head: AdaLayerNormContinuous, chunk order (scale, shift)
        oscale, oshift = self.norm_out(temb)
        img = modulated_layer_norm(x[:, s_txt:].contiguous(), oscale, oshift)
        return self.proj_out(img)
