"""The SigLIP vision tower of the SigLIP rewards, in PyTorch.

Port of adv_grpo_tpu/models/siglip.py (HF ``SiglipVisionModel`` semantics,
``google/siglip-so400m-patch14-384``): the patch embedding as one matmul
over (gh, gw, p, p, 3)-flattened patches (the JAX order; at 384^2, which
14 does not divide, the 27 x 27 patches of HF's stride-14 Conv2d, where
the JAX reshape raises), a learned position
table and no class token, the pre-LN blocks of ``models.vit`` with
``gelu_pytorch_tanh``, ``post_layernorm``, then the MAP head: a learned probe
attends over every token (separate q / k / v / out Linears, fp32 scores
scaled by hd^-0.5), and the pooled embedding is ``o + mlp(ln(o))`` at the
probe, the residual taken from the attention output.

SigLIP so400m's head width is 72, which ``ops.attention.mha`` does not
build; the blocks and the head use the plain matmul + softmax of
``models.clip_text.attention``, as the JAX tower uses its einsum + softmax.
fp32 throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.models.clip_text import attention
from adv_grpo_torch.models.vit import ViTBlock, ViTConfig


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    layer_norm_eps: float = 1e-6

    @classmethod
    def so400m(cls, **o):
        """SigLIP so400m/14 at 384^2: 27 layers of 1152 in 16 heads of 72,
        729 patches."""
        return cls(**o)

    @classmethod
    def tiny(cls, **o):
        d = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                 num_layers=2, num_heads=2)
        d.update(o)
        return cls(**d)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def as_vit(self) -> ViTConfig:
        return ViTConfig(image_size=self.image_size, patch_size=self.patch_size,
                         hidden_size=self.hidden_size, intermediate_size=self.intermediate_size,
                         num_layers=self.num_layers, num_heads=self.num_heads,
                         layer_norm_eps=self.layer_norm_eps, hidden_act="gelu_pytorch_tanh",
                         use_pre_ln=False, projection_dim=None)


class MAPHead(nn.Module):
    """Attention pooling: the learned probe attends over all tokens; (B, S,
    D) -> (B, D)."""

    def __init__(self, cfg: SigLIPVisionConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.probe = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, device=device)

    def forward(self, tokens):
        B, S, D = tokens.shape
        nh = self.cfg.num_heads
        q = self.q_proj(self.probe.expand(B, 1, D)).view(B, 1, nh, D // nh).transpose(1, 2)
        k, v = (p(tokens).view(B, S, nh, D // nh).transpose(1, 2)
                for p in (self.k_proj, self.v_proj))
        o = self.out_proj(attention(q, k, v).transpose(1, 2).reshape(B, 1, D))
        h = self.fc2(F.gelu(self.fc1(self.layernorm(o)), approximate="tanh"))
        return (o + h)[:, 0]


class SigLIPVisionTower(nn.Module):
    """pixel_values (B, 3, H, W) -> {"tokens": the post-LN tokens (B, N, D),
    "pooled": the MAP head's embedding (B, D)}."""

    def __init__(self, cfg: SigLIPVisionConfig, device=None):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(p * p * 3, d, device=device)
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches, d, device=device))
        vit = cfg.as_vit()
        self.layers = nn.ModuleList(ViTBlock(vit, device) for _ in range(cfg.num_layers))
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.head = MAPHead(cfg, device)

    def forward(self, pixel_values) -> Dict[str, torch.Tensor]:
        B, _, H, W = pixel_values.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        # so400m's 384^2 is no multiple of 14: HF's stride-14 patch Conv2d
        # leaves the last 6 rows and columns out, and so does this
        x = pixel_values[:, :, :gh * p, :gw * p].permute(0, 2, 3, 1)  # NHWC
        x = x.reshape(B, gh, p, gw, p, 3).transpose(2, 3).reshape(B, gh * gw, p * p * 3)
        x = self.patch_embed(x) + self.position_embedding
        for layer in self.layers:
            x = layer(x)
        tokens = self.post_layernorm(x)
        return {"tokens": tokens, "pooled": self.head(tokens)}
