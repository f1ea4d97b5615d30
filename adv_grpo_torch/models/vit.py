"""Vision transformers in PyTorch: the CLIP image towers of the PickScore
scorer (CLIP-H/14), the CLIP score and the aesthetic scorer (CLIP-L/14), and
the DINOv2 backbone of the DINO discriminators.

Port of adv_grpo_tpu/models/vit.py. The CLIP path (HF
``CLIPVisionModelWithProjection`` semantics): the patch embedding as one
matmul over (gh, gw, p, p, 3)-flattened patches (the JAX order), the class
token and learned positions, ``pre_layernorm``, the pre-LN blocks,
``post_layernorm``, and ``visual_projection`` of the class token. The
DINOv2 path (``ViTConfig.dinov2_base``, timm ``vit_base_patch14_dinov2``):
no ``pre_layernorm``, LayerScale (``ls1`` scales the attention output after
``out_proj``, ``ls2`` the MLP output after ``fc2``), no projection, and
``capture_layers``: the raw outputs of the chosen blocks, before
``post_layernorm``. The parameter names mirror the JAX tree
(``layers.{i}.norm1`` for its ``layer_{i}/norm1``).

fp32 throughout, as in the JAX model; attention is the plain matmul +
softmax of ``models.clip_text.attention`` and the LayerNorms are
``F.layer_norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from adv_grpo_torch.models.clip_text import activation, attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16  # CLIP-H: head width 80
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    use_pre_ln: bool = True  # CLIP: True; DINOv2: False
    layer_scale_init: Optional[float] = None  # DINOv2: 1e-5
    projection_dim: Optional[int] = 1024  # None: no visual projection, no "pooled"

    @classmethod
    def clip_h(cls, **o):
        """The PickScore CLIP-H/14 vision tower at 224^2: 32 layers of 1280."""
        return cls(**o)

    @classmethod
    def clip_l(cls, **o):
        """The CLIP ViT-L/14 vision tower at 224^2 (the CLIP score and the
        LAION aesthetic scorer): 24 layers of 1024 in 16 heads, quick-GELU,
        projection 768."""
        d = dict(image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096,
                 num_layers=24, num_heads=16, projection_dim=768, hidden_act="quick_gelu")
        d.update(o)
        return cls(**d)

    @classmethod
    def dinov2_base(cls, **o):
        """DINOv2 ViT-B/14 at 518^2: 12 layers of 768 in 12 heads, 1,369
        patches."""
        d = dict(image_size=518, patch_size=14, hidden_size=768,
                 intermediate_size=3072, num_layers=12, num_heads=12,
                 layer_norm_eps=1e-6, use_pre_ln=False, layer_scale_init=1e-5,
                 projection_dim=None)
        d.update(o)
        return cls(**d)

    @classmethod
    def tiny(cls, **o):
        d = dict(image_size=28, patch_size=14, hidden_size=32,
                 intermediate_size=64, num_layers=2, num_heads=2,
                 projection_dim=16)
        d.update(o)
        return cls(**d)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, device=device)
        self.act = activation(cfg.hidden_act)
        if cfg.layer_scale_init is not None:
            self.ls1 = nn.Parameter(torch.empty(d, device=device))
            self.ls2 = nn.Parameter(torch.empty(d, device=device))

    def forward(self, x):
        B, S, D = x.shape
        nh = self.cfg.num_heads
        h = self.norm1(x)
        q, k, v = (p(h).view(B, S, nh, D // nh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        o = self.out_proj(attention(q, k, v).transpose(1, 2).reshape(B, S, D))
        if self.cfg.layer_scale_init is None:
            x = x + o
            return x + self.fc2(self.act(self.fc1(self.norm2(x))))
        x = x + o * self.ls1
        return x + self.fc2(self.act(self.fc1(self.norm2(x)))) * self.ls2


class VisionTransformer(nn.Module):
    """pixel_values (B, 3, H, W) -> {"tokens", "cls", "tokens_pre_norm",
    "pooled"}: the post-LN tokens, their class token, the tokens before
    ``post_layernorm`` (HF's ``last_hidden_state``) and the projected class
    token (only with a ``projection_dim``); with ``capture_layers`` also
    "layer_tokens": {layer index: that block's output}."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(p * p * 3, d, device=device)
        self.class_embedding = nn.Parameter(torch.empty(d, device=device))
        self.position_embedding = nn.Parameter(torch.empty(1 + cfg.num_patches, d,
                                                           device=device))
        if cfg.use_pre_ln:
            self.pre_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.layers = nn.ModuleList(ViTBlock(cfg, device) for _ in range(cfg.num_layers))
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        if cfg.projection_dim is not None:
            self.visual_projection = nn.Linear(d, cfg.projection_dim, bias=False,
                                               device=device)

    def forward(self, pixel_values, layers=None,
                capture_layers: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
        """``layers``: the blocks to run in place of ``self.layers``."""
        B, _, H, W = pixel_values.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        x = pixel_values.permute(0, 2, 3, 1)  # NHWC
        x = x.reshape(B, gh, p, gw, p, 3).transpose(2, 3).reshape(B, gh * gw, p * p * 3)
        x = self.patch_embed(x)
        x = torch.cat([self.class_embedding.expand(B, 1, -1), x], dim=1)
        x = x + self.position_embedding[:x.shape[1]]
        if self.cfg.use_pre_ln:
            x = self.pre_layernorm(x)
        captured = {}
        for i, layer in enumerate(self.layers if layers is None else layers):
            x = layer(x)
            if i in capture_layers:
                captured[i] = x
        tokens = self.post_layernorm(x)
        out = {"tokens": tokens, "cls": tokens[:, 0], "tokens_pre_norm": x}
        if captured:
            out["layer_tokens"] = captured
        if self.cfg.projection_dim is not None:
            out["pooled"] = self.visual_projection(tokens[:, 0])
        return out
