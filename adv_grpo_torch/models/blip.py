"""The BLIP text encoder and the ImageReward model, in PyTorch.

Port of adv_grpo_tpu/models/blip.py (the ImageReward repo's
ImageReward/ImageReward.py through the pip package's ``inference_rank``): a
BLIP med-BERT text encoder that cross-attends to frozen ViT-L/16 image
tokens in every layer, the text CLS through a linear MLP, the score
z-normalised with the published mean and std.

  * text: BERT-base, post-LN (``out = LN(x + dense(attn(x)))``), the
    self-attention bidirectional with the padding mask (masked scores set
    to the fp32 minimum), the cross-attention unmasked; exact GELU;
  * image: ``models.vit.VisionTransformer`` as timm's BLIP ViT-L/16 at 224^2
    (class token, no ``pre_layernorm``, no LayerScale), CLIP mean / std;
  * ``ImageRewardHead``: 768 -> 1024 -> 128 -> 64 -> 16 -> 1 with no
    activations (the original's only other layers are dropouts).

The parameter names mirror the JAX tree (``layers.{i}.self_attn.query`` for
its ``layer_{i}/self_attn/query``). fp32 throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.models.aesthetic import WIDTHS, AestheticHead
from adv_grpo_torch.models.clip_text import attention
from adv_grpo_torch.models.vit import ViTConfig, VisionTransformer

# the published z-normalisation (ImageReward repo, ImageReward.py)
IMAGEREWARD_MEAN = 0.16717362830052426
IMAGEREWARD_STD = 1.0333394966054072


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524  # bert-base-uncased's 30,522 and [DEC], [ENC]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 1024  # the image tokens' width (cross-attention keys)
    layer_norm_eps: float = 1e-12

    @classmethod
    def med_base(cls, **o):
        return cls(**o)

    @classmethod
    def tiny(cls, **o):
        d = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=16, encoder_width=24)
        d.update(o)
        return cls(**d)


def blip_vit_l16(image_size: int = 224, **o) -> ViTConfig:
    """BLIP's timm ViT-L/16: 24 layers of 1024 in 16 heads, exact GELU,
    eps 1e-6, no ``pre_layernorm``, LayerScale or projection."""
    d = dict(image_size=image_size, patch_size=16, hidden_size=1024, intermediate_size=4096,
             num_layers=24, num_heads=16, layer_norm_eps=1e-6, use_pre_ln=False,
             layer_scale_init=None, projection_dim=None)
    d.update(o)
    return ViTConfig(**d)


class BertAttention(nn.Module):
    """Post-LN BERT attention: LN(x + dense(attn(x, kv))); the
    cross-attention is the same module with keys and values from the image
    tokens (width ``kv_dim``)."""

    def __init__(self, cfg: BlipTextConfig, kv_dim: int, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(kv_dim, d, device=device)
        self.value = nn.Linear(kv_dim, d, device=device)
        self.out_dense = nn.Linear(d, d, device=device)
        self.out_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x, kv, mask=None):
        """``mask``: (B, S_kv) bool, True where a key is attended to."""
        B, S, D = x.shape
        nh = self.cfg.num_heads
        q = self.query(x).view(B, S, nh, D // nh).transpose(1, 2)
        k, v = (p(kv).view(B, kv.shape[1], nh, D // nh).transpose(1, 2)
                for p in (self.key, self.value))
        o = attention(q, k, v, None if mask is None else mask[:, None, None, :])
        return self.out_ln(x + self.out_dense(o.transpose(1, 2).reshape(B, S, D)))


class BlipTextLayer(nn.Module):
    def __init__(self, cfg: BlipTextConfig, cross_attention: bool = True, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = BertAttention(cfg, d, device)
        if cross_attention:
            self.cross_attn = BertAttention(cfg, cfg.encoder_width, device)
        self.intermediate = nn.Linear(d, cfg.intermediate_size, device=device)
        self.output = nn.Linear(cfg.intermediate_size, d, device=device)
        self.output_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x, image_tokens, mask):
        x = self.self_attn(x, x, mask)
        if image_tokens is not None:
            x = self.cross_attn(x, image_tokens)
        return self.output_ln(x + self.output(F.gelu(self.intermediate(x))))


class BlipTextEncoder(nn.Module):
    """input_ids (B, S) [+ cross-attention to image tokens (B, N, encoder
    width) in every layer] -> (B, S, D). Bidirectional, never causal.
    ``cross_attention=False`` builds the layers without their
    cross-attention (a text-only checkpoint has none)."""

    def __init__(self, cfg: BlipTextConfig, cross_attention: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size, device=device))
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.layers = nn.ModuleList(BlipTextLayer(cfg, cross_attention, device)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask=None, image_tokens=None):
        x = self.word_embeddings(input_ids) + self.position_embeddings[:input_ids.shape[1]]
        x = self.embeddings_ln(x)
        for layer in self.layers:
            x = layer(x, image_tokens, attention_mask)
        return x


class ImageRewardHead(AestheticHead):
    """768 -> 1024 -> 128 -> 64 -> 16 -> 1, linear: the aesthetic head's
    stack (``fc0``-``fc3``, ``out``) without its L2 normalisation of the
    input; (B, D) -> (B,)."""

    def forward(self, x):
        for i in range(len(WIDTHS)):
            x = getattr(self, f"fc{i}")(x)
        return self.out(x).squeeze(-1)


class ImageRewardModel(nn.Module):
    """``vision`` (the BLIP ViT), ``text`` (the med-BERT) and ``head``;
    ``score(images, input_ids, attention_mask)`` is the z-normalised reward
    (the pip package's ``inference_rank`` score)."""

    def __init__(self, text_cfg: Optional[BlipTextConfig] = None,
                 vision_cfg: Optional[ViTConfig] = None, image_size: Optional[int] = None,
                 device=None):
        """``image_size``: the preprocessing's (the ViT's by default, 224)."""
        super().__init__()
        self.text_cfg = text_cfg or BlipTextConfig.med_base()
        self.vision_cfg = vision_cfg or blip_vit_l16(image_size or 224)
        self.image_size = image_size or self.vision_cfg.image_size
        self.vision = VisionTransformer(self.vision_cfg, device)
        self.text = BlipTextEncoder(self.text_cfg, device=device)
        self.head = ImageRewardHead(self.text_cfg.hidden_size, device)

    @torch.no_grad()
    def score(self, images, input_ids, attention_mask=None):
        """``images`` (B, 3, H, W) in [-1, 1] (numpy or torch), ``input_ids``
        (B, S), ``attention_mask`` (B, S) (True / 1 where a token is real)."""
        from adv_grpo_torch.rewards.preprocess import CLIP_MEAN, CLIP_STD, preprocess

        device = self.head.out.weight.device
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        pix = preprocess(images.to(device, torch.float32), self.image_size, CLIP_MEAN, CLIP_STD)
        tokens = self.vision(pix)["tokens"]
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(device)
        mask = None
        if attention_mask is not None:
            mask = torch.as_tensor(np.asarray(attention_mask)).to(device).bool()
        hidden = self.text(ids, mask, tokens)
        return (self.head(hidden[:, 0]) - IMAGEREWARD_MEAN) / IMAGEREWARD_STD
