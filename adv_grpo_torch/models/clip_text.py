"""CLIP text encoder in PyTorch: SD3's first two text encoders (CLIP-L and
OpenCLIP-bigG) and the text tower of the PickScore scorer.

Port of adv_grpo_tpu/models/clip_text.py (HF ``CLIPTextModelWithProjection``
semantics): token embedding plus learned positions, N pre-LN transformer
blocks under a causal mask, the final LayerNorm, and the pooled output taken
at each sequence's first EOS token through the text projection. The
parameter names mirror the JAX tree (``layers.{i}.q_proj`` for its
``layer_{i}/q_proj``), so ``models.convert.clip_dual_state_dict_from_jax``
carries its weights across.

Everything runs in fp32 as in the JAX model; the attention is plain
matmul + softmax (the JAX tower is plain XLA, not a kernel), the masked
scores filled with the fp32 minimum, and the LayerNorms are ``F.layer_norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"  # L: quick_gelu; bigG and H: gelu
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5

    @classmethod
    def clip_l(cls, **o):
        """OpenAI CLIP-L/14's text tower (SD3's ``text_encoder``): 12 layers
        of 768, quick_gelu."""
        return cls(**o)

    @classmethod
    def clip_g(cls, **o):
        """OpenCLIP-bigG/14's text tower (SD3's ``text_encoder_2``): 32
        layers of 1280, 20 heads, the erf gelu."""
        d = dict(hidden_size=1280, intermediate_size=5120, num_layers=32,
                 num_heads=20, projection_dim=1280, hidden_act="gelu",
                 eos_token_id=49407)
        d.update(o)
        return cls(**d)

    @classmethod
    def clip_h_text(cls, **o):
        """The PickScore CLIP-H/14 text tower: 24 layers of 1024, 16 heads."""
        d = dict(hidden_size=1024, intermediate_size=4096, num_layers=24,
                 num_heads=16, projection_dim=1024, hidden_act="gelu")
        d.update(o)
        return cls(**d)

    @classmethod
    def tiny(cls, **o):
        d = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_layers=2, num_heads=2, max_position_embeddings=16,
                 projection_dim=24, eos_token_id=63)
        d.update(o)
        return cls(**d)


def activation(name: str):
    """quick_gelu, gelu_pytorch_tanh (SigLIP's tanh approximation), or the
    exact (erf) gelu."""
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu_pytorch_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.gelu


def attention(q, k, v, mask=None):
    """(B, H, S, d) fp32 attention: scores scaled by d^-0.5, masked entries
    set to the fp32 minimum, softmax, then the values."""
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    return torch.softmax(s, dim=-1) @ v


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, device=device)
        self.act = activation(cfg.hidden_act)

    def forward(self, x, mask):
        B, S, D = x.shape
        nh = self.cfg.num_heads
        h = self.layer_norm1(x)
        q, k, v = (p(h).view(B, S, nh, D // nh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        o = attention(q, k, v, mask).transpose(1, 2).reshape(B, S, D)
        x = x + self.out_proj(o)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    """input_ids (B, S) -> (final hidden, penultimate hidden, pooled projection)."""

    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size, device=device))
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             device=device)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                         device=device)

    def forward(self, input_ids) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[:S]
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        penultimate = x
        for layer in self.layers:
            penultimate = x
            x = layer(x, causal)
        final = self.final_layer_norm(x)
        # the FIRST eos position (HF semantics); 0 where a row has none
        eos_pos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=1)
        pooled = final[torch.arange(B, device=x.device), eos_pos]
        return final, penultimate, self.text_projection(pooled)
