"""T5 v1.1 encoder (XXL class) in PyTorch: SD3's third text encoder.

Port of adv_grpo_tpu/models/t5.py (HF ``T5EncoderModel`` semantics):

  * ``T5LayerNorm``: RMS without mean or bias, computed in fp32 with an fp32
    weight, cast back to the compute dtype; applied before each sublayer;
  * the bidirectional relative-position bucket bias, layer 0's table shared
    by every block (UMT5, ``per_layer_rel_bias``: a table per block);
  * attention without the 1/sqrt(d) scale: the scores come out of the
    product in the compute dtype, then fp32 plus the bias, masked entries set
    to the fp32 minimum, an fp32 softmax, p cast back for the product with v;
  * the gated tanh-gelu feed-forward (``wi_0`` gelu times ``wi_1``, then
    ``wo``), no biases; no absolute positions; a final RMS norm.

Parameter names mirror the JAX tree (``blocks.{i}.q`` for its
``block_{i}/q``); ``models.convert.t5_state_dict_from_hf`` and
``t5_state_dict_from_jax`` fill them. The projections and the embedding
table are held in ``cfg.dtype`` (bf16 at full size: the JAX Dense casts its
kernels to that dtype at the product, the same rounding); the RMS weights and
the bias tables stay fp32. The JAX encoder is plain XLA, so this is plain
torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # UMT5 (WAN's text encoder): every block owns its relative-attention-bias
    # table; T5 v1.1 shares layer 0's across all
    per_layer_rel_bias: bool = False

    @classmethod
    def xxl(cls, **o):
        return cls(**o)

    @classmethod
    def umt5_xxl(cls, **o):
        d = dict(vocab_size=256384, per_layer_rel_bias=True)
        d.update(o)
        return cls(**d)

    @classmethod
    def tiny(cls, **o):
        d = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                 num_heads=4, dtype=torch.float32)
        d.update(o)
        return cls(**d)


def t5_relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """Bidirectional bucket mapping (HF T5 semantics), numpy in and out."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(self.dtype)


def _bias_table(cfg: T5Config, device):
    return nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads,
                                    dtype=torch.float32, device=device))


def _position_bias(table, buckets):
    """(buckets, heads) table, (S, S) bucket ids -> (1, heads, S, S) fp32."""
    return table[buckets].permute(2, 0, 1)[None]


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        if cfg.per_layer_rel_bias:
            self.relative_attention_bias = _bias_table(cfg, device)
        self.ln_attn = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype, device)
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        self.ln_ff = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype, device)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x, pos_bias, attn_mask, buckets=None):
        c = self.cfg
        if c.per_layer_rel_bias:
            pos_bias = _position_bias(self.relative_attention_bias, buckets)
        h = self.ln_attn(x)
        B, S, _ = h.shape
        q, k, v = (m(h).view(B, S, c.num_heads, c.d_kv).transpose(1, 2)
                   for m in (self.q, self.k, self.v))
        s = (q @ k.transpose(-1, -2)).float() + pos_bias
        if attn_mask is not None:
            s = s.masked_fill(~attn_mask[:, None, None, :], torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = (p @ v).transpose(1, 2).reshape(B, S, c.num_heads * c.d_kv)
        x = x + self.o(o)
        h = self.ln_ff(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h)


class T5Encoder(nn.Module):
    """input_ids (B, S), optional attention_mask (B, S) bool -> hidden
    (B, S, d_model) in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
                                            device=device)
        if not cfg.per_layer_rel_bias:
            self.relative_attention_bias = _bias_table(cfg, device)
        self.blocks = nn.ModuleList(T5Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, input_ids, attention_mask=None):
        c = self.cfg
        S = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        ctx = np.arange(S)
        buckets = torch.from_numpy(t5_relative_position_bucket(
            ctx[None, :] - ctx[:, None], c.relative_attention_num_buckets,
            c.relative_attention_max_distance)).to(x.device)
        pos_bias = (None if c.per_layer_rel_bias
                    else _position_bias(self.relative_attention_bias, buckets))
        for block in self.blocks:
            x = block(x, pos_bias, attention_mask, buckets=buckets)
        return self.final_ln(x)


def encode_with_length_mask(encoder: T5Encoder, input_ids, lengths):
    """T5 / UMT5 prompt embeddings with per-sample length masking: positions
    at or past each sample's length are masked in the attention and zeroed in
    the returned embeddings (the WAN text-embedding helper's semantics)."""
    S = input_ids.shape[1]
    pos = torch.arange(S, device=input_ids.device)[None, :]
    mask = pos < torch.as_tensor(lengths, device=input_ids.device)[:, None]
    hidden = encoder(input_ids, mask)
    return torch.where(mask[..., None], hidden, torch.zeros((), dtype=hidden.dtype,
                                                             device=hidden.device))
