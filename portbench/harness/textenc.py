"""The prompt encoder both sides are given: a deterministic per-prompt
N(0, 0.2) table at the text encoders' published widths (a frozen copy of
``adv_grpo_torch/cli/common.py::make_hash_text_encoder``), standing in for
CLIP-L + CLIP-G + T5-XXL (or UMT5) as an embedding store would."""

from __future__ import annotations

import functools
import zlib
from typing import List

import numpy as np


def make_hash_text_encoder(seq_len: int, embed_dim: int, pooled_dim: int):
    """encode(prompts) -> (embeds (B, seq_len, embed_dim), pooled (B,
    pooled_dim)) float32 numpy, seeded by each prompt's crc32."""

    @functools.lru_cache(maxsize=4096)
    def _one(prompt: str):
        rng = np.random.default_rng(zlib.crc32(prompt.encode()))
        return (rng.normal(0, 0.2, (seq_len, embed_dim)).astype(np.float32),
                rng.normal(0, 0.2, (pooled_dim,)).astype(np.float32))

    def encode(prompts: List[str]):
        pairs = [_one(p) for p in prompts]
        return np.stack([e for e, _ in pairs]), np.stack([p for _, p in pairs])

    return encode
