"""Precomputed text-embedding store (memmap-backed), reader side.

The port's own copy of ``EmbeddingStore`` from adv_grpo_tpu/data/embed_store.py.
A store directory (written by the JAX package's ``cli.precompute_embeds``)
holds ``prompts.json`` (row i <-> prompt i), ``embeds.npy`` (N, S, joint_dim)
and ``pooled.npy`` (N, pooled_dim), both fp16 memmaps. The store is a drop-in
for the ``encode(prompts) -> (embeds, pooled)`` callable the CLIs consume.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


class EmbeddingStore:
    def __init__(self, store_dir: str):
        with open(os.path.join(store_dir, "prompts.json")) as f:
            prompts: List[str] = json.load(f)
        self.index: Dict[str, int] = {p: i for i, p in enumerate(prompts)}
        self.embeds = np.load(os.path.join(store_dir, "embeds.npy"), mmap_mode="r")
        self.pooled = np.load(os.path.join(store_dir, "pooled.npy"), mmap_mode="r")
        if len(self.index) != self.embeds.shape[0]:
            raise ValueError(f"{store_dir}: prompts.json has {len(self.index)} unique "
                             f"prompts but embeds.npy has {self.embeds.shape[0]} rows")
        self.store_dir = store_dir

    def __call__(self, prompts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(embeds, pooled) as fp32 for ``prompts``; an unknown prompt raises."""
        rows = []
        for p in prompts:
            if p not in self.index:
                raise KeyError(f"prompt not in the precomputed store ({self.store_dir}): "
                               f"{p!r}")
            rows.append(self.index[p])
        rows = np.asarray(rows)
        return (np.asarray(self.embeds[rows], np.float32),
                np.asarray(self.pooled[rows], np.float32))
