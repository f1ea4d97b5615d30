"""Precomputed text-embedding store (memmap-backed).

The port's own copy of ``EmbeddingStore`` and ``write_store`` from
adv_grpo_tpu/data/embed_store.py. A store directory (written by
``cli.precompute_embeds`` of either package) holds ``prompts.json`` (row i <-> prompt i), ``embeds.npy`` (N, S, joint_dim)
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


def write_store(store_dir: str, prompts: List[str], encode_fn,
                batch_size: int = 32, dtype=np.float16,
                progress: bool = False) -> str:
    """Encode ``prompts`` (deduplicated, order-preserving) with ``encode_fn``
    and write the store. Streams through a memmap so the full fp32 embedding
    set never lives in host RAM (25k prompts x 154 x 4096 fp32 = 63GB)."""
    seen = {}
    for p in prompts:
        seen.setdefault(p, len(seen))
    uniq = list(seen)
    os.makedirs(store_dir, exist_ok=True)

    n = len(uniq)
    embeds = pooled = None
    for start in range(0, n, batch_size):
        chunk = uniq[start:start + batch_size]
        # fixed batch: pad with the last prompt, so the encoders see one
        # shape, the ragged final chunk too
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        e, p = encode_fn(padded)
        if embeds is None:
            # shapes come from the first real batch
            embeds = np.lib.format.open_memmap(
                os.path.join(store_dir, "embeds.npy"), mode="w+", dtype=dtype,
                shape=(n,) + tuple(np.shape(e)[1:]))
            pooled = np.lib.format.open_memmap(
                os.path.join(store_dir, "pooled.npy"), mode="w+", dtype=dtype,
                shape=(n,) + tuple(np.shape(p)[1:]))
        embeds[start:start + len(chunk)] = np.asarray(
            e[: len(chunk)], dtype)
        pooled[start:start + len(chunk)] = np.asarray(
            p[: len(chunk)], dtype)
        if progress and (start // batch_size) % 50 == 0:
            print(f"encoded {min(start + batch_size, n)}/{n}", flush=True)
    embeds.flush()
    pooled.flush()
    with open(os.path.join(store_dir, "prompts.json"), "w") as f:
        json.dump(uniq, f)
    return store_dir
