"""Prompt datasets and the reference-image store of the training CLI.

The port's own copy of the three classes of adv_grpo_tpu/data/datasets.py
that ``cli.train`` reads:

  * ``TextPromptDataset``: one prompt per line of ``{split}.txt``;
  * ``GenevalPromptDataset``: ``{split}_metadata.jsonl``, one JSON object per
    line with a ``prompt`` field (the GenEval include/exclude specs ride along
    as metadata);
  * ``ReferenceImageStore``: prompt -> reference image files (a JSON map and
    an image directory), with the reference's fallback frame on a failed
    load; it decodes with PIL (the JAX package's path without its native
    loader).

``limit`` keeps the first ``limit`` prompts (the reference's ``config.limit``).
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Sequence

import numpy as np


class TextPromptDataset:
    def __init__(self, dataset_dir: str, split: str = "train",
                 limit: Optional[int] = None):
        with open(os.path.join(dataset_dir, f"{split}.txt")) as f:
            self.prompts = [line.strip() for line in f]
        if limit:
            self.prompts = self.prompts[: int(limit)]
        self.metadatas = [{} for _ in self.prompts]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return {"prompt": self.prompts[idx], "metadata": {}}


class GenevalPromptDataset:
    def __init__(self, dataset_dir: str, split: str = "train",
                 limit: Optional[int] = None):
        with open(os.path.join(dataset_dir, f"{split}_metadata.jsonl"),
                  encoding="utf-8") as f:
            self.metadatas = [json.loads(line) for line in f]
        if limit:
            self.metadatas = self.metadatas[: int(limit)]
        self.prompts = [m["prompt"] for m in self.metadatas]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return {"prompt": self.prompts[idx], "metadata": self.metadatas[idx]}


class ReferenceImageStore:
    """prompt -> reference images, float32 (R, 3, H, W) in [-1, 1], PIL
    BICUBIC-resized to ``resolution``. A prompt without images, or a file
    that fails to load, gets the fallback image (or a mid-grey frame) unless
    ``strict``. ``num_refs`` defaults to 1, as the JAX CLI builds it."""

    def __init__(self, json_path: str, image_dir: str, resolution: int = 512,
                 num_refs: int = 1, fallback_path: Optional[str] = None,
                 strict: bool = False):
        with open(json_path) as f:
            self.prompt2files = json.load(f)
        self.image_dir = image_dir
        self.resolution = resolution
        self.num_refs = num_refs
        self.fallback_path = fallback_path
        self.strict = strict

    def _load_one(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize(
            (self.resolution, self.resolution), Image.BICUBIC)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr.transpose(2, 0, 1) * 2.0 - 1.0

    def _fallback(self) -> np.ndarray:
        if self.fallback_path:
            try:
                return self._load_one(self.fallback_path)
            except Exception:
                pass
        return np.zeros((3, self.resolution, self.resolution), np.float32)

    def _choose(self, prompt: str, rng) -> Optional[List[str]]:
        """Resolved file paths for one prompt, or None (missing prompt)."""
        files = self.prompt2files.get(prompt)
        if not files:  # missing OR an empty list (failed generation run)
            if self.strict:
                raise KeyError(f"no reference images for prompt: {prompt!r}")
            return None
        if isinstance(files, str):
            files = [files]
        rng = rng or random
        chosen = (rng.sample(files, self.num_refs) if len(files) >= self.num_refs
                  else [rng.choice(files) for _ in range(self.num_refs)])
        return [f if os.path.isabs(f) else os.path.join(self.image_dir, f)
                for f in chosen]

    def _load(self, paths: Optional[List[str]]) -> np.ndarray:
        if paths is None:
            return np.stack([self._fallback()] * self.num_refs)
        out = []
        for path in paths:
            try:
                out.append(self._load_one(path))
            except Exception:
                if self.strict:
                    raise
                out.append(self._fallback())
        return np.stack(out)

    def get(self, prompt: str, rng: Optional[random.Random] = None) -> np.ndarray:
        """(num_refs, 3, H, W) for one prompt (sampled when more are on disk)."""
        return self._load(self._choose(prompt, rng))

    def get_batch(self, prompts: Sequence[str], rng=None) -> np.ndarray:
        """(B, num_refs, 3, H, W); every prompt's files are chosen before
        any is loaded, as the JAX store does."""
        per_prompt = [self._choose(p, rng) for p in prompts]
        return np.stack([self._load(paths) for paths in per_prompt])
