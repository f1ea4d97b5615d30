"""Prompt datasets of the training CLI.

The port's own copy of the two dataset classes of
adv_grpo_tpu/data/datasets.py that ``cli.train`` reads:

  * ``TextPromptDataset``: one prompt per line of ``{split}.txt``;
  * ``GenevalPromptDataset``: ``{split}_metadata.jsonl``, one JSON object per
    line with a ``prompt`` field (the GenEval include/exclude specs ride along
    as metadata).

``limit`` keeps the first ``limit`` prompts (the reference's ``config.limit``).
"""

from __future__ import annotations

import json
import os
from typing import Optional


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
