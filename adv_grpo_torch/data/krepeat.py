"""Distributed K-repeat prompt sampling (host side, numpy).

The port's own copy of adv_grpo_tpu/data/krepeat.py, the reference
``DistributedKRepeatSampler`` (scripts/train_sd3_fast_pickscore.py:87-129):
every rank draws the same seeded choice of ``m`` unique dataset indices per
epoch step, each repeated ``k`` times; the ``m*k`` indices are shuffled with
the same seed and sliced per rank, so one prompt's group of ``k`` images spans
``k / batch_size`` ranks.
"""

from __future__ import annotations

import numpy as np


class DistributedKRepeatSampler:
    def __init__(self, dataset_size: int, batch_size: int, k: int, num_replicas: int,
                 rank: int, seed: int = 0):
        """batch_size: prompts per rank per step; k: repeats of each unique
        prompt (the group size across ranks)."""
        total_samples = batch_size * num_replicas
        if total_samples % k != 0:
            raise ValueError(f"total per-step samples ({batch_size}x{num_replicas}) must "
                             f"be divisible by k={k}")
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.k = k
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.m = total_samples // k  # unique prompts per step

    def batch_for_epoch(self, epoch: int) -> np.ndarray:
        """This rank's (batch_size,) dataset indices at ``epoch``: every rank
        computes the same global permutation and takes its contiguous shard."""
        g = np.random.default_rng(self.seed + epoch)
        indices = g.choice(self.dataset_size, size=self.m, replace=False)
        repeated = np.repeat(indices, self.k)
        shuffled = repeated[g.permutation(len(repeated))]
        start = self.rank * self.batch_size
        return shuffled[start: start + self.batch_size]
