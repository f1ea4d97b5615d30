"""Per-prompt reward statistics -> advantages (host side, numpy).

The port's own copy of adv_grpo_tpu/core/stat_tracking.py, the behavioural
re-implementation of the reference ``PerPromptStatTracker``:

  * rewards accumulate per prompt across ``update`` calls of an epoch, and a
    prompt's advantages are normalised over its accumulated group;
  * ``global_std=True`` divides by the std of ALL rewards of the current call
    (+1e-4) instead of the group's;
  * advantage types: 'grpo' (z-score), 'rwr' (raw reward), 'sft' (1 at the
    group maxima), 'dpo' (+1 at argmax, -1 at argmin; an all-equal group
    takes indices 1 / 0 like the reference);
  * ``get_stats`` -> (mean group size, distinct prompts ever seen); ``clear``
    drops the epoch's stats and keeps the prompt history.
"""

from __future__ import annotations

import numpy as np


class PerPromptStatTracker:
    def __init__(self, global_std: bool = False):
        self.global_std = global_std
        self.stats: dict = {}
        self.history_prompts: set = set()

    def update(self, prompts, rewards, type: str = "grpo") -> np.ndarray:
        prompts = np.array(prompts)
        rewards = np.array(rewards, dtype=np.float64)
        unique = np.unique(prompts)
        advantages = np.zeros_like(rewards)
        for prompt in unique:
            self.stats.setdefault(prompt, [])
            self.stats[prompt].extend(rewards[prompts == prompt])
            self.history_prompts.add(hash(prompt))
        for prompt in unique:
            group = np.stack(self.stats[prompt])
            mask = prompts == prompt
            prompt_rewards = rewards[mask]
            if type == "grpo":
                mean = np.mean(group, axis=0, keepdims=True)
                std = np.std(rewards if self.global_std else group, axis=0,
                             keepdims=True) + 1e-4
                advantages[mask] = (prompt_rewards - mean) / std
            elif type == "rwr":
                advantages[mask] = prompt_rewards
            elif type == "sft":
                advantages[mask] = (prompt_rewards == np.max(prompt_rewards)).astype(np.float64)
            elif type == "dpo":
                max_idx = int(np.argmax(prompt_rewards))
                min_idx = int(np.argmin(prompt_rewards))
                if max_idx == min_idx:
                    min_idx, max_idx = 0, 1
                result = np.zeros_like(prompt_rewards)
                result[max_idx] = 1.0
                result[min_idx] = -1.0
                advantages[mask] = result
            else:
                raise ValueError(f"unknown advantage type: {type!r}")
        return advantages

    def get_stats(self):
        avg_group_size = (sum(len(v) for v in self.stats.values()) / len(self.stats)
                          if self.stats else 0)
        return avg_group_size, len(self.history_prompts)

    def clear(self) -> None:
        self.stats = {}


def calculate_zero_std_ratio(prompts, rewards) -> tuple[float, float]:
    """Fraction of prompt groups whose rewards have zero std, and the mean
    group std (reference train_sd3_fast_pickscore.py:195-229)."""
    prompt_array = np.array(prompts)
    rewards = np.asarray(rewards, dtype=np.float64)
    _, inverse_indices, counts = np.unique(prompt_array, return_inverse=True,
                                           return_counts=True)
    grouped = rewards[np.argsort(inverse_indices)]
    groups = np.split(grouped, np.cumsum(counts)[:-1])
    stds = np.array([np.std(g) for g in groups])
    return float(np.count_nonzero(stds == 0) / len(stds)), float(stds.mean())
