"""Weighted reward ensembles for the port's trainer.

Port of adv_grpo_tpu/rewards/registry.py's ``multi_score`` for the host
rewards: the images move to host numpy and the JAX package's own jax-free
host path scores them (the JPEG scorers), so both packages give the same
numbers. A device or co-trained reward (PickScore, CLIP, DINO, SigLIP, ...),
the OCR scorer and the remote judges are not ported yet and raise
``NotImplementedError`` naming the reward.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from adv_grpo_tpu.rewards.registry import RewardContext
from adv_grpo_tpu.rewards.registry import multi_score as _host_multi_score

HOST_REWARDS = ("jpeg_compressibility", "jpeg_incompressibility")


def multi_score(score_dict: Dict[str, float]):
    """fn(images (B, 3, H, W) in [-1, 1], prompts, metadata=None,
    ref_images=None, only_strict=True) -> (score_details incl. 'avg', {})."""
    for name in score_dict:
        if name not in HOST_REWARDS:
            raise NotImplementedError(
                f"reward {name!r} is not yet ported to adv_grpo_torch (ported: "
                f"{', '.join(HOST_REWARDS)})")
    score = _host_multi_score(dict(score_dict), RewardContext())

    def fn(images, prompts, metadata=None, ref_images=None, only_strict=True):
        if torch.is_tensor(images):
            images = images.detach().float().cpu().numpy()
        return score(np.asarray(images, np.float32), prompts, metadata,
                     ref_images=ref_images, only_strict=only_strict)

    return fn
