"""Weighted reward ensembles for the port's trainer.

Port of adv_grpo_tpu/rewards/registry.py's ``multi_score`` for the host
rewards: the images move to host numpy, are packed to uint8 once and scored
by the JPEG scorers (``rewards/host.py``); ``'avg'`` is the weight-summed
ensemble, as in the JAX package. A device or co-trained reward (PickScore,
CLIP, DINO, SigLIP, ...), the OCR scorer and the remote judges are not ported
yet and raise ``NotImplementedError`` naming the reward.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from adv_grpo_torch.rewards.host import jpeg_compressibility, jpeg_incompressibility
from adv_grpo_torch.utils.images import images_to_uint8

HOST_REWARDS = {"jpeg_compressibility": jpeg_compressibility,
                "jpeg_incompressibility": jpeg_incompressibility}


def multi_score(score_dict: Dict[str, float]):
    """fn(images (B, 3, H, W) or video (B, F, 3, H, W) in [-1, 1], prompts,
    metadata=None, ref_images=None, only_strict=True) -> (score_details incl.
    'avg', {})."""
    for name in score_dict:
        if name not in HOST_REWARDS:
            raise NotImplementedError(
                f"reward {name!r} is not yet ported to adv_grpo_torch (ported: "
                f"{', '.join(HOST_REWARDS)})")
    score_dict = dict(score_dict)

    def fn(images, prompts, metadata=None, ref_images=None, only_strict=True):
        if torch.is_tensor(images):
            images = images.detach().float().cpu().numpy()
        arr = np.asarray(images, np.float32)
        if arr.ndim == 5:  # video (B, F, 3, H, W): frame by frame
            u8 = images_to_uint8(arr.reshape((-1,) + arr.shape[-3:]))
            u8 = u8.reshape(arr.shape[:2] + u8.shape[1:])
        else:
            u8 = images_to_uint8(arr)
        details: Dict[str, Any] = {}
        total = None
        for name, weight in score_dict.items():
            scores = np.asarray(HOST_REWARDS[name](u8), dtype=np.float64)
            details[name] = scores
            total = weight * scores if total is None else total + weight * scores
        details["avg"] = total
        return details, {}

    return fn
