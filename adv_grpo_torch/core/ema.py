"""Exponential moving average of the LoRA parameters.

Port of adv_grpo_tpu/core/ema.py: the warmup decay ``min((1 + step) / (10 +
step), decay)`` and the update ``ema += (1 - decay_t) * (p - ema)``, on flat
``{path: tensor}`` dicts, updated in place. The schedule arithmetic runs in
fp32 as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch


def ema_decay_at(step: int, decay: float) -> torch.Tensor:
    """Warmup-capped decay as an fp32 scalar tensor."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return torch.minimum((1.0 + s) / (10.0 + s), torch.tensor(decay, dtype=torch.float32))


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The EMA shadow: a detached copy of ``params``."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update_(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                one_minus_decay) -> None:
    """ema += one_minus_decay * (p - ema), in place, for every key."""
    for k, e in ema.items():
        e.add_(one_minus_decay.to(e) * (params[k].detach().to(e.dtype) - e))
