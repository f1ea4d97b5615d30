"""GRPO clipped-ratio policy loss, its diagnostics, and group advantages.

Port of adv_grpo_tpu/core/grpo.py (``grpo_loss`` :31, ``group_advantages``
:88). Differentiable with respect to ``log_prob`` (and the KL means); the old
log-probs, advantages and reference means enter detached.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GRPOLossResult(NamedTuple):
    loss: torch.Tensor  # scalar: policy_loss + beta * kl_loss
    policy_loss: torch.Tensor  # scalar
    kl_loss: torch.Tensor  # scalar (0 when beta == 0)
    approx_kl: torch.Tensor  # 0.5 * mean((lp - lp_old)^2)
    clipfrac: torch.Tensor  # mean(|ratio - 1| > clip_range)
    clipfrac_gt_one: torch.Tensor  # mean(ratio - 1 > clip_range)
    clipfrac_lt_one: torch.Tensor  # mean(1 - ratio > clip_range)
    ratio: torch.Tensor  # (B,)


def grpo_loss(log_prob, old_log_prob, advantages, *, clip_range: float,
              adv_clip_max: float, beta: float = 0.0,
              prev_sample_mean: Optional[torch.Tensor] = None,
              prev_sample_mean_ref: Optional[torch.Tensor] = None) -> GRPOLossResult:
    """Clipped-ratio GRPO objective for one timestep minibatch:

      advantages clamped to [-adv_clip_max, adv_clip_max];
      ratio = 1 + expm1(lp - lp_old) (exact near 1, where clip_range ~1e-5
      puts the whole signal);
      loss = mean(max(-A * ratio, -A * clip(ratio, 1 - eps, 1 + eps)));
      kl_loss = mean(mean_chw((mean - mean_ref)^2))  when beta > 0.
    """
    lp = log_prob.float()
    lp_old = old_log_prob.detach().float()
    adv = advantages.detach().float().clamp(-adv_clip_max, adv_clip_max)

    ratio = 1.0 + torch.expm1(lp - lp_old)
    unclipped = -adv * ratio
    clipped = -adv * ratio.clamp(1.0 - clip_range, 1.0 + clip_range)
    policy_loss = torch.maximum(unclipped, clipped).mean()

    if beta > 0.0:
        if prev_sample_mean is None or prev_sample_mean_ref is None:
            raise ValueError("beta > 0 requires prev_sample_mean and prev_sample_mean_ref")
        diff = prev_sample_mean.float() - prev_sample_mean_ref.detach().float()
        kl_loss = (diff ** 2).mean(dim=tuple(range(1, diff.ndim))).mean()
        loss = policy_loss + beta * kl_loss
    else:
        kl_loss = torch.zeros((), device=lp.device)
        loss = policy_loss

    d = lp - lp_old
    return GRPOLossResult(
        loss, policy_loss, kl_loss, 0.5 * (d * d).mean(),
        ((ratio - 1.0).abs() > clip_range).float().mean(),
        (ratio - 1.0 > clip_range).float().mean(),
        (1.0 - ratio > clip_range).float().mean(), ratio)


def group_advantages(rewards, group_ids, num_groups: int, *, global_std: bool = False,
                     eps: float = 1e-4):
    """GRPO advantages by segment sums: per-group mean, per-group (or global)
    population std + eps, advantage = (r - mean) / std. ``group_ids`` (long)
    maps each reward to its prompt group in [0, num_groups)."""
    r = rewards.float()
    counts = torch.zeros(num_groups, device=r.device).index_add_(
        0, group_ids, torch.ones_like(r)).clamp_min(1.0)
    means = torch.zeros(num_groups, device=r.device).index_add_(0, group_ids, r) / counts
    centered = r - means[group_ids]
    if global_std:
        return centered / (r.std(unbiased=False) + eps)
    var = torch.zeros(num_groups, device=r.device).index_add_(
        0, group_ids, centered ** 2) / counts
    return centered / (var.sqrt() + eps)[group_ids]
