"""GRPO's arithmetic, plain: group advantages, the clipped-ratio loss and
the optimizer step (gradients averaged over the accumulation window, clipped
to a global norm, then AdamW with bias correction and decoupled weight
decay), as the paper's trainer (flow_grpo) and optax define them."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def advantages(rewards: np.ndarray, groups: np.ndarray, global_std: bool) -> np.ndarray:
    """(r - mean of its group) / (std + 1e-4); the std over all of this
    epoch's rewards with ``global_std``, else over the group's. The rewards
    are taken as float32, the precision the reference works in: where a
    group's rewards all but tie, its advantages are small and follow the
    rewards' last bits, so float64 rewards would part from any float32
    pipeline there by rounding alone."""
    r = np.asarray(np.asarray(rewards, np.float32), np.float64)
    out = np.zeros_like(r)
    for g in np.unique(groups):
        m = groups == g
        std = (np.std(r) if global_std else np.std(r[m])) + 1e-4
        out[m] = (r[m] - r[m].mean()) / std
    return out


def policy_loss(lp, lp_old, adv, clip_range: float, adv_clip_max: float):
    """mean(max(-A r, -A clip(r, 1 - eps, 1 + eps))), r = exp(lp - lp_old)."""
    a = adv.clamp(-adv_clip_max, adv_clip_max)
    ratio = torch.exp(lp - lp_old)
    return torch.maximum(-a * ratio, -a * ratio.clamp(1.0 - clip_range, 1.0 + clip_range))


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], hp: dict,
               step: int, mu=None, nu=None):
    """One step from the averaged ``grads``: clip to ``max_grad_norm`` (g *
    max / norm where norm >= max), AdamW. Returns (new params, the gradient
    as clipped, mu, nu)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
    c = hp["max_grad_norm"] / norm if norm >= hp["max_grad_norm"] else 1.0
    g = {k: v * c for k, v in grads.items()}
    mu = {k: torch.zeros_like(v) for k, v in g.items()} if mu is None else mu
    nu = {k: torch.zeros_like(v) for k, v in g.items()} if nu is None else nu
    b1, b2 = hp["b1"], hp["b2"]
    new = {}
    for k in params:
        mu[k] = b1 * mu[k] + (1 - b1) * g[k]
        nu[k] = b2 * nu[k] + (1 - b2) * g[k] ** 2
        upd = (mu[k] / (1 - b1 ** step)) / (torch.sqrt(nu[k] / (1 - b2 ** step)) + hp["eps"])
        new[k] = params[k] - hp["lr"] * (upd + hp["weight_decay"] * params[k])
    return new, g, mu, nu


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref):
    the gap between the two sides' norms of a leaf, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)
