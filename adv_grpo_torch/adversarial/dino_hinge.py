"""DINO discriminator hinge losses (CLS + random-patch level, and the
multi-layer top-k topology).

Port of adv_grpo_tpu/adversarial/dino_hinge.py (the reference ``train_dino``,
scripts/train_sd3_fast_dino_patch.py:156-232): a frozen DINOv2 backbone and a
small trainable head scored on real (reference) against fake (generated)
images:

  image_loss = 0.5 * (mean relu(1 - head(cls_real)) + mean relu(1 + head(cls_fake)))
  patch_loss = the same over ``n_patches`` patch tokens drawn per image
  d_loss     = image_loss + patch_loss_weight * patch_loss
  accuracy   = 0.5 * (mean(head(cls_real) > 0) + mean(head(cls_fake) < 0))

The JAX loss draws the patch indices from a key inside; here they are
arguments (``idx_r``, ``idx_f``: (B, n_sel) indices into the N patch tokens),
drawn by the caller (``rewards.scorers.DINOScorer.draw_patch_indices``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F


class DinoDStepResult(NamedTuple):
    loss: torch.Tensor
    image_loss: torch.Tensor
    patch_loss: torch.Tensor
    accuracy: torch.Tensor


def _hinge(logit_r, logit_f):
    return 0.5 * (F.relu(1.0 - logit_r).mean() + F.relu(1.0 + logit_f).mean())


def _accuracy(logit_r, logit_f):
    with torch.no_grad():
        return 0.5 * ((logit_r > 0).float().mean() + (logit_f < 0).float().mean())


def take_patches(patches, idx):
    """(B, N, D) patch tokens, (B, n) indices -> the (B, n, D) chosen ones."""
    return torch.gather(patches, 1, idx[..., None].expand(-1, -1, patches.shape[-1]))


def dino_hinge_loss(head: Callable, tokens_real, tokens_fake, idx_r, idx_f,
                    patch_loss_weight: float = 0.3) -> DinoDStepResult:
    """tokens_*: (B, 1+N, D) frozen backbone features (CLS at index 0);
    ``head`` maps (..., D) to (...) logits."""
    logit_r, logit_f = head(tokens_real[:, 0]), head(tokens_fake[:, 0])
    image_loss = _hinge(logit_r, logit_f)
    patch_loss = _hinge(head(take_patches(tokens_real[:, 1:], idx_r)),
                        head(take_patches(tokens_fake[:, 1:], idx_f)))
    loss = image_loss + patch_loss_weight * patch_loss
    return DinoDStepResult(loss, image_loss, patch_loss, _accuracy(logit_r, logit_f))


def multi_layer_logit(heads: Sequence[Callable], fusion: Callable, layer_tokens,
                      topk_tau: float = 0.2):
    """The dino_multi scoring topology: per layer, the head's logits of the
    patch tokens (B, N), the mean of their top k = max(1, int(N * tau)),
    then the fusion of the (B, T) stack -> (B,) logits."""
    pooled = []
    for head, tokens in zip(heads, layer_tokens):
        logits = head(tokens[:, 1:])
        k = max(1, int(logits.shape[1] * topk_tau))
        pooled.append(torch.topk(logits, k, dim=1).values.mean(1))
    return fusion(torch.stack(pooled, 1)).squeeze(-1)


def dino_multi_hinge_loss(heads: Sequence[Callable], fusion: Callable, layer_tokens_real,
                          layer_tokens_fake, topk_tau: float = 0.2) -> DinoDStepResult:
    """The hinge through the dino_multi topology, training the heads and the
    fusion together; layer_tokens_*: one (B, 1+N, D) stack per layer, in the
    order of ``heads``."""
    logit_r = multi_layer_logit(heads, fusion, layer_tokens_real, topk_tau)
    logit_f = multi_layer_logit(heads, fusion, layer_tokens_fake, topk_tau)
    loss = _hinge(logit_r, logit_f)
    return DinoDStepResult(loss, loss, torch.zeros_like(loss), _accuracy(logit_r, logit_f))
