"""Adversarial PickScore training: the CLIP preference cross-entropy.

Port of adv_grpo_tpu/adversarial/clip_criterion.py (the reference
CLIPCriterion, adv_grpo/pick_score_training.py:89-224):

  features: L2-normalised text / image embeddings; images stacked [good ; bad]
  logits  : logit_scale * text @ images^T
  pairwise mode (in_batch_negatives=False, the trainers' mode): a 2-way CE
  per sample over (own good, own bad), weighted by (label_0, label_1), and
  log(0.5) added for a tie; in-batch mode: CE against all images plus the
  image-side CE, averaged.

Distributed: with a ``group`` the features and labels are gathered from every
rank differentiably (``parallel.mesh.all_gather_dim0_with_grad``, whose
backward reduce-scatters the gradient: the JAX ``all_gather`` under an
``axis_name``, the reference's ``torch.distributed.nn.all_gather``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from adv_grpo_torch.parallel import mesh


class CLIPCriterionBatch(NamedTuple):
    text_features: torch.Tensor  # (B, D) normalised
    image_0_features: torch.Tensor  # (B, D) normalised ("good" / real)
    image_1_features: torch.Tensor  # (B, D) normalised ("bad" / fake)
    label_0: torch.Tensor  # (B,)
    label_1: torch.Tensor  # (B,)


def clip_criterion_loss(batch: CLIPCriterionBatch, logit_scale, *,
                        in_batch_negatives: bool = False, group=None):
    """The mean criterion over the batch; with ``group`` (a process group,
    e.g. ``torch.distributed.group.WORLD``; the JAX ``axis_name``) over the
    batch gathered from its ranks."""
    t, i0, i1 = batch.text_features, batch.image_0_features, batch.image_1_features
    l0, l1 = batch.label_0.float(), batch.label_1.float()
    if group is not None:
        t, i0, i1, l0, l1 = (mesh.all_gather_dim0_with_grad(x, group)
                             for x in (t, i0, i1, l0, l1))
    all_img = torch.cat([i0, i1], dim=0)  # (2B, D)
    text_logits = logit_scale * t @ all_img.T  # (B, 2B)
    B = t.shape[0]
    idx = torch.arange(B, device=t.device)

    def ce(logits, labels):
        return -torch.log_softmax(logits, dim=-1)[torch.arange(logits.shape[0]), labels]

    if in_batch_negatives:
        img0_logits, img1_logits = (logit_scale * all_img @ t.T).split(B, dim=0)
        image_loss = l0 * ce(img0_logits, idx) + l1 * ce(img1_logits, idx)
        text_0_loss = ce(text_logits, idx)  # own image_0 (index i)
        text_1_loss = ce(text_logits, idx + B)  # own image_1 (index B + i)
    else:
        pair = torch.stack([text_logits[idx, idx], text_logits[idx, idx + B]], dim=-1)
        logp = torch.log_softmax(pair, dim=-1)
        text_0_loss, text_1_loss = -logp[:, 0], -logp[:, 1]
    text_loss = l0 * text_0_loss + l1 * text_1_loss
    # tie correction: the ideal tie loss is 0 (reference :183-185)
    text_loss = text_loss + (l0 == l1).float() * math.log(0.5)
    if in_batch_negatives:
        return ((image_loss + text_loss) / 2.0).mean()
    return text_loss.mean()


def pickscore_d_step_loss_and_acc(scorer, images_real, images_fake, input_ids, *, tail=None,
                                  group=None, in_batch_negatives: bool = False):
    """The D-step loss through the live scorer, labels (1, 0) for (real,
    fake), and the preference accuracy: the share of this rank's pairs in
    which the real image scores above the generated one (a detached
    diagnostic, never gathered)."""
    img_r, txt = scorer.features(images_real, input_ids, tail)
    img_f, _ = scorer.features(images_fake, input_ids, tail)
    ones = torch.ones(txt.shape[0], device=txt.device)
    batch = CLIPCriterionBatch(txt, img_r, img_f, ones, torch.zeros_like(ones))
    loss = clip_criterion_loss(batch, torch.exp(scorer.clip.logit_scale), group=group,
                               in_batch_negatives=in_batch_negatives)
    with torch.no_grad():  # logit_scale cancels in the comparison
        acc = ((txt * img_r).sum(-1) > (txt * img_f).sum(-1)).float().mean()
    return loss, acc
