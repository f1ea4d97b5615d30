"""Weighted reward ensembles for the port's trainer.

Port of adv_grpo_tpu/rewards/registry.py's ``RewardContext`` and
``multi_score`` for the ported rewards: the host scorers
(``rewards/host.py``, on the uint8 copy of the images, packed once): the
JPEG scorers, ``ocr`` and ``video_ocr`` (the context's OCR scorer, whose
engine is PaddleOCR or one the caller passes in); and the device rewards
(``rewards/scorers.py``): ``pickscore`` scores with the frozen weights,
``pickscore_cotrain`` with the live, co-trained ones; ``clipscore`` (CLIP-L)
and ``aesthetic`` (CLIP-L and the LAION head); the DINO rewards
``image_similarity`` (against ``ref_images``; its ``_eval`` form also
returns the CLS features as ``feat`` / ``ref_feat``), ``dino_cotrain``,
``dino_patch_cotrain`` (patch indices drawn from the context's generator,
under its lock: the reward futures run in threads) and
``dino_multi_cotrain``, with the live heads. ``'avg'`` is the weight-summed
ensemble, as in the JAX package. The other device rewards (SigLIP, the
PickScore patch and contrastive rewards, the StyleGAN discriminator) and
the remote judges are not ported yet and raise ``NotImplementedError``
naming the reward.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from adv_grpo_torch.rewards.host import jpeg_compressibility, jpeg_incompressibility
from adv_grpo_torch.utils.images import images_to_uint8

HOST_REWARDS = {"jpeg_compressibility": jpeg_compressibility,
                "jpeg_incompressibility": jpeg_incompressibility}
OCR_REWARDS = ("ocr", "video_ocr")
DEVICE_REWARDS = ("pickscore", "pickscore_cotrain", "clipscore", "aesthetic", "image_similarity",
                  "image_similarity_eval", "dino_cotrain", "dino_patch_cotrain",
                  "dino_multi_cotrain")


@dataclasses.dataclass
class RewardContext:
    """The scorers the rewards need; populate only what the preset uses.

    The JAX context holds whole parameter trees and may alias the frozen to
    the live ones, because JAX trees are immutable. Here the D-step's
    optimizer updates the live scorer in place and trains only the last
    vision layers, so the parameters are those layers: ``pickscore_params``
    the live ones (None: the scorer's own), ``pickscore_frozen_params``
    copies taken before training (None: the scorer's own, when nothing
    trains it). The DINO scorer keeps its frozen backbone; its heads are
    the live modules the D-steps update in place (``dino_head_params``,
    ``dino_multi_params``), which nothing frozen reads. Nothing trains the
    CLIP-L and aesthetic scorers, so their weights are their modules' and
    the context holds no separate parameters for them. A warm start that
    replaces CLIP tensors outside the tail (a full-tree ``.msgpack`` from
    ``cli.finetune_pickscore``) leaves a frozen copy of the scorer as built
    in ``pickscore_frozen``, which the 'pickscore' reward then scores with."""

    pickscore: Optional[Any] = None  # rewards.scorers.PickScoreScorer
    pickscore_params: Optional[Any] = None
    pickscore_frozen_params: Optional[Any] = None
    pickscore_frozen: Optional[Any] = None  # the scorer as built, where a warm start changed it
    clip: Optional[Any] = None  # rewards.scorers.CLIPScorer
    aesthetic: Optional[Any] = None  # rewards.scorers.AestheticScorer
    ocr: Optional[Any] = None  # rewards.host.OcrScorer or VideoOcrScorer
    tokenize: Optional[Callable[[List[str]], np.ndarray]] = None  # CLIP ids (B, 77)
    dino: Optional[Any] = None  # rewards.scorers.DINOScorer
    dino_head_params: Optional[Any] = None  # the live DINOHead
    dino_multi: Optional[Any] = None  # rewards.scorers.DINOMultiScorer
    dino_multi_params: Optional[Any] = None  # the live DINOMultiHeads
    rng: Optional[torch.Generator] = None  # patch indices of dino_patch_cotrain
    rng_lock: Any = dataclasses.field(default_factory=threading.Lock)


def _require(obj, name, what):
    if obj is None:
        raise RuntimeError(f"reward '{name}' needs {what} in RewardContext")
    return obj


def multi_score(score_dict: Dict[str, float], ctx: Optional[RewardContext] = None):
    """fn(images (B, 3, H, W) or video (B, F, 3, H, W) in [-1, 1], numpy or
    torch, prompts, metadata=None, ref_images=None, only_strict=True) ->
    (score_details incl. 'avg', {})."""
    ported = list(HOST_REWARDS) + list(OCR_REWARDS) + list(DEVICE_REWARDS)
    for name in score_dict:
        if name not in ported:
            raise NotImplementedError(
                f"reward {name!r} is not yet ported to adv_grpo_torch (ported: "
                f"{', '.join(ported)})")
    score_dict = dict(score_dict)
    ctx = ctx or RewardContext()

    def device_scores(name, images, prompts, ref_images):
        if name in ("pickscore", "pickscore_cotrain"):
            s = _require(ctx.pickscore, name, "pickscore scorer")
            if name == "pickscore" and ctx.pickscore_frozen is not None:
                s = ctx.pickscore_frozen
            ids = _require(ctx.tokenize, name, "tokenize")(prompts)
            tail = ctx.pickscore_frozen_params if name == "pickscore" else ctx.pickscore_params
            return s.score(images, ids, tail)
        if name == "clipscore":
            s = _require(ctx.clip, name, "clip scorer")
            return s.score(images, _require(ctx.tokenize, name, "tokenize")(prompts))
        if name == "aesthetic":
            return _require(ctx.aesthetic, name, "aesthetic scorer").score(images)
        if name == "dino_multi_cotrain":
            s = _require(ctx.dino_multi, name, "dino_multi scorer")
            return s.score(_require(ctx.dino_multi_params, name, "dino_multi_params"), images)
        s = _require(ctx.dino, name, "dino scorer")
        if name.startswith("image_similarity"):
            refs = _require(ref_images, name, "ref_images")
            return s.similarity_to_refs_with_feats(images, refs)
        head = _require(ctx.dino_head_params, name, "dino_head_params")
        if name == "dino_cotrain":
            return s.cotrain_score(head, images)
        _require(ctx.rng, name, "rng generator")
        with ctx.rng_lock:  # the reward futures share the generator
            idx = s.draw_patch_indices(len(images), ctx.rng)
        return s.patch_cotrain_score(head, images, idx=idx)

    def fn(images, prompts, metadata=None, ref_images=None, only_strict=True):
        u8 = None
        details: Dict[str, Any] = {}
        total = None
        for name, weight in score_dict.items():
            if name in DEVICE_REWARDS:
                scores = device_scores(name, images, prompts, ref_images)
                if name.startswith("image_similarity"):
                    scores, feat, ref_feat = scores
                    if name == "image_similarity_eval":
                        details["feat"] = feat.cpu().numpy()
                        details["ref_feat"] = ref_feat.cpu().numpy()
                scores = scores.cpu().numpy()
            else:
                if u8 is None:
                    arr = (images.detach().float().cpu().numpy() if torch.is_tensor(images)
                           else np.asarray(images, np.float32))
                    if arr.ndim == 5:  # video (B, F, 3, H, W): frame by frame
                        u8 = images_to_uint8(arr.reshape((-1,) + arr.shape[-3:]))
                        u8 = u8.reshape(arr.shape[:2] + u8.shape[1:])
                    else:
                        u8 = images_to_uint8(arr)
                if name in OCR_REWARDS:
                    scores = _require(ctx.ocr, name, "ocr scorer")(u8, prompts)
                else:
                    scores = HOST_REWARDS[name](u8)
            scores = np.asarray(scores, dtype=np.float64)
            details[name] = scores
            total = weight * scores if total is None else total + weight * scores
        details["avg"] = total
        return details, {}

    return fn
