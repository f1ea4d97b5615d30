"""Weighted reward ensembles for the port's trainer.

Port of adv_grpo_tpu/rewards/registry.py's ``RewardContext`` and
``multi_score``; it accepts every reward name the JAX registry knows, and
an unknown one raises ``KeyError`` listing them. The host scorers
(``rewards/host.py``, on the uint8 copy of the images, packed once): the
JPEG scorers, ``ocr`` and ``video_ocr`` (the context's OCR scorer, whose
engine is PaddleOCR or one the caller passes in). The device rewards
(``rewards/scorers.py``): ``pickscore`` scores with the frozen weights,
``pickscore_cotrain``, ``pickscore_patch`` and ``constractive_external``
(the reference's spelling) with the live, co-trained ones; ``clipscore``
(CLIP-L) and ``aesthetic`` (CLIP-L and the LAION head); the DINO rewards
``image_similarity`` (against ``ref_images``; its ``_eval`` form also
returns the CLS features as ``feat`` / ``ref_feat``), ``dino_cotrain``,
``dino_patch_cotrain`` (patch indices drawn from the context's generator,
under its lock: the reward futures run in threads) and
``dino_multi_cotrain``, with the live heads; ``siglip_image_similarity``
(against the shared pool of ``ref_images``) and ``siglip_cotrain`` (the
SigLIP head as built: no D-step trains it, in the JAX package either).
``discriminator`` is the context's StyleGAN D where it has one, else its
remote client. The remote judges (``geneval``, ``deqa``,
``unifiedreward``, ``qwenvl``, ``imagereward``) are the context's
``remote`` callables on the uint8 copy; ``geneval`` also surfaces
``accuracy``, ``strict_accuracy`` and each group's ``*_accuracy`` /
``*_strict_accuracy`` into the details, and ``only_strict`` reaches it.
``'avg'`` is the weight-summed ensemble, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from adv_grpo_torch.rewards.host import jpeg_compressibility, jpeg_incompressibility
from adv_grpo_torch.rewards.scorers import contrastive_external_reward, pickscore_patch_score
from adv_grpo_torch.utils.images import images_to_uint8

HOST_REWARDS = {"jpeg_compressibility": jpeg_compressibility,
                "jpeg_incompressibility": jpeg_incompressibility}
OCR_REWARDS = ("ocr", "video_ocr")
DEVICE_REWARDS = ("pickscore", "pickscore_cotrain", "clipscore", "aesthetic", "image_similarity",
                  "image_similarity_eval", "dino_cotrain", "dino_patch_cotrain",
                  "dino_multi_cotrain", "pickscore_patch", "constractive_external",
                  "siglip_image_similarity", "siglip_cotrain")
REMOTE_REWARDS = ("geneval", "deqa", "unifiedreward", "qwenvl", "imagereward", "discriminator")
KNOWN_REWARDS = frozenset(HOST_REWARDS) | set(OCR_REWARDS) | set(DEVICE_REWARDS) | set(
    REMOTE_REWARDS)


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
    the context holds no separate parameters for them, nor for the SigLIP
    backbone and the StyleGAN D. A warm start that
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
    siglip: Optional[Any] = None  # rewards.scorers.SigLIPScorer
    siglip_head_params: Optional[Any] = None  # its cotrain head (a DINOHead)
    stylegan: Optional[Any] = None  # models.stylegan_d.StyleGANScorer ('discriminator')
    # the remote judges: name -> fn(images_u8, prompts, metadata) (geneval:
    # fn(images_u8, prompts, metadatas, only_strict) -> its five lists)
    remote: Dict[str, Callable] = dataclasses.field(default_factory=dict)


def _require(obj, name, what):
    if obj is None:
        raise RuntimeError(f"reward '{name}' needs {what} in RewardContext")
    return obj


def multi_score(score_dict: Dict[str, float], ctx: Optional[RewardContext] = None):
    """fn(images (B, 3, H, W) or video (B, F, 3, H, W) in [-1, 1], numpy or
    torch, prompts, metadata=None, ref_images=None, only_strict=True) ->
    (score_details incl. 'avg', {})."""
    for name in score_dict:
        if name not in KNOWN_REWARDS:
            raise KeyError(f"unknown reward '{name}' (known: {sorted(KNOWN_REWARDS)})")
    score_dict = dict(score_dict)
    ctx = ctx or RewardContext()

    def pool(name, ref_images):  # the references as one (M, 3, H, W) pool
        refs = _require(ref_images, name, "ref_images")
        return refs.reshape((-1,) + tuple(refs.shape[-3:])) if refs.ndim == 5 else refs

    def device_scores(name, images, prompts, ref_images):
        if name in ("pickscore_patch", "constractive_external"):
            s = _require(ctx.pickscore, name, "pickscore scorer")
            ids = _require(ctx.tokenize, name, "tokenize")(prompts)
            if name == "pickscore_patch":
                return pickscore_patch_score(s, images, ids, ctx.pickscore_params)
            return contrastive_external_reward(s, images, pool(name, ref_images), ids,
                                               ctx.pickscore_params)[0]
        if name.startswith("siglip"):
            s = _require(ctx.siglip, name, "siglip scorer")
            if name == "siglip_image_similarity":
                return s.similarity_to_refs(images, pool(name, ref_images))
            return s.cotrain_score(_require(ctx.siglip_head_params, name, "siglip_head_params"),
                                   images)
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
            if name == "discriminator" and ctx.stylegan is not None:
                # the on-device StyleGAN D (reference rewards.py:611-638)
                scores = ctx.stylegan.score(images).cpu().numpy()
            elif name in DEVICE_REWARDS:
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
                elif name in HOST_REWARDS:
                    scores = HOST_REWARDS[name](u8)
                elif name == "geneval":
                    # per-sample scores and the accuracy decompositions
                    # (reference rewards.py:1048-1054; only_strict skips the
                    # non-strict pass during training, :1042)
                    judge = _require(ctx.remote.get(name), name, f"remote['{name}'] client")
                    scores, acc, strict, group_r, group_s = judge(
                        u8, prompts, metadata or [{}] * len(prompts), only_strict)
                    details["accuracy"] = np.asarray(acc, np.float64)
                    details["strict_accuracy"] = np.asarray(strict, np.float64)
                    for key, value in group_s.items():
                        details[f"{key}_strict_accuracy"] = value
                    for key, value in group_r.items():
                        details[f"{key}_accuracy"] = value
                else:  # the remote judges
                    judge = _require(ctx.remote.get(name), name, f"remote['{name}'] client")
                    scores = judge(u8, prompts, metadata)
            scores = np.asarray(scores, dtype=np.float64)
            details[name] = scores
            total = weight * scores if total is None else total + weight * scores
        details["avg"] = total
        return details, {}

    return fn
