"""The PickScore reward on the device: a CLIP dual encoder and its scorer.

Port of adv_grpo_tpu/rewards/scorers.py's ``CLIPDualEncoder`` and
``PickScoreScorer``. The JAX scorer takes its parameters as an argument; here
they live in the module (``PickScoreScorer.clip``), and a call may replace
the last vision layers by others (``tail``): the co-trained discriminator
trains only those layers, so the frozen reward keeps copies of them and
shares everything else (``rewards.registry.RewardContext``). Scoring runs
under ``torch.no_grad()``; ``features`` keeps the graph for the D-step.

The scorer switches TF32 off for fp32 matmuls, process-wide, as the
pipelines do: the PIL-faithful resize and the fp32 towers need the full
mantissa.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adv_grpo_torch.models.vit import ViTConfig, VisionTransformer
from adv_grpo_torch.rewards.preprocess import CLIP_MEAN, CLIP_STD, preprocess

LOGIT_SCALE_INIT = 4.6052  # log(100), the JAX init_params value


def _l2norm(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPDualEncoder(nn.Module):
    """A CLIP text + vision pair with a learnable logit scale (the trainable
    unit of the adversarial PickScore loop)."""

    def __init__(self, text_cfg: CLIPTextConfig, vision_cfg: ViTConfig, device=None):
        super().__init__()
        self.text_model = CLIPTextEncoder(text_cfg, device)
        self.vision_model = VisionTransformer(vision_cfg, device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> "CLIPDualEncoder":
        """Random weights from ``generator``, the JAX initialisers' families
        (not their numbers): matrices normal with std 1/sqrt(fan_in), biases
        zero, LayerNorm scales one, the class token and positions normal
        with std 0.02, the logit scale log(100)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "logit_scale":
                p.fill_(LOGIT_SCALE_INIT)
            elif leaf in ("class_embedding", "position_embedding"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        return self

    def text_features(self, input_ids):
        return self.text_model(input_ids)[2]

    def image_features(self, pixel_values, tail: Optional[Sequence[nn.Module]] = None):
        """The projected class token; ``tail`` replaces the last ``len(tail)``
        vision layers for this call."""
        vm = self.vision_model
        layers = None
        if tail is not None:
            layers = list(vm.layers)[:len(vm.layers) - len(tail)] + list(tail)
        return vm(pixel_values, layers=layers)["pooled"]


class PickScoreScorer:
    """PickScore CLIP-H: score = exp(logit_scale) * <text, image> / 26 on
    L2-normalised features (reference adv_grpo/pickscore_scorer.py:47-51)."""

    def __init__(self, clip: CLIPDualEncoder, image_size: int = 224):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.clip = clip
        self.image_size = image_size
        self.device = clip.logit_scale.device

    @classmethod
    def random_init(cls, generator: torch.Generator, device, text_cfg=None, vision_cfg=None,
                    image_size: int = 224) -> "PickScoreScorer":
        """CLIP-H (or the given towers) with random weights drawn from
        ``generator``, which lives on ``device``."""
        clip = CLIPDualEncoder(text_cfg or CLIPTextConfig.clip_h_text(),
                               vision_cfg or ViTConfig.clip_h(), device="meta")
        clip = clip.to_empty(device=device).eval().init_params_(generator)
        return cls(clip, image_size)

    def _images(self, images):
        if torch.is_tensor(images):
            return images.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(images, np.float32)).to(self.device)

    def features(self, images, input_ids, tail=None):
        """(image, text) L2-normalised features of ``images`` (B, 3, H, W) in
        [-1, 1] (numpy or torch) and ``input_ids`` (B, S)."""
        pix = preprocess(self._images(images), self.image_size, CLIP_MEAN, CLIP_STD)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(self.device)
        return (_l2norm(self.clip.image_features(pix, tail)),
                _l2norm(self.clip.text_features(ids)))

    @torch.no_grad()
    def score(self, images, input_ids, tail=None):
        img, txt = self.features(images, input_ids, tail)
        return torch.exp(self.clip.logit_scale) * (txt * img).sum(-1) / 26.0
