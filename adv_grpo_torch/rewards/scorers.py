"""The device rewards: PickScore (a CLIP dual encoder and its scorer), the
CLIP-L score and the LAION aesthetic score, and the DINO discriminators.

Port of adv_grpo_tpu/rewards/scorers.py's ``CLIPDualEncoder``,
``PickScoreScorer``, ``CLIPScorer``, ``AestheticScorer``, ``DINOScorer`` and
``DINOMultiScorer``. The JAX
PickScore scorer takes its parameters as an argument; here they live in the
module (``PickScoreScorer.clip``), and a call may replace the last vision
layers by others (``tail``): the co-trained discriminator trains only those
layers, so the frozen reward keeps copies of them and shares everything
else (``rewards.registry.RewardContext``). Scoring runs under
``torch.no_grad()``; ``features`` keeps the graph for the D-step.

The DINO scorers keep the DINOv2 backbone frozen (``requires_grad=False``,
features under ``torch.no_grad()``: the JAX ``stop_gradient``); their heads
are modules of their own, passed to each call, which the D-steps
(``train.grpo_trainer``) update in place.

The scorers switch TF32 off for fp32 matmuls, process-wide, as the
pipelines do: the PIL-faithful resize and the fp32 towers need the full
mantissa.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adv_grpo_torch.adversarial.dino_hinge import multi_layer_logit, take_patches
from adv_grpo_torch.models.aesthetic import AestheticHead
from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adv_grpo_torch.models.vit import ViTConfig, VisionTransformer
from adv_grpo_torch.rewards.preprocess import (
    CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD, preprocess)

LOGIT_SCALE_INIT = 4.6052  # log(100), the JAX init_params value


def _l2norm(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 layer_scale: Optional[float] = None) -> nn.Module:
    """Random weights from ``generator``, the JAX initialisers' families (not
    their numbers): matrices normal with std 1/sqrt(fan_in), biases zero,
    LayerNorm scales one, the class token and positions normal with std
    0.02, the logit scale log(100), LayerScale ``layer_scale``."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "logit_scale":
            p.fill_(LOGIT_SCALE_INIT)
        elif leaf in ("ls1", "ls2"):
            p.fill_(layer_scale)
        elif leaf in ("class_embedding", "position_embedding"):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "bias":
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module


def _as_device_images(images, device):
    if torch.is_tensor(images):
        return images.to(device, torch.float32)
    return torch.from_numpy(np.asarray(images, np.float32)).to(device)


class CLIPDualEncoder(nn.Module):
    """A CLIP text + vision pair with a learnable logit scale (the trainable
    unit of the adversarial PickScore loop)."""

    def __init__(self, text_cfg: CLIPTextConfig, vision_cfg: ViTConfig, device=None):
        super().__init__()
        self.text_model = CLIPTextEncoder(text_cfg, device)
        self.vision_model = VisionTransformer(vision_cfg, device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    def init_params_(self, generator: torch.Generator) -> "CLIPDualEncoder":
        """Random weights from ``generator`` (:func:`random_init_`)."""
        return random_init_(self, generator)

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

    divisor = 26.0

    @staticmethod
    def default_towers():
        return CLIPTextConfig.clip_h_text(), ViTConfig.clip_h()

    def __init__(self, clip: CLIPDualEncoder, image_size: int = 224):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.clip = clip
        self.image_size = image_size
        self.device = clip.logit_scale.device

    @classmethod
    def random_init(cls, generator: torch.Generator, device, text_cfg=None, vision_cfg=None,
                    image_size: int = 224) -> "PickScoreScorer":
        """The default towers (or the given ones) with random weights drawn
        from ``generator``, which lives on ``device``."""
        text_default, vision_default = cls.default_towers()
        clip = CLIPDualEncoder(text_cfg or text_default, vision_cfg or vision_default,
                               device="meta")
        clip = clip.to_empty(device=device).eval().init_params_(generator)
        return cls(clip, image_size)

    @classmethod
    def from_state_dict(cls, state_dict, device, text_cfg, vision_cfg,
                        image_size: int = 224) -> "PickScoreScorer":
        """The towers at ``text_cfg`` / ``vision_cfg`` with the weights of
        ``state_dict`` (a ``CLIPDualEncoder`` state dict, e.g. from
        ``models.convert.clip_model_state_dict_from_hf``), on ``device``."""
        clip = CLIPDualEncoder(text_cfg, vision_cfg, device="meta").to_empty(device=device)
        clip.load_state_dict(state_dict)
        return cls(clip.eval(), image_size)

    def features(self, images, input_ids, tail=None):
        """(image, text) L2-normalised features of ``images`` (B, 3, H, W) in
        [-1, 1] (numpy or torch) and ``input_ids`` (B, S)."""
        pix = preprocess(_as_device_images(images, self.device), self.image_size, CLIP_MEAN,
                         CLIP_STD)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(self.device)
        return (_l2norm(self.clip.image_features(pix, tail)),
                _l2norm(self.clip.text_features(ids)))

    @torch.no_grad()
    def score(self, images, input_ids, tail=None):
        img, txt = self.features(images, input_ids, tail)
        return torch.exp(self.clip.logit_scale) * (txt * img).sum(-1) / self.divisor


class CLIPScorer(PickScoreScorer):
    """The CLIP-L score: exp(logit_scale) * <text, image> / 30 on
    L2-normalised features, and the cosine of two batches' image features
    (reference adv_grpo/clip_scorer.py:47-71)."""

    divisor = 30.0

    @staticmethod
    def default_towers():
        return CLIPTextConfig.clip_l(), ViTConfig.clip_l()

    def image_features(self, images):
        """L2-normalised image features of ``images`` (B, 3, H, W) in [-1, 1]."""
        pix = preprocess(_as_device_images(images, self.device), self.image_size, CLIP_MEAN,
                         CLIP_STD)
        return _l2norm(self.clip.image_features(pix))

    @torch.no_grad()
    def image_similarity(self, images_a, images_b):
        return (self.image_features(images_a) * self.image_features(images_b)).sum(-1)


class AestheticScorer:
    """The LAION aesthetic score (reference adv_grpo/aesthetic_scorer.py:33-53):
    the CLIP-L vision tower's projected class token through
    ``models.aesthetic.AestheticHead``; fp32."""

    def __init__(self, vision: VisionTransformer, head: AestheticHead, image_size: int = 224):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.vision = vision.eval().requires_grad_(False)
        self.head = head.eval().requires_grad_(False)
        self.vision_cfg = vision.cfg
        self.image_size = image_size
        self.device = vision.class_embedding.device

    @staticmethod
    def _head(device):
        return AestheticHead(device="meta").to_empty(device=device)

    @classmethod
    def random_init(cls, generator: torch.Generator, device, vision_cfg=None,
                    image_size: int = 224) -> "AestheticScorer":
        """CLIP-L (or the given tower, whose ``projection_dim`` must be 768)
        and the head, random weights drawn from ``generator`` on ``device``."""
        vision = VisionTransformer(vision_cfg or ViTConfig.clip_l(), device="meta")
        vision = random_init_(vision.to_empty(device=device), generator)
        return cls(vision, random_init_(cls._head(device), generator), image_size)

    @classmethod
    def from_state_dicts(cls, vision_sd, head_sd, device, vision_cfg,
                         image_size: int = 224) -> "AestheticScorer":
        """The tower at ``vision_cfg`` and the head with the weights of
        ``vision_sd`` (``models.convert.clip_vision_state_dict_from_hf``) and
        ``head_sd`` (``models.convert.aesthetic_state_dict_from_pth``)."""
        vision = VisionTransformer(vision_cfg, device="meta").to_empty(device=device)
        vision.load_state_dict(vision_sd)
        head = cls._head(device)
        head.load_state_dict(head_sd)
        return cls(vision, head, image_size)

    @torch.no_grad()
    def score(self, images):
        pix = preprocess(_as_device_images(images, self.device), self.image_size, CLIP_MEAN,
                         CLIP_STD)
        return self.head(self.vision(pix)["pooled"])


class DINOHead(nn.Module):
    """The DINO discriminator head: fc1 (D -> hidden), exact GELU, fc2
    (hidden -> 1); (..., D) -> (...) logits."""

    def __init__(self, dim: int, hidden: int = 512, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, 1, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x))).squeeze(-1)


class DINOScorer:
    """DINOv2 features and the scores built on them (reference
    adv_grpo/rewards.py): ``similarity_to_refs`` (image_similarity_score
    :147-203: the cosine of the CLS tokens, max over each image's
    references, 518^2 ImageNet preprocessing), ``cotrain_score`` (:266-294:
    the head on the CLS token) and ``patch_cotrain_score`` (:375-434:
    0.7 * head(CLS) + 0.3 * the mean of the head over patch tokens drawn
    uniformly with replacement)."""

    def __init__(self, vision: VisionTransformer, image_size: int = 518, head_hidden: int = 512):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.vision = vision.eval().requires_grad_(False)
        self.vision_cfg = vision.cfg
        self.image_size = image_size
        self.head_hidden = head_hidden
        self.num_patches = (image_size // vision.cfg.patch_size) ** 2
        self.device = vision.class_embedding.device

    @classmethod
    def random_init(cls, generator: torch.Generator, device, vision_cfg=None,
                    image_size: int = 518, head_hidden: int = 512) -> "DINOScorer":
        """DINOv2-B/14 (or the given config) with random weights drawn from
        ``generator``, which lives on ``device``."""
        cfg = vision_cfg or ViTConfig.dinov2_base()
        vision = VisionTransformer(cfg, device="meta").to_empty(device=device)
        return cls(random_init_(vision, generator, cfg.layer_scale_init), image_size,
                   head_hidden)

    @classmethod
    def from_state_dict(cls, state_dict, device, vision_cfg, image_size: int = 518,
                        head_hidden: int = 512) -> "DINOScorer":
        """The backbone at ``vision_cfg`` with the weights of ``state_dict``
        (e.g. from ``models.convert.dinov2_state_dict``), on ``device``."""
        vision = VisionTransformer(vision_cfg, device="meta").to_empty(device=device)
        vision.load_state_dict(state_dict)
        return cls(vision, image_size, head_hidden)

    def init_head(self, generator: torch.Generator) -> DINOHead:
        head = DINOHead(self.vision_cfg.hidden_size, self.head_hidden, device="meta")
        return random_init_(head.to_empty(device=self.device), generator)

    def preprocess(self, images):
        return preprocess(_as_device_images(images, self.device), self.image_size,
                          IMAGENET_MEAN, IMAGENET_STD)

    @torch.no_grad()
    def features(self, images):
        """(B, 1+N, D) tokens after the final LayerNorm (CLS at 0) of
        ``images`` (B, 3, H, W) in [-1, 1], numpy or torch."""
        return self.vision(self.preprocess(images))["tokens"]

    @torch.no_grad()
    def layer_tokens(self, images, layer_ids: Sequence[int]):
        """The raw outputs of the blocks ``layer_ids``, in that order."""
        out = self.vision(self.preprocess(images), capture_layers=tuple(layer_ids))
        return [out["layer_tokens"][i] for i in layer_ids]

    def draw_patch_indices(self, batch: int, generator: torch.Generator, n_patches: int = 64):
        """(batch, min(n_patches, N)) patch indices, uniform on [0, N) with
        replacement, on the generator's device."""
        return torch.randint(0, self.num_patches, (batch, min(n_patches, self.num_patches)),
                             generator=generator, device=generator.device)

    @torch.no_grad()
    def similarity_to_refs_with_feats(self, images, ref_images):
        """(max cosine over the references, the images' L2-normalised CLS
        tokens (B, D), the references' (B, R, D)); ``ref_images`` (B, R, 3,
        H, W)."""
        cls = _l2norm(self.features(images)[:, 0])
        refs = _as_device_images(ref_images, self.device)
        b, r = refs.shape[:2]
        ref_cls = _l2norm(self.features(refs.reshape((b * r,) + refs.shape[2:]))[:, 0])
        ref_cls = ref_cls.view(b, r, -1)
        return torch.einsum("bd,brd->br", cls, ref_cls).max(1).values, cls, ref_cls

    def similarity_to_refs(self, images, ref_images):
        return self.similarity_to_refs_with_feats(images, ref_images)[0]

    @torch.no_grad()
    def cotrain_score(self, head: nn.Module, images):
        return head(self.features(images)[:, 0])

    @torch.no_grad()
    def patch_cotrain_score(self, head: nn.Module, images, idx=None, generator=None,
                            n_patches: int = 64, cls_weight: float = 0.7,
                            patch_weight: float = 0.3):
        """``idx`` (B, n) patch indices, or drawn from ``generator``."""
        toks = self.features(images)
        if idx is None:
            idx = self.draw_patch_indices(toks.shape[0], generator, n_patches)
        patch_logit = head(take_patches(toks[:, 1:], idx.to(toks.device)))
        return cls_weight * head(toks[:, 0]) + patch_weight * patch_logit.mean(1)


class DINOMultiHeads(nn.Module):
    """The multi-layer discriminator's trainable part: one ``DINOHead`` per
    captured layer and the ``fusion`` Linear(T, 1)."""

    def __init__(self, dim: int, n_layers: int, hidden: int = 512, device=None):
        super().__init__()
        self.heads = nn.ModuleList(DINOHead(dim, hidden, device) for _ in range(n_layers))
        self.fusion = nn.Linear(n_layers, 1, device=device)


class DINOMultiScorer:
    """The multi-layer DINO reward (reference adv_grpo/rewards.py:437-559
    dino_multi_cotrain_score): per-layer heads on the raw block outputs'
    patch tokens, top-k pooling, the linear fusion, then
    sigmoid(logit / temperature)."""

    def __init__(self, dino: DINOScorer, layer_ids=(8,), topk_tau: float = 0.2,
                 temperature: float = 0.2):
        self.dino = dino
        self.layer_ids = tuple(layer_ids)
        self.topk_tau = float(topk_tau)
        self.temperature = float(temperature)

    def init_heads(self, generator: torch.Generator) -> DINOMultiHeads:
        multi = DINOMultiHeads(self.dino.vision_cfg.hidden_size, len(self.layer_ids),
                               self.dino.head_hidden, device="meta")
        return random_init_(multi.to_empty(device=self.dino.device), generator)

    @torch.no_grad()
    def score(self, multi: DINOMultiHeads, images, *, topk_tau=None, temperature=None,
              apply_sigmoid: bool = True):
        tau = self.topk_tau if topk_tau is None else topk_tau
        temperature = self.temperature if temperature is None else temperature
        logits = multi_layer_logit(multi.heads, multi.fusion,
                                   self.dino.layer_tokens(images, self.layer_ids), tau)
        return torch.sigmoid(logits / temperature) if apply_sigmoid else logits
