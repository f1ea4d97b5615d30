"""WAN text-to-video pipeline bundle: WanTransformer + the 3D causal VAE
behind the seam the trainer and the demo drive.

Port of adv_grpo_tpu/train/wan_pipeline.py. What differs from SD3 and Flux
stays in here: latents are 5-D (B, C, F, H, W); there is no CFG batch and no
pooled conditioning (``velocity_fn`` takes the trainer's (latents, t,
embeds, pooled) signature and ignores ``pooled``); ``velocity_fn(0.0)`` is
the adapter-free reference policy of the per-step KL; ``decode`` returns
frame-major video (B, F, 3, H, W) in [-1, 1], one video at a time (the same
numbers as a batched decode, a fraction of its fp32 activation memory).

``random_init`` allocates every parameter on the device and draws it there
from a ``torch.Generator``; ``from_pretrained`` loads a local diffusers
``WanTransformer3DModel`` directory and the ``AutoencoderKLWan`` beside it;
``from_jax`` takes the JAX package's parameter trees.
Constructing a pipeline switches TF32 off for float32 matmuls and cuDNN
convolutions (process-wide), as the other pipelines do: the VAE decodes in
fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from adv_grpo_torch.models.convert import wan_state_dict_from_jax, wan_vae_state_dict_from_jax
from adv_grpo_torch.models.lora import init_params_
from adv_grpo_torch.models.wan import WanConfig, WanTransformer
from adv_grpo_torch.models.wan_vae import WanVAEConfig, WanVideoVAE
from adv_grpo_torch.train.pipeline import _build
from adv_grpo_torch.utils.metrics import span


@dataclasses.dataclass
class WanPipeline:
    wan_cfg: WanConfig
    vae_cfg: WanVAEConfig
    transformer: WanTransformer
    vae: WanVideoVAE
    device: torch.device
    text_seq_len: int = 512  # UMT5 tokens
    latent_frames: int = 3  # F' of the 5-D latent grid
    shift: float = 3.0  # UniPC flow-sigma shift (rollout.wan.wan_schedule)
    latent_hw: int = 8  # default latent side of prepare_latents
    family: str = "wan"

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def random_init(cls, generator: torch.Generator, wan_cfg: WanConfig,
                    vae_cfg: WanVAEConfig, device, latent_hw: int = 8, latent_frames: int = 2,
                    text_seq_len: int = 6, shift: float = 3.0):
        """Random weights drawn on ``device`` from ``generator`` (which lives
        there), with the distributions of the JAX initialisers."""
        device = torch.device(device)
        transformer = init_params_(_build(WanTransformer, wan_cfg, device), generator)
        vae = init_params_(_build(WanVideoVAE, vae_cfg, device), generator)
        return cls(wan_cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   latent_frames=latent_frames, shift=shift, latent_hw=latent_hw)

    @classmethod
    def from_pretrained(cls, model_dir: str, *, vae_dir: Optional[str] = None,
                        lora_rank: int = 0, lora_alpha: float = 1.0, dtype=torch.bfloat16,
                        latent_frames: int = 21, text_seq_len: int = 512, shift: float = 3.0,
                        latent_hw: int = 8, device="cuda", remat=False):
        """The transformer of a local diffusers ``WanTransformer3DModel``
        directory (``models.convert.load_wan_transformer``) and the
        ``AutoencoderKLWan`` of ``vae_dir``, by default ``<model_dir>/../vae``
        (the WanPipeline checkpoint layout; ``models.convert.load_wan_vae``),
        on ``device``."""
        import os

        from adv_grpo_torch.models import convert

        device = torch.device(device)
        cfg, transformer = convert.load_wan_transformer(
            model_dir, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, device=device,
            remat=remat)
        vae_dir = vae_dir or os.path.join(os.path.dirname(os.path.normpath(model_dir)), "vae")
        vae_cfg, vae = convert.load_wan_vae(vae_dir, device=device)
        return cls(cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   latent_frames=latent_frames, shift=shift, latent_hw=latent_hw)

    @classmethod
    def from_jax(cls, transformer_params, vae_params, wan_cfg: WanConfig,
                 vae_cfg: WanVAEConfig, device, latent_hw: int = 8, latent_frames: int = 2,
                 text_seq_len: int = 6, shift: float = 3.0):
        """Weights from the JAX package's parameter trees (numpy leaves), cast
        to the configs' dtypes (the tables, norms and LoRA factors stay
        fp32)."""
        device = torch.device(device)
        transformer = _build(WanTransformer, wan_cfg, device)
        transformer.load_state_dict(wan_state_dict_from_jax(transformer_params, wan_cfg))
        vae = _build(WanVideoVAE, vae_cfg, device)
        vae.load_state_dict(wan_vae_state_dict_from_jax(vae_params, vae_cfg))
        return cls(wan_cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   latent_frames=latent_frames, shift=shift, latent_hw=latent_hw)

    def velocity_fn(self, lora_scale: float = 1.0) -> Callable:
        """(latents (B, C, F, H, W), t (B,) on the 0..1000 scale, embeds,
        pooled [ignored]) -> velocity; ``lora_scale=0`` is the adapter-free
        reference policy."""

        def fn(latents, t, embeds, pooled=None):
            del pooled
            return self.transformer(latents, t, embeds, lora_scale=lora_scale)

        return fn

    def decode(self, latents):
        """Normalised 5-D latents -> video (B, F, 3, H, W) in [-1, 1],
        frame-major (the rewards' video layout); the VAE denormalises with
        its per-channel stats and decodes each video in chunks of latent
        frames where the whole would pass 2^31 elements
        (``WanDecoder3d.chunk_frames``)."""
        with span("decode", device=latents.device, rows=latents.shape[0]):
            return torch.cat([self.vae.decode(z[None]) for z in latents]).transpose(1, 2)

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        latent_hw: Optional[int] = None):
        """Standard-normal (B, C, latent_frames, hw, hw) latents from
        ``generator``."""
        hw = latent_hw or self.latent_hw
        return torch.randn((batch, self.wan_cfg.in_channels, self.latent_frames, hw, hw),
                           generator=generator, device=self.device, dtype=torch.float32)
