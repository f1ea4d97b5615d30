"""Flux pipeline bundle: FluxTransformer + VAE behind the seam the sampler
and the CLIs drive.

Port of adv_grpo_tpu/train/flux_pipeline.py. What differs from SD3 stays in
here: latents are PACKED 2x2 tokens (B, S, 4C) end to end (``velocity_fn``,
``decode`` and ``prepare_latents`` speak packed); the RoPE token ids follow
from (S, S_txt); guidance is an embedded model input (Flux.1-dev), so there
is no CFG batch.

``random_init`` allocates every parameter on the device (meta construction,
then ``to_empty``) and draws it there from a ``torch.Generator``, so the
11.84 B parameters of Flux.1-dev are never staged through host memory;
``from_pretrained`` loads a local diffusers ``FluxTransformer2DModel``
directory and the Flux VAE beside it; ``from_jax`` takes the JAX package's
parameter trees. ``encode_image`` makes the packed conditioning latents of
the Kontext mode (``rollout.flux.flux_denoise_with_logprob(cond_latents=)``).

Constructing a pipeline switches TF32 off for float32 matmuls and cuDNN
convolutions (process-wide), as ``SD3Pipeline`` does: the VAE decodes in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from adv_grpo_torch.models.convert import flux_state_dict_from_jax, vae_state_dict_from_jax
from adv_grpo_torch.models.flux import FluxConfig, FluxTransformer, make_latent_ids
from adv_grpo_torch.models.lora import init_params_
from adv_grpo_torch.models.vae import AutoencoderKL, VAEConfig
from adv_grpo_torch.rollout.flux import pack_latents, unpack_latents
from adv_grpo_torch.train.pipeline import _build


@dataclasses.dataclass
class FluxPipeline:
    flux_cfg: FluxConfig
    vae_cfg: VAEConfig
    transformer: FluxTransformer
    vae: AutoencoderKL
    device: torch.device
    text_seq_len: int = 512  # T5-XXL tokens (Flux.1-dev max_sequence_length)
    guidance: float = 3.5  # embedded guidance (Flux.1-dev)
    latent_hw: int = 64  # default latent side of prepare_latents (512^2 images)
    family: str = "flux"

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ── constructors ──────────────────────────────────────────────────────

    @classmethod
    def random_init(cls, generator: torch.Generator, flux_cfg: FluxConfig,
                    vae_cfg: VAEConfig, device, latent_hw: int = 64,
                    text_seq_len: int = 512, guidance: float = 3.5):
        """Random weights drawn on ``device`` from ``generator`` (which lives
        there), with the distributions of the JAX initialisers."""
        device = torch.device(device)
        transformer = init_params_(_build(FluxTransformer, flux_cfg, device), generator)
        vae = init_params_(_build(AutoencoderKL, vae_cfg, device), generator)
        return cls(flux_cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   guidance=guidance, latent_hw=latent_hw)

    @classmethod
    def from_pretrained(cls, model_dir: str, *, vae_dir: Optional[str] = None,
                        lora_rank: int = 0, lora_alpha: float = 1.0, dtype=torch.bfloat16,
                        text_seq_len: int = 512, guidance: float = 3.5, latent_hw: int = 64,
                        device="cuda"):
        """The transformer of a local diffusers ``FluxTransformer2DModel``
        directory (``models.convert.load_flux_transformer``) and the Flux
        ``AutoencoderKL`` of ``vae_dir``, by default ``<model_dir>/../vae``
        (``models.convert.load_vae`` with ``VAEConfig.flux()``'s factors
        where its ``config.json`` lacks them), on ``device``."""
        import os

        from adv_grpo_torch.models import convert

        device = torch.device(device)
        cfg, transformer = convert.load_flux_transformer(
            model_dir, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, device=device)
        vae_dir = vae_dir or os.path.join(os.path.dirname(os.path.normpath(model_dir)), "vae")
        vae_cfg, vae = convert.load_vae(vae_dir, base=VAEConfig.flux(), device=device)
        return cls(cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   guidance=guidance, latent_hw=latent_hw)

    @classmethod
    def from_jax(cls, transformer_params, vae_params, flux_cfg: FluxConfig,
                 vae_cfg: VAEConfig, device, latent_hw: int = 64, text_seq_len: int = 512,
                 guidance: float = 3.5):
        """Weights from the JAX package's parameter trees (numpy leaves), cast
        to the configs' dtypes (the LoRA factors stay fp32)."""
        device = torch.device(device)
        transformer = _build(FluxTransformer, flux_cfg, device)
        transformer.load_state_dict(flux_state_dict_from_jax(transformer_params, flux_cfg))
        vae = _build(AutoencoderKL, vae_cfg, device)
        vae.load_state_dict(vae_state_dict_from_jax(vae_params, vae_cfg))
        return cls(flux_cfg, vae_cfg, transformer, vae, device, text_seq_len=text_seq_len,
                   guidance=guidance, latent_hw=latent_hw)

    # ── closures ──────────────────────────────────────────────────────────

    def velocity_fn(self, lora_scale: float = 1.0) -> Callable:
        """(packed latents (B, S, 4C) on a square grid, t (B,) on the
        sigma*1000 scale, embeds, pooled) -> velocity."""
        c = self.flux_cfg

        def fn(latents, t, embeds, pooled):
            s = latents.shape[1]
            gh = math.isqrt(s)
            if gh * gh != s:
                raise ValueError(f"packed token count {s} is not a square grid; call the "
                                 "transformer with explicit img_ids")
            guidance = torch.full(t.shape, self.guidance, dtype=torch.float32,
                                  device=t.device) if c.guidance_embeds else None
            return self.transformer(latents, t, embeds, pooled, make_latent_ids(gh, gh),
                                    np.zeros((embeds.shape[1], 3), np.int32),
                                    guidance=guidance, lora_scale=lora_scale)

        return fn

    def decode(self, packed_latents):
        """Packed final latents -> images in [-1, 1]: unpack the 2x2 tokens,
        undo the latent normalisation, decode in fp32."""
        gh = math.isqrt(packed_latents.shape[1])
        lat = unpack_latents(packed_latents, gh * 2, gh * 2)
        z = lat.float() / self.vae_cfg.scaling_factor + self.vae_cfg.shift_factor
        return self.vae.decode(z)

    def encode_image(self, images, generator: Optional[torch.Generator] = None):
        """Images (B, 3, H, W) in [-1, 1] -> scaled PACKED latents (the
        Kontext conditioning entry): the Flux VAE's posterior mode, or a
        sample drawn from ``generator``, as (z - shift) * scaling, packed 2x2."""
        return pack_latents(self.vae.encode(images, generator))

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        latent_hw: Optional[int] = None):
        """Standard-normal (B, C, hw, hw) latents from ``generator``, packed."""
        hw = latent_hw or self.latent_hw
        lat = torch.randn((batch, self.flux_cfg.in_channels // 4, hw, hw),
                          generator=generator, device=self.device, dtype=torch.float32)
        return pack_latents(lat)
