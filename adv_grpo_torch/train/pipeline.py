"""SD3 pipeline bundle: MMDiT + VAE behind one object.

Port of adv_grpo_tpu/train/pipeline.py. ``random_init`` builds any size from
config with a ``torch.Generator`` (tests, benches, the weightless full-size
run); ``from_pretrained`` loads a local diffusers-layout directory
(``models.convert.load_sd3_pipeline``); ``from_jax`` takes the JAX package's
parameter trees, so both packages compute the same function.

Constructing a pipeline switches TF32 off for float32 matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, process-wide): the VAE decodes in fp32,
as the JAX model does, and cuDNN would otherwise run its convolutions in TF32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from adv_grpo_torch.models.convert import (
    mmdit_state_dict_from_jax, vae_state_dict_from_jax)
from adv_grpo_torch.models.lora import init_params_
from adv_grpo_torch.models.mmdit import MMDiT, MMDiTConfig
from adv_grpo_torch.models.vae import AutoencoderKL, VAEConfig


def _build(cls, cfg, device):
    """Allocate a module's parameters on ``device`` without initialising them."""
    return cls(cfg, device="meta").to_empty(device=device).eval()


@dataclasses.dataclass
class SD3Pipeline:
    mmdit_cfg: MMDiTConfig
    vae_cfg: VAEConfig
    mmdit: MMDiT
    vae: AutoencoderKL
    device: torch.device
    text_seq_len: int = 154  # 77 clip + 77 t5
    family: str = "sd3"

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ── constructors ──────────────────────────────────────────────────────

    @classmethod
    def random_init(cls, generator: torch.Generator, mmdit_cfg: MMDiTConfig,
                    vae_cfg: VAEConfig, device, dtype=None, text_seq_len: int = 154):
        """Random weights drawn from ``generator`` (which lives on ``device``);
        ``dtype`` overrides ``mmdit_cfg.dtype``. The VAE keeps ``vae_cfg.dtype``."""
        device = torch.device(device)
        if dtype is not None:
            mmdit_cfg = dataclasses.replace(mmdit_cfg, dtype=dtype)
        mmdit = init_params_(_build(MMDiT, mmdit_cfg, device), generator)
        vae = init_params_(_build(AutoencoderKL, vae_cfg, device), generator)
        return cls(mmdit_cfg, vae_cfg, mmdit, vae, device, text_seq_len=text_seq_len)

    @classmethod
    def from_jax(cls, transformer_params, vae_params, mmdit_cfg: MMDiTConfig,
                 vae_cfg: VAEConfig, device, text_seq_len: int = 154):
        """Weights from the JAX package's parameter trees (numpy leaves), cast
        to the configs' dtypes."""
        device = torch.device(device)
        mmdit = _build(MMDiT, mmdit_cfg, device)
        mmdit.load_state_dict(mmdit_state_dict_from_jax(transformer_params, mmdit_cfg))
        vae = _build(AutoencoderKL, vae_cfg, device)
        vae.load_state_dict(vae_state_dict_from_jax(vae_params, vae_cfg))
        return cls(mmdit_cfg, vae_cfg, mmdit, vae, device, text_seq_len=text_seq_len)

    @classmethod
    def from_pretrained(cls, model_dir: str, *, lora_rank: int = 0, lora_alpha: float = 1.0,
                        dtype=torch.bfloat16, device="cuda"):
        """The pipeline of a local diffusers-layout SD3 directory (see
        ``models.convert.load_sd3_pipeline``)."""
        from adv_grpo_torch.models import convert

        return convert.load_sd3_pipeline(model_dir, lora_rank=lora_rank, lora_alpha=lora_alpha,
                                         dtype=dtype, device=device)

    @property
    def transformer(self) -> MMDiT:
        """The denoiser under the name every family shares (the trainer's
        seam, as the JAX pipelines' ``transformer_params``)."""
        return self.mmdit

    # ── closures ──────────────────────────────────────────────────────────

    def velocity_fn(self, lora_scale: float = 1.0) -> Callable:
        """(latents, t, embeds, pooled) -> velocity."""

        def fn(latents, t, embeds, pooled):
            return self.mmdit(latents, t, embeds, pooled, lora_scale=lora_scale)

        return fn

    def decode(self, latents):
        """Raw final latents -> images in [-1, 1] (unscale by the VAE factors,
        then decode in fp32)."""
        z = latents.float() / self.vae_cfg.scaling_factor + self.vae_cfg.shift_factor
        return self.vae.decode(z)

    def encode_image(self, images, generator: Optional[torch.Generator] = None):
        """Images (B, 3, H, W) in [-1, 1] -> scaled latents, the entry of the
        image-to-image transfer: the VAE posterior's mode, or a sample drawn
        from ``generator``, as (z - shift) * scaling."""
        return self.vae.encode(images, generator)

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        latent_hw: Optional[int] = None):
        hw = latent_hw or 64
        return torch.randn((batch, self.mmdit_cfg.in_channels, hw, hw),
                           generator=generator, device=self.device, dtype=torch.float32)
