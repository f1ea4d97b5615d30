"""Shared CLI plumbing: config presets, pipeline assembly, text encoding.

Port of the SD3 parts of adv_grpo_tpu/cli/common.py:88-240. The ``a.b=value``
override parser and the deterministic hash text encoder are the JAX package's
own (both jax-free).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from adv_grpo_tpu.cli.common import apply_overrides, make_hash_text_encoder

__all__ = ["apply_overrides", "build_pipeline", "build_text_encoder", "compute_dtype",
           "resolve_config", "resolve_device"]

_FP32 = ("fp32", "float32", "no")
_BF16 = ("bf16", "bfloat16", "fp16", "float16")


def resolve_config(spec: str):
    """'module_path:preset' or a bare preset name -> config dict."""
    from adv_grpo_torch.config import grpo

    return grpo.get_config(spec.rsplit(":", 1)[-1])


def compute_dtype(config) -> torch.dtype:
    """The MMDiT dtype from ``mixed_precision`` ("fp16" maps to bf16)."""
    want = str(config.get("mixed_precision", "bf16"))
    if want not in _FP32 + _BF16:
        raise ValueError(f"Unrecognized mixed_precision {want!r}; expected one of "
                         f"{_FP32 + _BF16}")
    return torch.float32 if want in _FP32 else torch.bfloat16


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not visible raises
    (there is no silent fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for but no CUDA device is "
                           "visible; pass --device cpu to run on the CPU")
    return device


def build_pipeline(config, latent_hw: Optional[int] = None, device="cuda"):
    """The SD3 pipeline for ``config`` on ``device``: the tiny random-init
    model for ``smoke_test=True``, the full-size SD3.5-M with random weights
    for ``pretrained.model=''``. Weights come from ``torch.Generator(seed)`` on
    that device."""
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.pipeline import SD3Pipeline

    device = resolve_device(device)
    model_dir = str(config.pretrained.model or "")
    smoke = bool(config.get("smoke_test", False))
    dtype = compute_dtype(config)
    if model_dir and os.path.isdir(model_dir):
        raise NotImplementedError(
            f"loading the diffusers checkpoint at {model_dir!r} is not yet ported "
            "to adv_grpo_torch; use pretrained.model='' (full-size random init) "
            "or smoke_test=True")
    if model_dir and not smoke:
        raise FileNotFoundError(
            f"config.pretrained.model={model_dir!r} is not a local diffusers-layout "
            "weights directory; set smoke_test=True / pretrained.model='' for an "
            "explicitly random-init run")
    family = str(config.get("model_family", "sd3") or "sd3")
    if family != "sd3":
        raise NotImplementedError(f"model_family={family!r} is not yet ported to "
                                  "adv_grpo_torch (sd3 only)")
    lora_rank = int(config.train.lora_rank) if config.use_lora else 0
    generator = torch.Generator(device=device).manual_seed(int(config.seed))
    if smoke:
        mmdit_cfg = MMDiTConfig.tiny(num_layers=2, dual_attention_layers=(0,),
                                     lora_rank=max(lora_rank, 1) if lora_rank else 4)
        return SD3Pipeline.random_init(generator, mmdit_cfg,
                                       VAEConfig.tiny(latent_channels=16), device,
                                       text_seq_len=6)
    mmdit_cfg = MMDiTConfig.sd35_medium(lora_rank=lora_rank,
                                        lora_alpha=float(config.train.lora_alpha))
    return SD3Pipeline.random_init(generator, mmdit_cfg, VAEConfig.sd3(), device, dtype)


def build_text_encoder(config, pipeline):
    """Text-embedding source: a precomputed ``EmbeddingStore`` when
    ``config.text_embeds_dir`` is set, else the deterministic hash encoder at
    the model's widths (the real CLIP/T5 stack is not yet ported)."""
    store_dir = str(config.get("text_embeds_dir", ""))
    if store_dir:
        from adv_grpo_tpu.data.embed_store import EmbeddingStore

        return EmbeddingStore(store_dir)
    model_dir = str(config.pretrained.model or "")
    if model_dir and os.path.isdir(os.path.join(model_dir, "text_encoder")):
        raise NotImplementedError("the CLIP-L/G + T5 text encoders are not yet ported "
                                  "to adv_grpo_torch; set text_embeds_dir")
    mcfg = pipeline.mmdit_cfg
    return make_hash_text_encoder(seq_len=pipeline.text_seq_len,
                                  embed_dim=mcfg.joint_attention_dim,
                                  pooled_dim=mcfg.pooled_projection_dim)
