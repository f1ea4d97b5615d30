"""Text-to-image inference CLI, ported from adv_grpo_tpu/cli/infer.py.

Usage:
  python -m adv_grpo_torch.cli.infer --config eval_sd3_fast --prompts "a flower" \
      --set pretrained.model=DIR [--set text_embeds_dir=STORE] [--out_dir outputs] \
      [--device cuda]

  python -m adv_grpo_torch.cli.infer --config eval_sd3_fast --prompts "a flower" \
      --set "pretrained.model=''" [--device cuda]

  python -m adv_grpo_torch.cli.infer --config flux_smoke --prompts "a flower" \
      [--device cpu]

Deterministic eval rollout (noise level 0, seed 0): ``eval_num_steps`` steps
(sd3 with CFG; flux with its embedded guidance), VAE decode, one PNG per
prompt named ``node0_rank0_00000_{i}.png``. sd3 takes its weights from a
local diffusers-layout directory ``pretrained.model=DIR`` (check it first
with ``python -m adv_grpo_torch.models.convert --src DIR``) and its prompt
embeddings from ``text_embeds_dir`` (``cli.precompute_embeds``) or from the
directory's CLIP-L / CLIP-G / T5 encoders and tokenizers;
``pretrained.model=''`` is the full-size model with random
weights, ``smoke_test=True`` the tiny one. flux runs the tiny random-init
model; a set ``FLUX_DIR`` raises (the Flux loader is not ported yet).
``--lora DIR`` (or ``train.lora_path``) merges a peft adapter directory, such
as a training checkpoint's ``checkpoint-N/lora``, into the model first,
checked against ``train.lora_rank`` / ``train.lora_alpha``. The ``--image``
(distribution transfer) branch of the JAX CLI is not yet ported and raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def generate(pipeline, encode, prompts, config, seed: int = 0,
             latent_hw=None) -> torch.Tensor:
    """Images (N, 3, H, W) fp32 in about [-1, 1] for ``prompts``: the
    deterministic ``eval_num_steps`` rollout (sd3: with CFG; flux: the
    full-SDE sampler at noise level 0, guidance embedded), then the VAE
    decode."""
    dev = pipeline.device
    embeds, pooled = (torch.from_numpy(np.asarray(a)).to(dev) for a in encode(prompts))
    hw = latent_hw or int(config.resolution) // 8
    steps = int(config.sample.eval_num_steps)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if getattr(pipeline, "family", "sd3") == "flux":
        from adv_grpo_torch.rollout.flux import flux_denoise_window_with_logprob

        with torch.inference_mode():
            lat = pipeline.prepare_latents(generator, len(prompts), hw)
            vfn = pipeline.velocity_fn()
            out = flux_denoise_window_with_logprob(
                lambda x, t: vfn(x, t, embeds, pooled), lat, generator, steps, 0, 0.0, 0)
            return pipeline.decode(out.final_latents)

    from adv_grpo_torch.rollout.sampler import SamplerConfig, denoise_with_logprob

    neg_e, neg_p = (torch.from_numpy(np.asarray(a)).to(dev)
                    for a in encode([""] * len(prompts)))
    cfg = SamplerConfig(num_steps=steps, train_num_steps=0, noise_level=0.0,
                        guidance_scale=float(config.sample.guidance_scale))
    with torch.inference_mode():
        lat = pipeline.prepare_latents(generator, len(prompts), hw)
        out = denoise_with_logprob(pipeline.velocity_fn(), lat, embeds, pooled, neg_e,
                                   neg_p, generator, cfg)
        return pipeline.decode(out.final_latents)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="eval_sd3_fast")
    parser.add_argument("--prompts", required=True)
    parser.add_argument("--out_dir", default="outputs")
    parser.add_argument("--lora", default=None)
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--image", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override")
    args = parser.parse_args(argv)

    from PIL import Image

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_pipeline, build_text_encoder, resolve_config)
    from adv_grpo_torch.models.lora import merge_lora_params
    from adv_grpo_torch.train import checkpoint as ckpt_lib
    from adv_grpo_torch.utils.images import images_to_uint8

    config = apply_overrides(resolve_config(args.config), args.set)
    if args.image or str(config.get("external_image_path", "") or ""):
        raise NotImplementedError("--image distribution transfer (VAE encoder + "
                                  "denoise_from_image) is not yet ported")
    lora_path = args.lora or config.train.lora_path
    lora = None
    if lora_path:  # read and checked before the model is built
        lora = ckpt_lib.load_lora_only(lora_path, expect_rank=int(config.train.lora_rank),
                                       expect_alpha=float(config.train.lora_alpha))
    pipeline = build_pipeline(config, latent_hw=args.latent_hw, device=args.device)
    if lora is not None:
        merge_lora_params(pipeline.transformer, lora)
    encode = build_text_encoder(config, pipeline)
    prompts = [args.prompts]
    images = generate(pipeline, encode, prompts, config, seed=0,
                      latent_hw=args.latent_hw)

    os.makedirs(args.out_dir, exist_ok=True)
    u8 = images_to_uint8(images.float().cpu().numpy())
    paths = []
    for i, arr in enumerate(u8):
        path = os.path.join(args.out_dir, f"node0_rank0_00000_{i}.png")
        Image.fromarray(arr).save(path)
        paths.append(path)
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
