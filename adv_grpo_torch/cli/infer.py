"""Text-to-image inference CLI, ported from adv_grpo_tpu/cli/infer.py.

Usage:
  python -m adv_grpo_torch.cli.infer --config eval_sd3_fast --prompts "a flower" \
      --set pretrained.model=DIR [--set text_embeds_dir=STORE] [--out_dir outputs] \
      [--device cuda]

  python -m adv_grpo_torch.cli.infer --config eval_sd3_fast --prompts "a flower" \
      --set "pretrained.model=''" [--device cuda]

  python -m adv_grpo_torch.cli.infer --config flux_smoke --prompts "a flower" \
      [--device cpu]

  python -m adv_grpo_torch.cli.infer --config eval_sd3_fast --prompts "a flower" \
      --image photo.png [--start_idx 20] [--device cuda]

Deterministic eval rollout (noise level 0, seed 0): ``eval_num_steps`` steps
(sd3 with CFG; flux with its embedded guidance), VAE decode, one PNG per
prompt named ``node0_rank0_00000_{i}.png``. sd3 takes its weights from a
local diffusers-layout directory ``pretrained.model=DIR`` (check it first
with ``python -m adv_grpo_torch.models.convert --src DIR``) and its prompt
embeddings from ``text_embeds_dir`` (``cli.precompute_embeds``) or from the
directory's CLIP-L / CLIP-G / T5 encoders and tokenizers;
``pretrained.model=''`` is the full-size model with random
weights, ``smoke_test=True`` the tiny one. flux loads the diffusers
``FluxTransformer2DModel`` directory ``FLUX_DIR`` (``<root>/transformer``,
the VAE from ``<root>/vae``; ``--set resolution=512``) where it is set, else
runs the tiny random-init model.
``--lora DIR`` (or ``train.lora_path``) merges a peft adapter directory, such
as a training checkpoint's ``checkpoint-N/lora``, into the model first,
checked against ``train.lora_rank`` / ``train.lora_alpha``.

Image-to-image distribution transfer (sd3 only; a flux config raises):
``--image PATH`` (or ``config.external_image_path``) is resized (PIL
bicubic) to the latent side times the VAE's downscale, VAE-encoded,
forward-noised at schedule step ``--start_idx`` (default ``eval_num_steps //
2``) and denoised from there (``rollout.sampler.denoise_from_image``); the
steps before it are not run.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_image(path: str, size: int) -> np.ndarray:
    """The image at ``path`` as RGB, PIL-bicubic resized to ``size``^2, in
    [-1, 1], (1, 3, size, size) float32: the VAE encoder's input."""
    from PIL import Image

    pil = Image.open(path).convert("RGB").resize((size, size), Image.BICUBIC)
    return (np.asarray(pil, np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None]


def generate(pipeline, encode, prompts, config, seed: int = 0, latent_hw=None,
             image=None, start_idx=None) -> torch.Tensor:
    """Images (N, 3, H, W) fp32 in about [-1, 1] for ``prompts``: the
    deterministic ``eval_num_steps`` rollout (sd3: with CFG; flux: the
    full-SDE sampler at noise level 0, guidance embedded), then the VAE
    decode. sd3 with ``image`` ((1, 3, H, W) in [-1, 1], repeated per
    prompt): the distribution transfer from schedule step ``start_idx``
    (default ``eval_num_steps // 2``)."""
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

    from adv_grpo_torch.rollout.sampler import (
        SamplerConfig, denoise_from_image, denoise_with_logprob)

    neg_e, neg_p = (torch.from_numpy(np.asarray(a)).to(dev)
                    for a in encode([""] * len(prompts)))
    cfg = SamplerConfig(num_steps=steps, train_num_steps=0, noise_level=0.0,
                        guidance_scale=float(config.sample.guidance_scale))
    with torch.inference_mode():
        if image is not None:
            images = torch.from_numpy(np.repeat(np.asarray(image, np.float32), len(prompts),
                                                axis=0)).to(dev)
            out = denoise_from_image(
                pipeline.velocity_fn(), pipeline.encode_image, images, embeds, pooled, neg_e,
                neg_p, generator, cfg, start_idx=steps // 2 if start_idx is None else start_idx)
            return pipeline.decode(out.final_latents)
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
    parser.add_argument("--image", default=None,
                        help="external image for distribution transfer "
                             "(defaults to config.external_image_path)")
    parser.add_argument("--start_idx", type=int, default=None,
                        help="schedule step to forward-noise the external image at "
                             "(default: eval_num_steps // 2)")
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
    image_path = args.image or str(config.get("external_image_path", "") or "")
    if image_path and str(config.get("model_family", "sd3") or "sd3") == "flux":
        raise SystemExit("--image distribution transfer is an SD3 entry "
                         "(flux_to_sd3_denoise); use an sd3 config")
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
    image = None
    if image_path:
        hw = args.latent_hw or int(config.resolution) // 8
        image = load_image(image_path, hw * pipeline.vae_cfg.downscale)
    images = generate(pipeline, encode, prompts, config, seed=0, latent_hw=args.latent_hw,
                      image=image, start_idx=args.start_idx)

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
