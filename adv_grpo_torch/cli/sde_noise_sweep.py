"""SD3 noise-level sweep demo, ported from scripts/demo/sde_noise_sweep.py.

Usage:
  python -m adv_grpo_torch.cli.sde_noise_sweep [--config eval_sd3_fast]
      [--prompts "a photo of a red panda"] [--noise_levels 0.0,0.4,0.7,0.9]
      [--out_dir demo_outputs] [--latent_hw N] [--device cuda]

Renders one prompt at several noise levels with the CPS sampler
(``rollout.sampler.denoise_with_logprob``, every step in the stochastic
window, CFG at the config's guidance scale) to show the
stochasticity-quality tradeoff: one PNG per level (``noise_{level}.png``)
and its mean log-prob. The model and the text encoder are
``cli.common``'s (``build_pipeline``, ``build_text_encoder``); as in the
JAX script, every level starts from the same latents, drawn from
``torch.Generator(0)``, and its rollout draws its noise from a generator
seeded 0 too.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def sweep(pipeline, encode, prompt: str, noise_levels, num_steps: int, guidance: float,
          latent_hw: int, out_dir: str):
    """The demo's loop on an SD3 pipeline and a text encoder (``encode(list
    of prompts) -> (embeds, pooled)`` numpy): returns [(PNG path, the
    rollout result)] per level."""
    from PIL import Image

    from adv_grpo_torch.rollout.sampler import SamplerConfig, denoise_with_logprob
    from adv_grpo_torch.utils.images import images_to_uint8

    dev = pipeline.device
    embeds, pooled = (torch.from_numpy(np.asarray(a)).to(dev) for a in encode([prompt]))
    neg_e, neg_p = (torch.from_numpy(np.asarray(a)).to(dev) for a in encode([""]))
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for nl in noise_levels:
        cfg = SamplerConfig(num_steps=num_steps, train_num_steps=num_steps, noise_level=nl,
                            guidance_scale=guidance)
        lat = pipeline.prepare_latents(torch.Generator(device=dev).manual_seed(0), 1, latent_hw)
        with torch.inference_mode():
            out = denoise_with_logprob(pipeline.velocity_fn(), lat, embeds, pooled, neg_e, neg_p,
                                       torch.Generator(device=dev).manual_seed(0), cfg, 0)
            img = pipeline.decode(out.final_latents)
        u8 = images_to_uint8(img.float().cpu().numpy())[0]
        path = os.path.join(out_dir, f"noise_{nl:.1f}.png")
        Image.fromarray(u8).save(path)
        print(path, "mean logprob:", float(out.log_probs.mean()))
        results.append((path, out))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="eval_sd3_fast")
    parser.add_argument("--prompts", default="a photo of a red panda")
    parser.add_argument("--noise_levels", default="0.0,0.4,0.7,0.9")
    parser.add_argument("--out_dir", default="demo_outputs")
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    args = parser.parse_args(argv)

    from adv_grpo_torch.cli.common import (build_pipeline, build_text_encoder, resolve_config,
                                           resolve_device)

    config = resolve_config(args.config)
    device = resolve_device(args.device)
    pipeline = build_pipeline(config, latent_hw=args.latent_hw, device=device)
    return sweep(pipeline, build_text_encoder(config, pipeline), args.prompts,
                 [float(x) for x in args.noise_levels.split(",")],
                 int(config.sample.num_steps), float(config.sample.guidance_scale),
                 args.latent_hw or int(config.resolution) // 8, args.out_dir)


if __name__ == "__main__":
    main()
