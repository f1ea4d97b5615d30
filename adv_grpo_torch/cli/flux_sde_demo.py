"""Flux / Flux-Kontext full-SDE noise-level sweep demo, ported from
scripts/demo/flux_sde_demo.py.

Usage:
  python -m adv_grpo_torch.cli.flux_sde_demo [--config flux_smoke]
      [--noise_levels 0.0,0.4,0.7,0.9] [--out_dir demo_outputs/flux] [--kontext]
      [--seed 0] [--device cuda]

The same latents run through the full-SDE rollout
(``rollout.flux.flux_denoise_with_logprob``: every step the Flow-SDE step
with its log-probability) at each noise level, to show the
stochasticity-quality tradeoff. ``--kontext`` packs a conditioning latent
that rides the token sequence at each model call (its ids on frame 1), the
Kontext editing mode. Each level writes a channel-normalised picture of the
final latents' first three channels, 256^2 (``noise_{level}.png``, with
``kontext_`` in front under ``--kontext``; the demo's contract is the
sampler, not the VAE), and prints its path, the mean log-prob
("deterministic" at noise 0, where the Gaussian is degenerate) and the
final latents' std.

The model is ``cli.common.build_pipeline``'s: the diffusers directory
``FLUX_DIR`` (``<root>/transformer``) where it is set, else the tiny
random-init Flux (its LoRA B zero, so the adapter changes nothing). The
latents, the 4 text states, the pooled embedding and the conditioning
latent are drawn from ``torch.Generator(seed)``; the rollout's noise from
``seed + 1``, anew for each level.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

TEXT_TOKENS = 4


def sweep(transformer, latents, txt, pooled, noise_levels, num_steps: int, guidance: float,
          out_dir: str, seed: int = 0, cond=None):
    """The demo's loop on any Flux transformer: ``latents`` (1, C, 2gh, 2gw),
    ``txt`` (1, S_txt, joint_attention_dim), ``pooled`` (1,
    pooled_projection_dim), ``cond`` the unpacked conditioning latent or
    None. Returns [(PNG path, the rollout result)] per level."""
    from PIL import Image

    from adv_grpo_torch.models.flux import make_latent_ids
    from adv_grpo_torch.rollout.flux import (FluxSamplerConfig, flux_denoise_with_logprob,
                                             pack_latents, unpack_latents)
    from adv_grpo_torch.utils.images import images_to_uint8

    dev = latents.device
    h, w = latents.shape[2:]
    img_ids = make_latent_ids(h // 2, w // 2)
    packed = pack_latents(latents)
    if cond is not None:
        # the conditioning tokens: the same grid on frame 1
        cond_ids = img_ids.copy()
        cond_ids[:, 0] = 1
        img_ids = np.concatenate([img_ids, cond_ids], axis=0)
        cond = pack_latents(cond)
    txt_ids = np.zeros((txt.shape[1], 3), np.int32)

    def velocity_fn(tokens, t):
        g = torch.full((tokens.shape[0],), float(guidance), device=dev)
        return transformer(tokens, t, txt, pooled, img_ids, txt_ids, guidance=g)

    os.makedirs(out_dir, exist_ok=True)
    tag = "kontext_" if cond is not None else ""
    results = []
    for nl in noise_levels:
        with torch.inference_mode():
            out = flux_denoise_with_logprob(
                velocity_fn, packed, torch.Generator(device=dev).manual_seed(seed + 1),
                FluxSamplerConfig(num_steps=num_steps, noise_level=nl), cond_latents=cond)
        final = unpack_latents(out.final_latents, h, w)
        vis = final[0:1, :3].float().cpu().numpy()
        vis = vis / (np.abs(vis).max() + 1e-6)
        path = os.path.join(out_dir, f"{tag}noise_{nl:.1f}.png")
        Image.fromarray(images_to_uint8(vis)[0]).resize((256, 256), Image.NEAREST).save(path)
        lp = "deterministic" if nl == 0.0 else f"{float(out.log_probs.mean()):.4f}"
        print(path, "mean logprob:", lp,
              "| latent std:", f"{float(out.final_latents.std(correction=0)):.4f}")
        results.append((path, out))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="flux_smoke")
    parser.add_argument("--noise_levels", default="0.0,0.4,0.7,0.9")
    parser.add_argument("--out_dir", default="demo_outputs/flux")
    parser.add_argument("--kontext", action="store_true",
                        help="image-conditioned (Kontext) mode: a conditioning latent rides "
                             "the token sequence at each model call")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    args = parser.parse_args(argv)

    from adv_grpo_torch.cli.common import build_pipeline, resolve_config, resolve_device

    config = resolve_config(args.config)
    config.seed = args.seed
    device = resolve_device(args.device)
    pipeline = build_pipeline(config, device=device)
    fcfg = pipeline.flux_cfg
    # latent grid: resolution / 8 pixels per latent, packed 2x2 per token
    gh = max(2, int(config.resolution) // 16)
    g = torch.Generator(device=device).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    latents = randn(1, fcfg.in_channels // 4, 2 * gh, 2 * gh)
    txt = randn(1, TEXT_TOKENS, fcfg.joint_attention_dim)
    pooled = randn(1, fcfg.pooled_projection_dim)
    cond = randn(*latents.shape) if args.kontext else None
    return sweep(pipeline.transformer, latents, txt, pooled,
                 [float(x) for x in args.noise_levels.split(",")],
                 int(config.sample.num_steps), float(config.sample.guidance_scale),
                 args.out_dir, args.seed, cond)


if __name__ == "__main__":
    main()
