"""WAN text-to-video SDE rollout demo, ported from scripts/demo/wan_sde_demo.py.

Usage:
  python -m adv_grpo_torch.cli.wan_sde_demo [--config wan_smoke] [--kl_reward 0.1]
      [--deterministic] [--out_dir demo_outputs/wan] [--seed 0] [--device cuda]

The UniPC-schedule SDE rollout over 5-D video latents with per-step
log-probabilities (``rollout.wan.wan_denoise_with_logprob``), the optional
per-step KL against the adapter-free policy (``lora_scale=0``) and the
deterministic mode, then the 3D causal VAE decode into one frame-strip PNG
(``wan_det.png`` or ``wan_sde_kl{kl_reward}.png``); prints its path, the
mean log-prob and the mean KL. The model is ``cli.common.build_pipeline``'s,
sized for ``sample.num_frames`` frames of ``resolution``^2: the diffusers
directory ``WAN_DIR`` (``<root>/transformer``, the VAE from ``<root>/vae``)
where it is set, else the tiny random-init WAN. Its LoRA B starts at zero,
so the two policies coincide and the KL is 0, as in the JAX demo.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def sample_video(pipeline, latents, text, cfg, generator):
    """The demo's rollout and decode on any WAN pipeline: (the rollout
    result, video (B, F, 3, H, W) in [-1, 1]). ``text``: (B, S_txt,
    text_dim) states; ``cfg``: a ``WanSamplerConfig``."""
    from adv_grpo_torch.rollout.wan import wan_denoise_with_logprob

    policies = {s: pipeline.velocity_fn(s) for s in (1.0, 0.0)}
    with torch.inference_mode():
        out = wan_denoise_with_logprob(lambda x, t, s: policies[s](x, t, text), latents,
                                       generator, cfg)
        return out, pipeline.decode(out.final_latents)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="wan_smoke")
    parser.add_argument("--kl_reward", type=float, default=None,
                        help="override config.sample.kl_reward (> 0 records the per-step "
                             "KL against the lora_scale=0 policy)")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--out_dir", default="demo_outputs/wan")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    args = parser.parse_args(argv)

    from PIL import Image

    from adv_grpo_torch.cli.common import build_pipeline, resolve_config, resolve_device
    from adv_grpo_torch.rollout.wan import WanSamplerConfig
    from adv_grpo_torch.utils.images import images_to_uint8

    config = resolve_config(args.config)
    config.seed = args.seed
    device = resolve_device(args.device)
    pipeline = build_pipeline(config, device=device,
                              frames=int(config.sample.get("num_frames", 9)))
    g = torch.Generator(device=device).manual_seed(args.seed)
    latents = pipeline.prepare_latents(g, 1)
    text = torch.randn((1, pipeline.text_seq_len, pipeline.wan_cfg.text_dim), generator=g,
                       device=device)
    kl_reward = (args.kl_reward if args.kl_reward is not None
                 else float(config.sample.get("kl_reward", 0.0)))
    scfg = WanSamplerConfig(num_steps=int(config.sample.num_steps),
                            deterministic=args.deterministic, kl_reward=kl_reward)
    out, video = sample_video(pipeline, latents, text, scfg,
                              torch.Generator(device=device).manual_seed(args.seed + 1))

    frames_chw = video[0].float().cpu().numpy()  # (F, 3, H, W)
    strip = np.concatenate(list(frames_chw), axis=-1)  # (3, H, F*W)
    u8 = images_to_uint8(strip[None])[0]
    os.makedirs(args.out_dir, exist_ok=True)
    tag = "det" if args.deterministic else f"sde_kl{kl_reward:g}"
    path = os.path.join(args.out_dir, f"wan_{tag}.png")
    Image.fromarray(u8).save(path)
    print(path, "mean logprob:", float(out.log_probs.mean()), "mean KL:", float(out.kl.mean()))
    return path


if __name__ == "__main__":
    main()
