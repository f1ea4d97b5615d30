"""Reference-image set generation, ported from adv_grpo_tpu/cli/generate_refs.py.

Usage:
  python -m adv_grpo_torch.cli.generate_refs --text_file dataset/pickscore/test.txt \\
      --output_dir refs/ [--config eval_sd3_fast] [--num_variations 8] \\
      [--node_rank R --num_nodes N] [--limit N] [--device cuda]

Writes the prompt -> [image files] JSON and directory that
``config.json_path`` / ``config.reference_image_path`` name (reference
reference_imgs_scripts/qwen_generate_multi.py:122-136): for each prompt of
this node's share (``np.array_split`` over ``--num_nodes``),
``--num_variations`` images ``p{node}_{idx:06d}_v{v}.png`` from the
deterministic ``eval_num_steps`` CFG rollout at noise level 0, the starting
latents drawn from a ``torch.Generator`` seeded with the prompt's index in
the share (the JAX ``PRNGKey(p_idx)``); then ``prompt2img_node{R}.json``. A
prompt whose files all exist is skipped (resume by existence). The reference
generates with Qwen-Image; any local checkpoint the config names works, since
the contract is the JSON and the files. ``python -m
adv_grpo_torch.cli.validate_refs`` certifies the result.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main(argv=None, latents=None):
    """Generate this node's share; returns the JSON's path. ``latents``: a
    function of the prompt index giving that prompt's starting latents
    (num_variations, C, hw, hw), in place of the seeded draw."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="eval_sd3_fast")
    parser.add_argument("--text_file", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--num_variations", type=int, default=8)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override")
    args = parser.parse_args(argv)

    from PIL import Image

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_pipeline, build_text_encoder, resolve_config)
    from adv_grpo_torch.cli.infer import sample_images
    from adv_grpo_torch.utils.images import images_to_uint8

    config = apply_overrides(resolve_config(args.config), args.set)
    pipeline = build_pipeline(config, latent_hw=args.latent_hw, device=args.device)
    encode = build_text_encoder(config, pipeline)
    dev = pipeline.device

    with open(args.text_file) as f:
        prompts = [line.strip() for line in f if line.strip()]
    if args.limit:
        prompts = prompts[: args.limit]
    shard = np.array_split(prompts, args.num_nodes)[args.node_rank].tolist()
    hw = args.latent_hw or int(config.resolution) // 8
    steps = int(config.sample.eval_num_steps)
    guidance = float(config.sample.guidance_scale)

    def tensors(pair):
        return (torch.from_numpy(np.asarray(a)).to(dev) for a in pair)

    os.makedirs(args.output_dir, exist_ok=True)
    prompt2files = {}
    for p_idx, prompt in enumerate(shard):
        names = [f"p{args.node_rank}_{p_idx:06d}_v{v}.png" for v in range(args.num_variations)]
        prompt2files[prompt] = names
        if all(os.path.exists(os.path.join(args.output_dir, n)) for n in names):
            continue  # resume by existence
        embeds, pooled = tensors(encode([prompt] * args.num_variations))
        neg_e, neg_p = tensors(encode([""] * args.num_variations))
        images = sample_images(pipeline, embeds, pooled, neg_e, neg_p, steps, guidance,
                               torch.Generator(device=dev).manual_seed(p_idx), hw,
                               None if latents is None else latents(p_idx))
        for name, arr in zip(names, images_to_uint8(images.float().cpu().numpy())):
            Image.fromarray(arr).save(os.path.join(args.output_dir, name))

    json_path = os.path.join(args.output_dir, f"prompt2img_node{args.node_rank}.json")
    with open(json_path, "w") as f:
        json.dump(prompt2files, f, indent=1)
    print(json_path)
    return json_path


if __name__ == "__main__":
    main()
