"""Batch eval / generation CLI, ported from adv_grpo_tpu/cli/eval.py
(reference scripts/eval.py).

Usage:
  python -m adv_grpo_torch.cli.eval --config eval_sd3_fast --out_dir eval_outputs \\
      [--lora DIR] [--limit N] [--batch B] [--rewards] [--set K=V ...] [--device cuda]
  torchrun --nproc_per_node=N -m adv_grpo_torch.cli.eval --config eval_sd3_fast ...

Samples the test split of ``config.dataset`` deterministically (noise level
0, ``eval_num_steps`` steps; sd3 with CFG, flux with its embedded guidance;
every batch starts from a generator seeded 0, as the JAX eval reuses
``PRNGKey(0)``), saves one PNG per prompt named
``node0_rank{r}_{idx:05d}_0.png`` by the prompt's global index, and writes
``prompt2img.json`` (prompt -> files). ``--lora DIR`` (or
``train.lora_path``) merges a peft adapter first, as ``cli.infer`` does.
``--rewards`` scores the images with ``config.eval_reward_fn`` (else
``reward_fn``); without a reference store (``test_reference_image_path`` and
``json_path``) the rewards that need reference images are dropped.

Several processes (one per device; ``torchrun``, or a group the caller
initialized): the prompts are split into contiguous per-rank shards
(``np.array_split``); every rank runs the same number of batches, a short
shard padding with its last prompt and an empty shard generating from "";
padding is left out of the files and the means. Each rank writes
``prompt2img_rank{r}.json``; after a barrier rank 0 merges them. The reward
means come from (sum, count) all-gathers over a fixed key order, and a rank
whose rows are all padding still scores, so every rank runs the same
collectives.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

NEEDS_REFS = {"image_similarity", "image_similarity_eval", "siglip_image_similarity",
              "constractive_external"}


def _pad_rows(rows, total):
    """Pad a list to ``total`` entries by repeating the last one."""
    return rows + [rows[-1]] * (total - len(rows))


def main(argv=None, latents=None):
    """Run the eval; returns {"n_saved", "reward_means", "reward_counts",
    "out_dir"} (means and counts over every rank). ``latents``: the starting
    latents of every batch (sd3 (batch, C, hw, hw), flux packed), in place of
    the seeded draw."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="eval_sd3_fast")
    parser.add_argument("--out_dir", default="eval_outputs")
    parser.add_argument("--lora", default=None)
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--rewards", action="store_true",
                        help="score generated images with config.eval_reward_fn "
                             "(reference scripts/eval.py:260-301)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override")
    args = parser.parse_args(argv)

    from PIL import Image

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_pipeline, build_text_encoder, join_group, resolve_config)
    from adv_grpo_torch.cli.infer import sample_images
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.models.lora import merge_lora_params
    from adv_grpo_torch.parallel import mesh
    from adv_grpo_torch.train import checkpoint as ckpt_lib
    from adv_grpo_torch.utils.images import images_to_uint8

    config = apply_overrides(resolve_config(args.config), args.set)
    lora_path = args.lora or config.train.lora_path
    lora = None
    if lora_path:  # read and checked before the model is built
        lora = ckpt_lib.load_lora_only(lora_path, expect_rank=int(config.train.lora_rank),
                                       expect_alpha=float(config.train.lora_alpha))
    device = join_group(args.device)
    pipeline = build_pipeline(config, latent_hw=args.latent_hw, device=device)
    if lora is not None:
        merge_lora_params(pipeline.transformer, lora)
    encode = build_text_encoder(config, pipeline)
    dev = pipeline.device

    dataset = TextPromptDataset(str(config.dataset), "test")
    prompts = dataset.prompts[: args.limit] if args.limit else dataset.prompts

    # contiguous per-rank shard; the global index names the PNGs
    n_proc, rank = mesh.world_size(), mesh.rank()
    shards = np.array_split(np.arange(len(prompts)), n_proc)
    local_idx = shards[rank].tolist()
    local_prompts = [prompts[i] for i in local_idx]
    # lockstep: every rank runs ceil(max_shard / bs) batches (at least one)
    bs = args.batch or int(config.sample.test_batch_size)
    max_shard = max(len(s) for s in shards)
    num_batches = max(-(-max_shard // bs), 1)
    steps = int(config.sample.eval_num_steps)
    guidance = float(config.sample.guidance_scale)
    hw = args.latent_hw or int(config.resolution) // 8

    reward_fn = None
    if args.rewards:
        from adv_grpo_torch.cli.common import build_reward_context
        from adv_grpo_torch.rewards.registry import multi_score

        names = dict(config.eval_reward_fn) or dict(config.reward_fn)
        store = None
        if str(config.test_reference_image_path) and str(config.json_path):
            from adv_grpo_torch.data.datasets import ReferenceImageStore

            store = ReferenceImageStore(str(config.json_path),
                                        str(config.test_reference_image_path),
                                        resolution=int(config.resolution))
        else:
            dropped = sorted(set(names) & NEEDS_REFS)
            if dropped:
                print(f"no reference-image store configured; skipping {dropped}")
                names = {k: v for k, v in names.items() if k not in NEEDS_REFS}
        ctx = build_reward_context(config, set(names), device=dev)
        reward_fn = (multi_score(names, ctx), store)

    os.makedirs(args.out_dir, exist_ok=True)
    reward_sums, reward_counts = {}, {}
    prompt2files = {}
    n_saved = 0
    # the negative-prompt embeddings are the same for every batch: encoded once
    neg_e, neg_p = (torch.from_numpy(np.asarray(a)).to(dev) for a in encode([""] * bs))
    for b in range(num_batches):
        start = b * bs
        rows = local_prompts[start:start + bs]
        valid = len(rows)  # rows past this are padding (left out everywhere)
        if valid == 0:
            rows, valid = [local_prompts[-1] if local_prompts else ""], 0
        chunk = _pad_rows(rows, bs)
        embeds, pooled = (torch.from_numpy(np.asarray(a)).to(dev) for a in encode(chunk))
        images = sample_images(pipeline, embeds, pooled, neg_e, neg_p, steps, guidance,
                               torch.Generator(device=dev).manual_seed(0), hw, latents)
        if reward_fn is not None:
            # scored even when valid == 0 (an all-padding shard): the means
            # run one collective per key, so every rank must hold the same keys
            fn, store = reward_fn
            refs = store.get_batch(chunk) if store is not None else None
            details, _ = fn(images, chunk, [{}] * len(chunk), ref_images=refs)
            for key, val in details.items():
                val = np.asarray(val, np.float64).reshape(-1)
                if val.shape[0] != len(chunk):
                    continue  # embedding outputs (feat / ref_feat), not scores
                reward_sums[key] = reward_sums.get(key, 0.0) + float(val[:valid].sum())
                reward_counts[key] = reward_counts.get(key, 0) + valid
        u8 = images_to_uint8(images[:valid].float().cpu().numpy())
        for i in range(valid):
            idx = local_idx[start + i]  # the GLOBAL index: unique across ranks
            name = f"node0_rank{rank}_{idx:05d}_0.png"
            Image.fromarray(u8[i]).save(os.path.join(args.out_dir, name))
            prompt2files.setdefault(chunk[i], []).append(name)
            n_saved += 1

    # each rank writes its shard of the prompt -> files map (the ranks share
    # the output directory), rank 0 merges them after a barrier; the shards
    # are disjoint by construction, so the merge cannot duplicate entries
    with open(os.path.join(args.out_dir, f"prompt2img_rank{rank}.json"), "w") as f:
        json.dump(prompt2files, f)
    mesh.barrier()
    if rank == 0:
        merged = {}
        for fname in sorted(os.listdir(args.out_dir)):
            if fname.startswith("prompt2img_rank") and fname.endswith(".json"):
                with open(os.path.join(args.out_dir, fname)) as f:
                    for k, v in json.load(f).items():
                        merged.setdefault(k, []).extend(v)
        with open(os.path.join(args.out_dir, "prompt2img.json"), "w") as f:
            json.dump(merged, f, indent=1)
    print(f"wrote {n_saved} images to {args.out_dir}")
    # the global means: numeric (sum, count) all-gathers over a fixed key order
    means, counts = {}, {}
    for key in sorted(reward_sums):
        sc = mesh.process_allgather(
            [np.asarray([reward_sums[key], reward_counts[key]], np.float64)])[0]
        sc = np.asarray(sc).reshape(-1, 2).sum(axis=0)
        means[key], counts[key] = sc[0] / max(sc[1], 1), int(sc[1])
        print(f"eval_reward_{key}: {means[key]:.6f}")
    return {"n_saved": n_saved, "reward_means": means, "reward_counts": counts,
            "out_dir": args.out_dir}


if __name__ == "__main__":
    main()
