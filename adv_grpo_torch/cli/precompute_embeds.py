"""Precompute text embeddings for a dataset, then train without the encoders.

Port of adv_grpo_tpu/cli/precompute_embeds.py.

Usage:
    python -m adv_grpo_torch.cli.precompute_embeds --config pickscore_cotrain_sd3_fast \
        --set pretrained.model=DIR --out embeds_store [--splits train,test] [--batch 32]

Then train or sample with ``--set pretrained.model=DIR --set
text_embeds_dir=embeds_store``: the trainer reads the memmap store, so CLIP-L,
CLIP-G and T5-XXL never sit on the card beside the policy. Tokenizing needs
the ``transformers`` package (the directory's ``tokenizer{,_2,_3}/``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", default="train,test")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--device", default="cuda",
                    help="torch device; with no CUDA device visible, 'cuda' raises")
    ap.add_argument("--allow-fallback", action="store_true",
                    help="permit the deterministic hash pseudo-encoder when the model dir "
                         "has no text_encoder/ (tests and smoke runs only: the store would "
                         "NOT hold real embeddings)")
    args = ap.parse_args(argv)

    import os

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_pipeline, build_text_encoder, resolve_config)
    from adv_grpo_torch.data.datasets import GenevalPromptDataset, TextPromptDataset
    from adv_grpo_torch.data.embed_store import write_store

    config = apply_overrides(resolve_config(args.config), args.set)
    # precomputing from an existing store, or from the hash pseudo-encoder,
    # would write a store of garbage that trains without any error anywhere
    if str(config.get("text_embeds_dir", "")):
        ap.error("config.text_embeds_dir is set — precompute would re-read the existing "
                 "store instead of encoding; unset it (--set text_embeds_dir=)")
    model_dir = str(config.pretrained.model)
    if not (model_dir and os.path.isdir(os.path.join(model_dir, "text_encoder"))):
        if not args.allow_fallback:
            ap.error(
                f"no text_encoder/ under {model_dir!r}: the real tri-encoder stack is "
                "unavailable, so the store would hold hash-based pseudo-embeddings. Point "
                "config.pretrained.model at a full SD3 diffusers dir, or pass "
                "--allow-fallback for smoke runs")
        print("WARNING: writing hash pseudo-embeddings (--allow-fallback)")
    pipeline = build_pipeline(config, device=args.device)
    encode = build_text_encoder(config, pipeline)

    prompts = [""]  # the negative prompt is part of every batch
    ds_dir = str(config.dataset)
    for split in args.splits.split(","):
        try:
            if str(config.prompt_fn) == "geneval":
                ds = GenevalPromptDataset(ds_dir, split)
            else:
                ds = TextPromptDataset(ds_dir, split)
        except (FileNotFoundError, OSError):
            print(f"split {split!r}: not found under {ds_dir}, skipping")
            continue
        prompts.extend(ds.prompts)
        print(f"split {split!r}: {len(ds.prompts)} prompts")
    out = write_store(args.out, prompts, encode, batch_size=args.batch, progress=True)
    print(f"wrote {out} ({len(set(prompts))} unique prompts)")
    return out


if __name__ == "__main__":
    main()
