"""Gradio demo app, ported from adv_grpo_tpu/cli/app.py (reference app.py;
optional, gated on ``gradio``).

Usage:
  python -m adv_grpo_torch.cli.app --config eval_sd3_fast \\
      [--hub_repo benzweijia/Adv-GRPO | /local/adapters] [--adapters DINO,PickScore] \\
      [--lora DIR] [--set K=V ...] [--device cuda]

  * adapters: the subfolders of ``--hub_repo`` (``DINO/`` and
    ``PickScore/`` peft adapters in the published repo); a local directory
    with that layout is used in place, a hub id needs ``huggingface_hub``
    and the network (reference ``load_lora_from_subfolder``, app.py:27-44);
    ``--lora DIR`` adds one local adapter as "local";
  * a picker over the adapters and the untuned base model (reference
    app.py:74-131 fixes the DINO adapter at start);
  * ``generate(prompt, adapter, steps, guidance, seed)``: the deterministic
    CFG rollout at noise level 0 (40 steps and guidance 4.5 by default), the
    starting latents drawn from a generator seeded with ``seed`` (reference
    infer, app.py:137-198).

Every adapter read stays in a cache for the app's life (the JAX app's
``_merged_cache``, unevicted), and the chosen one is written into the one
transformer's LoRA parameters before each generation.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

BASE = "base (untuned)"


def resolve_adapter_dir(hub_repo: str, name: str, cache_root=None) -> str:
    """Adapter subfolder -> a local directory with the peft pair. A local
    ``hub_repo`` directory is used in place; a hub repo id is downloaded
    file by file as the reference does (``hf_hub_download(repo_id,
    subfolder=name, filename=...)``), which needs the network and
    ``huggingface_hub`` and fails loudly without them."""
    local = os.path.join(hub_repo, name)
    if os.path.isdir(local):
        return local
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise SystemExit(
            f"--hub_repo {hub_repo!r} is not a local directory and "
            "huggingface_hub is not installed; pass a local adapter layout "
            "(<dir>/<name>/adapter_model.safetensors) instead") from e
    local_dir = os.path.join(cache_root or os.path.join(tempfile.gettempdir(),
                                                        "adv_grpo_adapters"), name)
    os.makedirs(local_dir, exist_ok=True)
    for filename in ("adapter_config.json", "adapter_model.safetensors"):
        hf_hub_download(repo_id=hub_repo, repo_type="model", subfolder=name,
                        filename=filename, local_dir=local_dir, force_download=False)
    return os.path.join(local_dir, name)  # hf_hub_download keeps the subfolder


def make_generate(config, pipeline, encode, adapter_dirs, latent_hw=None):
    """The app's ``generate(prompt, adapter, steps, guidance, seed, latents=None)
    -> uint8 (H, W, 3)``: ``adapter`` names a key of ``adapter_dirs`` or
    anything else for the base model; ``latents`` (1, C, hw, hw) replace the
    seeded draw."""
    from adv_grpo_torch.cli.infer import sample_images
    from adv_grpo_torch.models.lora import lora_params, merge_lora_params
    from adv_grpo_torch.train import checkpoint as ckpt_lib
    from adv_grpo_torch.utils.images import images_to_uint8

    dev = pipeline.device
    hw = latent_hw or int(config.resolution) // 8
    base = {k: p.detach().clone() for k, p in lora_params(pipeline.transformer).items()}
    _merged_cache: dict = {}

    def lora_for(adapter: str):
        if adapter not in adapter_dirs:
            return {}
        if adapter not in _merged_cache:
            _merged_cache[adapter] = ckpt_lib.load_lora_only(
                adapter_dirs[adapter], expect_rank=int(config.train.lora_rank),
                expect_alpha=float(config.train.lora_alpha))
        return _merged_cache[adapter]

    def tensors(pair):
        return (torch.from_numpy(np.asarray(a)).to(dev) for a in pair)

    def generate(prompt, adapter, steps, guidance, seed, latents=None):
        merge_lora_params(pipeline.transformer, base)  # an adapter may hold fewer leaves
        merge_lora_params(pipeline.transformer, lora_for(adapter))
        embeds, pooled = tensors(encode([prompt]))
        neg_e, neg_p = tensors(encode([""]))
        img = sample_images(pipeline, embeds, pooled, neg_e, neg_p, int(steps), float(guidance),
                            torch.Generator(device=dev).manual_seed(int(seed)), hw, latents)
        return images_to_uint8(img.float().cpu().numpy())[0]

    return generate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="eval_sd3_fast")
    parser.add_argument("--lora", default=None,
                        help="single local adapter dir (listed as 'local')")
    parser.add_argument("--hub_repo", default=None,
                        help="hub repo id or local dir whose subfolders hold "
                             "peft adapters (reference: benzweijia/Adv-GRPO)")
    parser.add_argument("--adapters", default="DINO,PickScore",
                        help="comma-separated --hub_repo subfolder names")
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override")
    args = parser.parse_args(argv)

    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; use "
            "`python -m adv_grpo_torch.cli.infer` for CLI generation") from e

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_pipeline, build_text_encoder, resolve_config)

    config = apply_overrides(resolve_config(args.config), args.set)
    # adapter choices: hub / local subfolders, an optional --lora dir, the base
    adapter_dirs: dict = {}
    if args.hub_repo:
        for name in [a.strip() for a in args.adapters.split(",") if a.strip()]:
            adapter_dirs[name] = resolve_adapter_dir(args.hub_repo, name)
    if args.lora:
        adapter_dirs["local"] = args.lora
    choices = list(adapter_dirs) + [BASE]
    pipeline = build_pipeline(config, latent_hw=args.latent_hw, device=args.device)
    encode = build_text_encoder(config, pipeline)
    generate = make_generate(config, pipeline, encode, adapter_dirs, args.latent_hw)

    demo = gr.Interface(
        fn=generate,
        inputs=[gr.Textbox(label="Prompt"),
                gr.Dropdown(choices=choices, value=choices[0],
                            label="Adapter (reward model used for tuning)"),
                gr.Slider(1, 50, value=40, step=1, label="Steps"),
                gr.Slider(1.0, 10.0, value=4.5, label="Guidance"),
                gr.Number(value=0, label="Seed")],
        outputs=gr.Image(label="Generated"),
        title="adv_grpo_torch — GRPO-tuned flow-matching T2I",
    )
    demo.launch(server_port=args.port)
    return generate


if __name__ == "__main__":
    main()
