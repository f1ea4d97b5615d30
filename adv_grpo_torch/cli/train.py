"""Training CLI, ported from adv_grpo_tpu/cli/train.py (one process per device).

Usage:
  python -m adv_grpo_torch.cli.train --config smoke_sd3_fast \\
      --set smoke_test=False --set sample.num_steps=10 \\
      --set sample.train_batch_size=2 --max_epochs 2 [--device cuda]
  python -m adv_grpo_torch.cli.train --config pickscore_cotrain_sd3_fast \\
      --set pretrained.model=DIR --set text_embeds_dir=STORE ...
  python -m adv_grpo_torch.cli.train --config flux_smoke --max_epochs 2 [--device cpu]
  python -m adv_grpo_torch.cli.train --config pickscore_cotrain_sd3_fast \\
      --set smoke_test=True --set json_path=REFS.json \\
      --set reference_image_path=REF_DIR --max_epochs 2 [--device cpu]
  torchrun --nproc_per_node=N -m adv_grpo_torch.cli.train --config smoke_sd3_fast ...

Under ``torchrun`` (or any launcher that sets ``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) every process joins the group
(``parallel.mesh.init_distributed``: NCCL for ``--device cuda``, which then
means ``cuda:$LOCAL_RANK``; gloo for ``--device cpu``) and trains on its share
of each batch; with an empty ``save_dir`` rank 0's timestamp names the run
directory of every rank.

Rewards, budgets, the optimizer and the discriminator come from the preset.
``pickscore_cotrain_sd3_fast`` co-trains the PickScore reward;
``dino_cotrain_sd3_fast``, ``dino_cotrain_sd3_patch_fast`` and
``dino_cotrain_sd3_multi_fast`` a DINO head (or per-layer heads and their
fusion) on a frozen DINOv2 backbone. The reference images come from
``json_path`` (prompt -> files) and ``reference_image_path``; CLIP-H and
DINOv2-B/14 run on random weights (tiny towers with ``smoke_test``). The SD3
policy takes its weights from a local diffusers-layout directory
``pretrained.model=DIR`` and its prompt embeddings from ``text_embeds_dir``
(``cli.precompute_embeds``) or the directory's text encoders; with
``pretrained.model=''`` it is the full-size model with random weights. Flux
and WAN load the diffusers transformer directory ``FLUX_DIR`` / ``WAN_DIR``
(``<root>/transformer``, the VAE from ``<root>/vae``) where it is set, else
run their tiny random-init models.

Checkpoints (``train/checkpoint.py``) land every ``save_freq`` epochs under
``save_dir/checkpoints/checkpoint-{global_step}``. ``--resume PATH|latest``
restores the whole state of one (``latest``: the newest under ``save_dir``)
and wins over ``train.lora_path``, a peft adapter directory that warm-starts
the generator's LoRA; ``weight_path``, a checkpoint directory or a flax
``.msgpack`` of parameters (``cli.finetune_pickscore``'s, checked before the
model is built), warm-starts the discriminator. Not ported yet, and refused
with ``NotImplementedError``: the rewards ``rewards.registry`` does not
list.

``pickscore_sd3_fast`` (PickScore + OCR on ``dataset/ocr``) needs an OCR
engine: PaddleOCR where it can be imported, else a callable uint8 (H, W, 3)
-> str passed as ``main(argv, ocr_engine=...)``. ``sample.same_latent=True``
(sd3, groups of more than one image) samples through the group-shared
prefix. CLIP-L (``clipscore``, ``aesthetic``) reads ``CLIP_DIR``, the
aesthetic head ``AESTHETIC_PATH`` (e.g.
``adv_grpo_tpu/data/assets/sac+logos+ava1-l14-linearMSE.pth``).
"""

from __future__ import annotations

import argparse
import datetime
import os


def build_trainer(config, latent_hw=None, dataset=None, device="cuda", ocr_engine=None):
    """The ``GRPOTrainer`` of ``config``: the pipeline, the reward context
    (``ocr_engine``: the OCR rewards' engine, a callable uint8 (H, W, 3) ->
    str; PaddleOCR where it can be imported if None), the discriminator, the
    dataset and the reference store."""
    import copy

    from adv_grpo_torch.cli.common import (
        build_pipeline, build_reward_context, build_text_encoder)
    from adv_grpo_torch.data.datasets import (
        GenevalPromptDataset, ReferenceImageStore, TextPromptDataset)
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.train.driver import DiscriminatorBundle, GRPOTrainer
    from adv_grpo_torch.train.grpo_trainer import (
        make_dino_d_step, make_dino_multi_d_step, make_pickscore_d_step)

    pipeline = build_pipeline(config, latent_hw=latent_hw, device=device)
    ctx = build_reward_context(
        config, set(dict(config.reward_fn)) | set(dict(config.eval_reward_fn)),
        device=pipeline.device, ocr_engine=ocr_engine)
    disc = None
    kind = str(config.discriminator) if bool(config.train_d) else ""
    if kind == "pickscore":
        step_fn, optimizer, tail = make_pickscore_d_step(
            ctx.pickscore, int(config.tune_layer), float(config.d_lr))
        disc = DiscriminatorBundle("pickscore", step_fn, optimizer, tail, tokenize=ctx.tokenize)
        # the frozen 'pickscore' reward keeps the tail as it starts; the D-step
        # updates the live one in place
        ctx.pickscore_params = tail
        ctx.pickscore_frozen_params = copy.deepcopy(tail).requires_grad_(False)
    elif kind:
        # the DINO kinds: the reward reads the live head (dino_multi: heads and
        # fusion), which the D-step updates in place; nothing frozen reads it
        multi = kind == "dino_multi"
        scorer = ctx.dino_multi if multi else ctx.dino
        if scorer is None:
            raise ValueError(f"discriminator={kind!r} needs its DINO reward in the preset's "
                             "reward_fn or eval_reward_fn")
        params = ctx.dino_multi_params if multi else ctx.dino_head_params
        make = make_dino_multi_d_step if multi else make_dino_d_step
        step_fn, optimizer = make(scorer, params, float(config.d_lr))
        disc = DiscriminatorBundle(kind, step_fn, optimizer, params, backbone=ctx.dino.vision)
    reward_fn = multi_score(dict(config.reward_fn), ctx)
    eval_reward_fn = (multi_score(dict(config.eval_reward_fn), ctx)
                      if dict(config.eval_reward_fn) else None)
    encode = build_text_encoder(config, pipeline)

    if dataset is None:
        ds_dir = str(config.dataset)
        limit = config.get("limit", None)
        # config.prompt_fn selects the dataset flavour; file presence decides
        # for other prompt_fn values
        pf = str(config.get("prompt_fn", ""))
        if pf == "geneval" or (pf != "general_ocr" and os.path.exists(
                os.path.join(ds_dir, "train_metadata.jsonl"))):
            dataset = GenevalPromptDataset(ds_dir, "train", limit=limit)
        else:
            dataset = TextPromptDataset(ds_dir, "train", limit=limit)

    ref_store = None
    if str(config.json_path) and os.path.exists(str(config.json_path)):
        ref_store = ReferenceImageStore(str(config.json_path), str(config.reference_image_path),
                                        resolution=int(config.resolution))
    trainer = GRPOTrainer(config, pipeline, dataset, encode, reward_fn,
                          eval_reward_fn=eval_reward_fn,
                          latent_hw=latent_hw or int(config.resolution) // 8,
                          reference_store=ref_store, discriminator=disc, reward_ctx=ctx)
    weight_path = config.get("weight_path", None)
    if disc is not None and weight_path:
        # the discriminator's warm start from an earlier adversarial checkpoint
        trainer.restore_discriminator(str(weight_path))
    return trainer


def main(argv=None, ocr_engine=None):
    """Parse ``argv``, build the trainer (``ocr_engine``: see
    :func:`build_trainer`), run it; returns the trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--latent_hw", type=int, default=None)
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override, e.g. --set train.learning_rate=1e-4")
    parser.add_argument("--resume", default=None, metavar="PATH|latest")
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    args = parser.parse_args(argv)

    from adv_grpo_torch.cli.common import apply_overrides, join_group, resolve_config
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.parallel import mesh
    from adv_grpo_torch.train import checkpoint as ckpt_lib

    config = apply_overrides(resolve_config(args.config), args.set)
    # what cannot be read fails before the model is built
    weight_path = str(config.get("weight_path", None) or "")
    if bool(config.train_d) and weight_path.endswith(".msgpack"):
        from adv_grpo_torch.utils import msgpack_io

        msgpack_io.check_map(weight_path)
    lora_path = None if args.resume else config.train.get("lora_path", None)
    if lora_path:
        ckpt_lib.load_lora_only(str(lora_path), expect_rank=int(config.train.lora_rank),
                                expect_alpha=float(config.train.lora_alpha))
    device = join_group(args.device)
    if not str(config.save_dir):
        # reference run layout: logdir/run_name(+unique timestamp); every rank
        # takes rank 0's timestamp (now() can cross a second between ranks)
        import numpy as np

        unique = datetime.datetime.now().strftime("%Y.%m.%d_%H.%M.%S")
        buf = np.frombuffer(unique.encode().ljust(32), dtype=np.uint8)
        unique = bytes(mesh.broadcast_one_to_all(buf)).decode().strip()
        run = str(config.run_name)
        config.run_name = (run + "_" + unique) if run else unique
        config.save_dir = os.path.join(str(config.logdir), config.run_name)
    resume = args.resume
    if resume == "latest":
        resume = ckpt_lib.latest_checkpoint(str(config.save_dir))
        if resume is None:
            raise FileNotFoundError(f"--resume latest: no checkpoints under "
                                    f"{config.save_dir}/checkpoints")
    trainer = build_trainer(config, latent_hw=args.latent_hw, device=device,
                            ocr_engine=ocr_engine)
    # the whole state of a checkpoint supersedes the LoRA warm start
    if resume:
        trainer.restore(resume)
    elif lora_path:
        trainer.warm_start_lora(str(lora_path))
    eval_prompts = None
    try:
        test_ds = TextPromptDataset(str(config.dataset), "test")
        eval_prompts = test_ds.prompts[: int(config.sample.test_batch_size)]
    except OSError:
        pass
    trainer.run(max_epochs=args.max_epochs, eval_prompts=eval_prompts)
    return trainer


if __name__ == "__main__":
    main()
