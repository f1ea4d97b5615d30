#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is non-zero):

  1. the card's name and power limit, from nvidia-smi;
  2. build the CUDA kernels from adv_grpo_torch/csrc (nvcc, ctypes);
  3. each forward kernel against its plain PyTorch version at the SD3.5-M
     512^2 shapes, with max errors, stated bounds and median times; the
     joint forward #2 and its single-stream form #3 (JOINT_CASES at CFG
     batch 2 and 8, and JOINT_EDGES: ragged tile edges on both streams)
     against fp32, against their kernel-order twin and against the parent's
     error on the same inputs (JOINT_PARENT_ERR);
  4. the two joint attention backwards #4 and #5 (and the lse the forwards
     write for them) against their plain twin at the training shape, CFG
     batch 8: relative L2 per cotangent, the operands their pre-pass wrote
     (q^, q_s, k^) bitwise against the twin's, median times beside SDPA's
     backward on the normalised streams (not the same function), and the
     whole autograd backward against fp32 autograd of the plain forward;
  5. a 2-layer full-width MMDiT on the card (bf16, kernels) against the same
     weights on the CPU (fp32, plain versions) on a small input: the output,
     then the LoRA gradients through a fixed cotangent;
  6. ``adv_grpo_torch.cli.infer.main`` at the full SD3.5-M width (random
     weights from the seed), 512^2, 40 steps, CFG 4.5: the PNG must be
     512x512 and non-constant, and the kernel launch counts must be exactly
     109/24/13 per MMDiT forward times 40 steps;
  7. the same pipeline at 1 prompt (CFG batch 2) and 4 prompts (CFG batch 8):
     finite images, seconds per image, one MMDiT forward's time and its
     device time by kernel group (torch.profiler); then the SD3 noise sweep
     (``cli.sde_noise_sweep.sweep``) on it at DEMO_LEVELS, DEMO_STEPS steps:
     a 512x512 PNG a level, the levels' PNGs different, finite log-probs;
  8. kernels #10 / #11 (``mha`` on (B, H, S, D)) against their plain
     versions at MHA_SHAPES (WAN's 12x128 at 8,100 tokens, SD3.5-M's 24x64
     joint 1,178 tokens with kv_len 1,100, 2,025 queries against 8,100 keys):
     output within MHA_O_REL_L2 relative L2 and lse within MHA_LSE_ABS
     absolute, dq / dk / dv within 2e-2 relative L2; #11's
     fidelity against fp64 at the WAN shape (FIDELITY_FACTOR of its fp32 twin
     rounded to bf16, #9's bf16 order beside it); median times beside the
     plain versions' and SDPA's;
  9. a one-rank NCCL process group (``parallel.mesh.init_distributed`` on a
     free localhost port); ``context_parallel_attention`` forward and
     backward at each of those shapes (gather / reduce-scatter collectives;
     exactly one #10 and one #11 launch each) against fp32 autograd, and
     ``ring_attention`` at the WAN shape against ``mha`` (outputs within
     MHA_O_REL_L2 relative L2, gradients 2e-2);
 10. inside that group, ``adv_grpo_torch.cli.train.main`` on
     ``smoke_sd3_fast`` at the full SD3.5-M width (TRAIN_ARGV): 2 GRPO epochs
     of 10-step rollouts, the jpeg_compressibility reward and the LoRA
     update, with the trainer's id / reward gathers and the LoRA gradient
     all-reduce running as collectives. Finite reward, loss, approx_kl and
     clipfrac in both epochs; the LoRA changed and finite; the EMA moved; the
     launch counts of all five kernels exactly as derived from the config;
     seconds per epoch (rollout, reward, train), per microstep, and peak
     device memory; then one microstep's device time by kernel group
     (torch.profiler, the last inner epoch replayed on the trained state);
     then, in the same group, the paper's main path: ``cli.train.main`` on
     ``pickscore_cotrain_sd3_fast`` (COTRAIN_ARGV) at full SD3.5-M width with
     the full-width CLIP-H/14 PickScore discriminator (random fp32 weights),
     against reference PNGs the phase writes: 2 epochs whose branch the
     adaptive gate picks (printed with the epoch's reward and reference
     reward), then the branch it never took once on the last samples. The
     launch counts of the five kernels as derived from the config and the
     branches; the trainable CLIP tail moved and finite, every other CLIP
     tensor and the frozen 'pickscore' score of a fixed batch bitwise
     unchanged, the co-trained score moved; the LoRA and EMA moved; D-step
     ms per sampling batch, CLIP-H scoring ms per batch, s per epoch on each
     branch, peak device memory. Then, in the same group, checkpoints
     (``run_checkpoint_slice``): the same run with ``save_freq=1`` writes
     ``checkpoint-{global_step}`` (``state.pt``, ``extra.pt``, the peft
     ``lora/``) at the start of epoch 1; one more D-epoch on the last samples
     (so the discriminator has Adam moments) and ``save`` again;
     ``--resume latest`` restores that checkpoint bitwise (generator state,
     counters, the CLIP-H tail and its Adam state; the frozen 'pickscore'
     score of the probe that of a fresh build, the co-trained one that at
     the save) and runs one epoch (launches of #1-#5 as derived); ``cli.infer.main --lora <checkpoint>/lora`` at
     ``eval_sd3_fast`` full width gives bitwise the image of the saved EMA
     LoRA merged directly, not the image without it (launches of #1-#3 as
     derived); bytes on disk, save and restore seconds, s/image. Then, in
     the same group, the DINO discriminators (``run_dino_slice``): DINOv2-B/14 at 518^2 on the card
     against the CPU (relative L2 1e-4); ``cli.train.main`` on
     ``dino_cotrain_sd3_patch_fast`` (DINO_ARGV: full SD3.5-M, a random fp32
     DINOv2-B/14 discriminator, d_times 2): epoch 0 a D-epoch, epoch 1 a G
     epoch, the launch counts of the five kernels as derived, the head moved
     and finite, every backbone tensor and the 'image_similarity' score of a
     fixed batch bitwise unchanged, 'dino_cotrain' moved, the LoRA and EMA
     moved; one ``eval_phase`` scoring 'image_similarity' against the
     reference PNGs and 'pickscore' (#1-#3 launches as derived); one D-epoch
     of ``dino_cotrain_sd3_multi_fast`` at its layer 11 (the heads' and the
     fusion's weights moved, the backbone did not, 'dino_multi_cotrain' in
     (0, 1)); DINO scoring ms per batch, D-step ms per sampling batch
     (single and multi), s per epoch on each branch, peak device memory.
     Then, in the same group, the checkpoint loaders and tokenizers
     (``run_loader_slice``): a full-width SD3.5-M diffusers directory
     written from the seed (transformer bf16 with its 384^2 table, VAE
     fp32, CLIP-L and CLIP-G fp16, T5-XXL fp16 at full width cut to
     LOADER_T5_LAYERS of 24 layers, two shards and an index; its three
     tokenizers at the published id spaces); ``preflight``'s parameter
     counts against the configs' on the meta device;
     ``load_sd3_pipeline(dir, lora_rank=32)``: every frozen tensor, the VAE
     and the LoRA A draws bitwise; PickScore CLIP-H/14 and DINOv2-B/14
     (timm and HF layouts) checkpoints from the seed, loaded through
     ``build_reward_context`` bitwise; a 2-layer full-width T5-XXL and
     CLIP-G against the CPU in fp32; each tokenizer's host ms and the
     encode of ENCODE_BATCH prompts timed (the directory's encoders and
     tokenizers, and a 24-layer T5-XXL from the seed);
     ``cli.precompute_embeds``; ``cli.infer.main`` at ``eval_sd3_fast``
     and one epoch of ``cli.train.main`` each on TRAIN_ARGV, COTRAIN_ARGV
     (``PICKSCORE_DIR``) and DINO_ARGV (both scorer directories) from the
     directory and the store (launches of #1-#3 and #1-#5 as derived, the
     live tail and its frozen copy bitwise the file's); no RANDOM-INIT
     warning and no tokenizer package loaded; bytes written, write /
     preflight / load seconds, epoch seconds, peak device and host memory.
     Then, in the same group, the prefix / image / rewards phase
     (``run_prefix_image_slice``): the group-shared prefix against the plain
     ``same_latent`` rollout at pickscore_cotrain_sd3_fast's shapes and
     window starts PREFIX_RTS (PREFIX_REL_L2; launches of #1-#3; seconds of
     each), one G epoch with ``same_latent``, ``cli.infer --image`` from
     step IMAGE_START_IDX, the SD3 and Flux VAE encoders and the CLIP-L /
     aesthetic scorers against the CPU (ENCODE_REL_L2, SCORER_TOL), and one
     ``pickscore_sd3_fast`` epoch with ``ocr_stand_in`` as its OCR engine.
     Then, in the same group, the evaluation and preparation tools
     (``run_eval_tooling_slice``): ``cli.generate_refs`` (REF_PROMPTS test
     prompts x REF_VARIATIONS, and a resumed run that writes nothing),
     ``cli.validate_refs`` on that set and on a copy with a truncated file,
     ``cli.eval`` over EVAL_PROMPTS prompts at ``--batch`` EVAL_BATCH with
     PickScore and DINOv2 rewards against the set, ``cli.finetune_pickscore``
     on full-width CLIP-H (and ``--tune_layer 1``) with its ``.msgpack``
     read back bitwise, one co-train epoch warm-started from that file, one
     ``dpo_sd3_fast`` epoch and the demo app's ``generate`` (stub
     ``gradio``), each with its launch counts of #1-#5 as derived.
 11. the Flux kernels against their plain versions at the Flux.1-dev 512^2
     shapes: the per-head RMS norm (d = 128, and one head across a 5120-wide
     row), the BSHD attention (B = 1 and 4, and 4608 tokens with kv_len
     4600), the joint attention at head width 128 without RMS (B = 1 and 4,
     as in phase 3), the modulated LayerNorm at D = 3072; median times
     beside the plain versions' and one PyTorch library call's;
 12. the Flux attention backward kernels against their plain twins at the
     Flux.1-dev 512^2 shapes: the BSHD backward at B = 1, S = 1536, 24 heads
     of 128 (and 4608 tokens with kv_len 4600), the joint backward at head
     width 128, 1024 + 512 tokens (its pre-pass's operands bitwise against
     the twin's); relative L2 per cotangent, median times beside the plain
     twin's and the SDPA backward's;
 13. a 1-double + 1-single block Flux.1-dev at full width on the card (bf16,
     kernels) against the same weights on the CPU (fp32, plain versions):
     the output, then the LoRA gradients through a fixed cotangent, with
     remat off (three runs) and on (``_check_remat_grads``: within 5e-2 of
     fp32; with remat, every block's recompute bitwise its forward, and the
     gradients within REMAT_GRAD_SPREAD or twice the plain runs' spread of
     the nearest plain run; so for the MMDiT of phase 5 and the WAN of
     phase 17);
 14. ``adv_grpo_torch.cli.infer.generate`` on a full-width Flux.1-dev
     pipeline (random weights from the seed) at 512^2, 28 steps, guidance
     3.5: launch counts exactly 115/152/19/38 per forward times 28 steps,
     finite images, a non-constant 512x512 PNG; then 1 and 4 prompts on the
     warm pipeline: seconds per image, one forward's time and achieved
     TFLOP/s, its device kernel time by group (torch.profiler) and busy
     share, peak device memory; then the Flux SDE sweep
     (``cli.flux_sde_demo.sweep``) on the same pipeline at DEMO_LEVELS and
     the last level again with ``--kontext``'s conditioning latent,
     DEMO_STEPS steps: a 256x256 PNG a level, finite latents and log-probs,
     the ``--kontext`` final latents unequal to the plain ones at that level;
 15. ``GRPOTrainer`` on a full-width Flux.1-dev pipeline (LoRA r=32, random
     weights from the seed) for FLUX_EPOCHS (1) epoch of ``flux_smoke`` at 512^2
     (FLUX_TRAIN_OVERRIDES: 8-step full-SDE rollouts of 4 images, 2 window
     steps, one row per microstep, 16 microsteps per epoch, EMA every 2
     steps, the jpeg_compressibility reward): finite metrics, every LoRA
     factor and its EMA moved, the launch counts of all six Flux kernels
     exactly as derived from the config (the forwards of the rollouts and
     replays and, under remat, of the blocks' recompute; 304 / 608
     backwards an epoch); seconds per epoch (rollout + decode, exposed reward,
     train), per microstep, peak device memory, one microstep's device time
     by kernel group (torch.profiler); then Flux.1-dev at its published
     1024^2 (``run_flux_1024_slice``): #2 / #4 at d = 128 and #8 / #9 at
     4,096 + 512 tokens against their plain twins, timed beside SDPA and
     their bounds, and one epoch of the same run at 1024^2 with remat on
     (launch counts as derived, finite metrics, LoRA and EMA moved, each
     ``time/*`` phase, peak memory, one traced microstep), and its
     microstep's ms and peak memory with remat off and on
     (``_remat_on_off``);
 16. the WAN kernels against their plain versions at the Wan2.1-T2V-1.3B
     shapes of 33 frames of 480^2 (8,100 video tokens, 512 text tokens, 12
     heads of 128, width 1536): the no-affine LayerNorm (#6, B = 1 and 2,
     within 1 bf16 ulp), the modulated LayerNorm and the one-head RMS across
     the 1536-wide row (1 ulp), the BSHD attention forward and backward for
     the self (8,100 x 8,100) and the cross (8,100 x 512) attention (2e-2);
     median times beside the plain versions' and one PyTorch call's;
 17. a 2-layer full-width WAN on the card (bf16, kernels) against the same
     weights on the CPU (fp32, plain versions): the output, then the LoRA
     gradients through a fixed cotangent (relative L2 5e-2);
 18. the demo's path (``cli.wan_sde_demo.sample_video``) on a full-width
     Wan2.1-T2V-1.3B pipeline (LoRA r=32, random weights from the seed): 50
     steps at shift 3 from (16, 9, 60, 60) latents, the 3D VAE decode to 33
     frames of 480^2; launch counts exactly 61 / 120 / 30 / 60 per forward
     (modulated LN, RMS, LN, BSHD) x 50; seconds per video, one forward's
     time and achieved TFLOP/s, its device time by kernel group and busy
     share, peak memory; then a 3-step run with the per-step KL (non-zero
     LoRA B): the KL finite and positive, two forwards per step;
 19. ``GRPOTrainer`` on a full-width Wan2.1-T2V-1.3B pipeline for one epoch
     (WAN_EPOCHS) of ``wan_smoke`` (WAN_TRAIN_OVERRIDES: 33 frames of 480^2, 8-step
     rollouts of one 2-video group per sampling batch, 2 window steps, one
     row per microstep): finite metrics, every LoRA factor and its EMA
     moved, the launch counts of the four WAN kernels and the BSHD backward
     exactly as derived from the config; seconds per epoch, per microstep,
     peak memory and one microstep's device time by kernel group. Then
     Wan2.1-T2V-1.3B at its published 81 frames (``run_wan_81_slice``, full
     width and depth): #6, #1, #7, #8 and #9 at 32,760 video tokens against
     their plain versions (the attention's a block of PLAIN_ROWS query rows
     at a time), timed beside ``F.layer_norm`` / ``F.rms_norm`` / SDPA and
     their bounds; the demo path at 81 frames of 480x832 (latents (16) +
     WAN_81_GRID, WAN_81_STEPS steps): the video (1, 81, 3, 480, 832)
     finite, launch counts as derived, ms a step, TFLOP/s, the decode's
     seconds and peak memory; the decode at 81 frames of 480^2 and at 33
     frames (``chunk_frames`` must take one chunk there, the whole-sequence
     decode; two chunks beside it, relative L2 1e-5 from the whole); one
     ``wan_smoke`` epoch at 81 frames of 480^2 (WAN_81_TRAIN_OVERRIDES:
     launch counts as derived, LoRA and EMA moved, finite metrics, each
     ``time/*`` phase, peak memory); one GRPO microstep at the published
     grid with remat off and on (ms, peak memory, busy share, launch
     counts as derived).
 20. Flux.1-dev and Wan2.1-T2V-1.3B from files (``run_family_loader_slice``):
     diffusers directories written from the seed at the published widths
     (Flux's transformer bf16 in FAMILY_FLUX_SHARDS shards with their index,
     its depth cut on disk to FAMILY_FLUX_DEPTH; WAN's transformer fp32 at
     full depth; both VAEs fp32, WAN's encoder included); every loaded
     tensor bitwise as written (WAN's rounded to bf16 as the loader rounds
     it), LoRA A bitwise the numpy draws; ``cli.infer`` on ``flux_smoke``
     with ``FLUX_DIR`` (512^2, FLUX_STEPS steps) and one ``flux_smoke`` epoch
     at FLUX_TRAIN_OVERRIDES; the WAN VAE encoder on the card against the CPU
     in fp32 (WAN_ENCODE_REL_L2) and one encode of WAN_FRAMES frames of
     WAN_RES^2; the demo path from ``WAN_DIR`` (WAN_STEPS steps) and one
     ``wan_smoke`` epoch at WAN_TRAIN_OVERRIDES: the launch counts of #1, #2,
     #4, #6, #7, #8 and #9 as derived for the loaded configs, finite
     metrics, the LoRA and its EMA moved; bytes and write / load seconds per
     directory, s/image, s/video, epoch seconds, peak device memory and host
     RSS.
 21. (inside the one-rank NCCL group, after the eval / tooling phase) the
     last rewards (``run_remaining_rewards_slice``): SigLIP so400m,
     ImageReward and the 512^2 StyleGAN D drawn from the seed, written as
     ``SIGLIP_DIR`` / ``IMAGEREWARD_PT`` + ``BERT_TOKENIZER_DIR`` /
     ``STYLEGAN_D_PATH`` and read back bitwise; one
     ``pickscore_cotrain_sd3_fast`` epoch with REMAINING_REWARD_FN (the
     judges on a loopback ``JudgeFixture``) and an eval phase with
     REMAINING_EVAL_REWARD_FN, launches of #1-#5 as derived, the requests in
     the judges' formats; every new reward on the epoch's 16 decoded
     images (finite, shape (16,), ms per batch), the loaded scorers bitwise
     the drawn ones, ``constractive_external`` on both gate branches.
 22. the kernels' whole range (``run_kernel_range_slice``; every phase
     before it launches no generic attention kernel, ``check_no_generic``):
     the generic attention kernels (``csrc/attention_generic_{fwd,bwd}.cu``:
     fp32 at any head width up to 128 on the tensor cores in 3xTF32, bf16
     at the other widths; their fp32 instances' registers, spills and
     HGMMA / HMMA instructions from the build, ``check_generic_tf32_build``) at
     KR_EDGES for fp32 and bf16 at d = 16 / 32 / 48 / 64 / 128 in every mode
     (joint and single-stream, each with and without the fused qk-RMS; BSHD
     with kv_len; BHSD) forward and backward against their plain twins,
     then at the full-width fp32 shapes (SD3.5-M's joint and single-stream
     attention with the qk-RMS, Flux.1-dev's joint at d = 128 without it,
     as Flux calls it, WAN's self-attention, KR_CP_SHAPE) and
     the bf16 joint backward with the qk-RMS at d = 128, the fp32 norms;
     each timed beside its plain version, SDPA / ``F.layer_norm`` /
     ``F.rms_norm`` in fp32 and its bound (the attention rows' at the 3xTF32
     rate, the FFMA one beside it), the attention rows' two calls each way
     bitwise equal; the five CI-sized presets on
     the card (KR_SD3_TRAIN, KR_FLUX_INFER, KR_FLUX_TRAIN, KR_WAN_DEMO,
     KR_WAN_TRAIN: fp32 tiny models) and ``cli.infer`` at full SD3.5-M width
     in fp32, every launch count as derived from the configs; a 2-layer
     full-width fp32 MMDiT and its LoRA gradients against the CPU
     (KR_MODEL_F32); ``mha`` at d = 32 through
     ``context_parallel_attention`` in a one-rank group. TF32 off.

``python3 chip_smoke.py --dino`` builds the kernels and runs the DINO phase
alone (``run_dino_slice``, in its one-rank NCCL group), without the result
lines; ``--checkpoint`` the checkpoint phase (``run_checkpoint_slice``),
``--loaders`` the loader phase (``run_loader_slice``) and
``--family-loaders`` the Flux / WAN loader phase
(``run_family_loader_slice``), ``--prefix-image`` the prefix / image /
rewards phase (``run_prefix_image_slice``), ``--eval-tooling`` the
evaluation and preparation tools (``run_eval_tooling_slice``) and
``--remaining-rewards`` the last rewards (``run_remaining_rewards_slice``)
the same way; ``--mma-rate`` builds and runs ``csrc/probes/mma_rate.cu``,
the card's mma.sync rate in TF32 and bf16. ``--wan-81`` runs the 81-frame
phase alone and prints its kernels-line entries on a line of their own;
``--wan-decode F H W`` only decodes, with the full-width WAN VAE from the
seed, latents of F frames of H x W in one chunk (the whole-sequence decode)
and prints its seconds and peak memory, or fails with the error it raises.
Each phase of the whole script prints the script's clock after it
(``[clock]``). ``--flux-1024 [--set key=value ...]`` runs the Flux.1-dev
1024^2 phase alone (no process group), its config overridden as the CLIs'
``--set`` does (remat on unless ``--set tpu.remat=False``).
``--kernel-range`` runs the kernel-range phase alone and prints its
kernels-line entries on a line of their own.
``python3 chip_smoke.py --remat-ab`` runs the whole script and also times
the SD3, Flux 512^2 and WAN training microsteps with remat off and on
(``_remat_on_off``), as the 1024^2 phase always does.
``python3 chip_smoke.py --sd3-attention-ab PARENT PAIRS`` instead times the
joint forwards #2 / #3 (JOINT_CASES: SD3.5-M at CFG batch 2 and 8, Flux.1-dev
at B = 1 and 4) of the checkout at PARENT (an older tree) against this one's,
in PAIRS alternating pairs of processes, with each side's error on the same
inputs; ``--sd3-forward-ab PARENT PAIRS`` one SD3.5-M MMDiT forward at CFG
batch 2 and 8 and its joint forwards' share;
``python3 chip_smoke.py --attention-bwd-ab PARENT PAIRS`` likewise times the
attention backwards #9 (Flux's (1,1536,3072), WAN self and cross), #11
(MHA_SHAPES) and #4 / #5 (BWD_AB_JOINT, with the wrapper's host ms per call
and each tree's error against fp32 on the same inputs), and ``--attention-fwd-ab PARENT PAIRS`` the attention forwards
#8 (Flux's single blocks at B = 1 and 4, WAN self and cross) and #10
(MHA_SHAPES), by CUDA events and by device kernel time; ``--norms-ab PARENT
PAIRS`` the LayerNorms #1 and #6 (and #7 beside them) at NORM_AB_CASES, the
main path's shapes: CUDA-event, device kernel and host ms of each call and of
``F.layer_norm`` where it computes the same function (``F.rms_norm`` beside
#7), and each side's error
in bf16 spacings against fp32 on the same inputs; ``--generic-ab PARENT
PAIRS`` the generic kernels at the full-width fp32 rows (KR_FULL), forward
and backward, by CUDA events and by device kernel time, with each side's
relative L2 error against the plain twins on the same inputs.

Prints one JSON line of per-kernel results (each with its least possible time
on the card, from the published H100 SXM peaks), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when no
CUDA device is visible or when run outside a checkout of the repository.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
SEED = 0
STEPS = 40
FLUX_STEPS = 28  # FluxSamplerConfig's default, the reference's
# the demo sweeps (cli.sde_noise_sweep in the SD3 inference phase,
# cli.flux_sde_demo plain and --kontext in the Flux one): two noise levels,
# a few steps, on the phase's warm full-width pipeline
DEMO_LEVELS, DEMO_STEPS = (0.0, 0.7), 4
# published peaks of one H100 SXM (the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the rate of their type)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
# fp32-accurate products on the tensor cores in a 3xTF32 split (three TF32
# products each, 495 TFLOP/s TF32): the generic kernels' fp32 instances
TF32_3X_FLOPS = 495e12 / 3
# the inference slice: eval_sd3_fast at full SD3.5-M width, random weights
INFER_ARGV = ["--config", "eval_sd3_fast", "--prompts", "a flower", "--set", "pretrained.model=''"]
# the training slice: smoke_sd3_fast at full SD3.5-M width, 10-step rollouts,
# 2 prompt slots x 2 images per sampling batch, 2 epochs. train.ema_interval=2
# lets the EMA move within the run's 4 optimizer steps (the preset's 8 would
# first move it at step 8).
EPOCHS = 2
TRAIN_ARGV = ["--config", "smoke_sd3_fast", "--set", "smoke_test=False",
              "--set", "sample.num_steps=10", "--set", "sample.train_batch_size=2",
              "--max_epochs", str(EPOCHS), "--set", "train.ema_interval=2",
              "--device", "cuda"]
# the Flux training slice: flux_smoke at full Flux.1-dev width and 512^2,
# 8-step full-SDE rollouts of one 4-image group per sampling batch, 2 batches
# and 2 window steps per epoch, one row per microstep (micro_splits 4), EMA
# every 2 optimizer steps (2 an epoch); FLUX_EPOCHS epochs
FLUX_EPOCHS = 1  # at 512^2; two before, cut for the script's time
FLUX_TRAIN_OVERRIDES = ["resolution=512", "sample.num_steps=8", "sample.train_num_steps=2",
                        "sample.train_batch_size=1", "sample.num_image_per_prompt=4",
                        "sample.mini_num_image_per_prompt=4", "sample.num_batches_per_epoch=2",
                        "train.batch_size=4", "train.micro_splits=4", "train.ema=True",
                        "train.ema_interval=2"]
# the WAN slice: Wan2.1-T2V-1.3B at 33 frames of 480^2 (latent (16, 9, 60,
# 60): 8,100 video tokens) and 512 text tokens; sampling at the published 50
# UniPC steps, shift 3. Training: wan_smoke at that size, rollouts cut to 8
# steps for the run's time, one 2-video group per sampling batch, 2 batches
# and 2 window steps per epoch, one row per microstep (micro_splits 2: 8
# microsteps, 2 optimizer steps per epoch), EMA every 2 optimizer steps,
# WAN_EPOCHS epochs
WAN_STEPS = 50
# #8's max abs error (output and lse) at WAN's self and cross shapes as
# recorded (PERF.md §6, at its precision) when the BSHD forward still
# pre-scaled q and rounded it to bf16: scaling the fp32 scores must not make
# it larger
PRESCALED_Q_MHA_BSHD_ERR = {"self": 1.55e-3, "cross": 3.05e-3}
# #8 at WAN's shapes: (max abs, relative L2) bounds on the output against the
# fp32 plain version, held apart from the lse (5e-3). At 32,760 tokens a
# typical |o| is ~9e-3, so an absolute bound on output and lse together
# (2e-2) would pass a P.V accumulation off by 30%; these are set from the
# readings at 8,100 and 32,760 tokens recorded in PERF.md §6
WAN_BSHD_OUT_BOUND = {"self": (2e-3, 1e-2), "cross": (1e-2, 1e-2)}
# kernels #10 / #11 (``mha`` on (B, H, S, D)): WAN's self-attention (12 heads
# of 128, 8,100 tokens), SD3.5-M's joint sequence (1,024 + 154 tokens, 24
# heads of 64, B = 2) with keys past 1,100 masked, and what one rank of a
# 4-way context-parallel WAN run sees (2,025 queries against 8,100 keys):
# (name, B, H, S_q, S_kv, D, kv_len)
MHA_SHAPES = (("wan", 1, 12, 8100, 8100, 128, None),
              ("sd3", 2, 24, 1178, 1178, 64, 1100),
              ("cp4", 1, 12, 2025, 8100, 128, None))
# #10's output and the context-parallel and ring outputs: relative L2 of o
# (with the softmax spread over 8,100 keys a typical |o| is ~0.02, the size
# of an absolute 2e-2 bound, so only a relative one sees a lost kv tile), and
# the lse absolute, apart
MHA_O_REL_L2, MHA_LSE_ABS = 1e-2, 5e-3
# #11 at the WAN shape against fp64: within this factor of the error of its
# fp32 plain twin rounded to bf16 (what fp32 p and ds buy over bf16 ones)
FIDELITY_FACTOR = 1.15
WAN_FRAMES, WAN_RES, WAN_TEXT = 33, 480, 512
# the attention's plain versions at WAN's shapes run a block of PLAIN_ROWS
# query rows at a time (blocked_bshd_reference): at 32,760 tokens the whole
# fp32 scores of #8 alone would be 12 x 32,760^2 x 4 B = 51.5 GB
PLAIN_ROWS = 2048
# the 81-frame phase (run_wan_81_slice): Wan2.1-T2V-1.3B at its published 81
# frames. The rollout, the VAE decode and one GRPO microstep run at the
# published 480x832 grid (latents (16,) + WAN_81_GRID: 32,760 video tokens),
# the rollout cut to WAN_81_STEPS of the published 50 for the run's time;
# one GRPO epoch runs at 81 frames of 480^2 (21 x 60 x 60 latents, 18,900
# video tokens), the square grid both packages' trainers take, with
# WAN_TRAIN_OVERRIDES' cuts
WAN_81_FRAMES, WAN_81_GRID, WAN_81_STEPS = 81, (21, 60, 104), 10
# the wgmma + TMA kernels: the forward of #8 and #10 (scores scaled) and of
# #2 and #3 (q pre-scaled, with and without the fused qk-RMS; with it, the k
# RMS pre-pass rms_k_kernel first), and the backward of #9, #11 and, after
# its operand pre-pass attn_bwd_prepass_kernel, of #4 and #5; per source,
# {kernel name as ptxas and cuobjdump print it: instances} (the wgmma kernel
# first, at head widths 64 and 128, every mode)
FWD_SM90_SOURCE = "adv_grpo_torch/csrc/attention_fwd_sm90.cu"
BWD_SM90_SOURCE = "adv_grpo_torch/csrc/attention_bwd_sm90.cu"
SM90_KERNELS = {FWD_SM90_SOURCE: {"attn_fwd_sm90_kernel": 6, "rms_k_kernel": 2},
                BWD_SM90_SOURCE: {"attn_bwd_sm90_kernel": 6, "attn_bwd_prepass_kernel": 2,
                                  "attn_bwd_convert_kernel": 1}}
# the joint forward (#2) and its single-stream form (#3, S_txt = 0): (name,
# B, S_img, S_txt, heads, head width, qk-RMS). SD3.5-M's 512^2 shapes at CFG
# batch 2 and 8 (the GRPO replay), Flux.1-dev's at B = 1 and 4; then ragged
# tile edges on both streams (1, 127, 128, 129, 154 tokens). Each case draws
# its inputs from its own seed, so ``--sd3-attention-ab`` reads the parent's
# error on the same inputs.
JOINT_CASES = (("sd3_b2", 2, 1024, 154, 24, 64, True), ("sd3_b8", 8, 1024, 154, 24, 64, True),
               ("rms_b2", 2, 1024, 0, 24, 64, True), ("rms_b8", 8, 1024, 0, 24, 64, True),
               ("flux_b1", 1, 1024, 512, 24, 128, False),
               ("flux_b4", 4, 1024, 512, 24, 128, False))
JOINT_EDGES = (("edge_1_154", 2, 1, 154, 24, 64, True),
               ("edge_127_129", 1, 127, 129, 24, 64, True),
               ("edge_128_1", 2, 128, 1, 24, 128, False),
               ("edge_129_127", 1, 129, 127, 24, 128, False),
               ("edge_154_128", 1, 154, 128, 24, 64, True),
               ("edge_rms_129", 2, 129, 0, 24, 64, True))
# #2 / #3's bounds: output 2e-2 absolute and lse 5e-3 against fp32, within
# 1 bf16 spacing of the kernel-order twin (lse 1e-4), and no worse than
# JOINT_PARENT_FACTOR times the mma.sync kernel's error on the same inputs,
# (output, lse) max abs per case as its ``--sd3-attention-ab`` run read them.
# The spacing against the twin is taken at the largest |twin| of each (row,
# head) (``_row_ulps``): the twin rounds q^, k^ and p where the kernel does
# and computes q^ and k^ bit for bit as it does, but its fp32 products sum in
# another order, and a last-bit difference that flips the rounding of a p
# moves the whole row by up to about one spacing at its largest output (on
# an H100 the largest difference read one spacing at |o| of 0.13-0.25, and
# 4-8 spacings of outputs below 2^-4 taken at their own size)
JOINT_PARENT_FACTOR = 1.5
JOINT_PARENT_ERR = {  # the mma.sync kernel of PR 8's tree (NVIDIA H100 80GB HBM3, 700 W)
    "sd3_b2": (1.446e-3, 1.805e-3), "sd3_b8": (1.733e-3, 2.069e-3),
    "rms_b2": (1.986e-3, 1.891e-3), "rms_b8": (1.826e-3, 2.031e-3),
    "flux_b1": (1.256e-3, 1.517e-3), "flux_b4": (1.606e-3, 1.518e-3),
    "edge_1_154": (3.272e-3, 2.162e-3), "edge_127_129": (2.523e-3, 1.594e-3),
    "edge_128_1": (5.178e-3, 2.762e-3), "edge_129_127": (3.137e-3, 1.672e-3),
    "edge_154_128": (2.345e-3, 1.777e-3), "edge_rms_129": (4.341e-3, 2.127e-3)}
# the co-training slice (the paper's main path): pickscore_cotrain_sd3_fast at
# full SD3.5-M width with the full-width CLIP-H discriminator, the smoke
# run's cuts (10-step rollouts, 2 prompt slots a batch, 2 epochs) and 2
# sampling batches an epoch (the preset's 12 cut for the run's time; each
# batch keeps the preset's 16 images); accumulation over one batch's window
# so each G epoch takes optimizer steps, the EMA every 2 of them
COTRAIN_EPOCHS = 2
COTRAIN_ARGV = ["--config", "pickscore_cotrain_sd3_fast", "--set", "smoke_test=False",
                "--set", "pretrained.model=", "--set", "dataset=dataset/pickscore_small",
                "--set", "sample.num_steps=10", "--set", "sample.train_batch_size=2",
                "--set", "sample.num_batches_per_epoch=2",
                "--set", "train.gradient_accumulation_steps=1", "--set", "train.ema_interval=2",
                "--set", "wandb_init=False", "--max_epochs", str(COTRAIN_EPOCHS),
                "--device", "cuda"]
# the DINO slice (the paper's headline config): dino_cotrain_sd3_patch_fast
# at full SD3.5-M width with a full-width random DINOv2-B/14 discriminator,
# cut as COTRAIN_ARGV is (10-step rollouts, 2 prompt slots x 8 images = the
# preset's 16 a batch, 2 batches an epoch of the preset's 12); d_times 2 (the
# preset's 10) makes epoch 0 a D-epoch and epoch 1 a G epoch
DINO_EPOCHS = 2
DINO_CUTS = ["--set", "smoke_test=False", "--set", "pretrained.model=",
             "--set", "dataset=dataset/pickscore_small", "--set", "sample.num_steps=10",
             "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
             "--set", "train.gradient_accumulation_steps=1", "--set", "train.ema_interval=2",
             "--set", "wandb_init=False", "--device", "cuda"]
DINO_ARGV = (["--config", "dino_cotrain_sd3_patch_fast", "--set", "d_times=2",
              "--max_epochs", str(DINO_EPOCHS)] + DINO_CUTS)
# the multi-layer preset (its layer 11, 16 images a batch), one D-epoch
DINO_MULTI_ARGV = ["--config", "dino_cotrain_sd3_multi_fast", "--max_epochs", "1"] + DINO_CUTS
WAN_EPOCHS = 1  # of WAN_TRAIN_OVERRIDES's run, for the script's time
WAN_TRAIN_OVERRIDES = [f"resolution={WAN_RES}", f"sample.num_frames={WAN_FRAMES}",
                       "sample.num_steps=8", "sample.train_num_steps=2",
                       "train.micro_splits=2", "train.ema=True", "train.ema_interval=2"]
WAN_81_TRAIN_OVERRIDES = WAN_TRAIN_OVERRIDES + [f"sample.num_frames={WAN_81_FRAMES}"]


# the loader slice: a full-width SD3.5-M diffusers directory written from the
# seed (transformer bf16 with its 384^2 base-scaled table, VAE fp32, CLIP-L
# and CLIP-G fp16 whole, T5-XXL fp16 at full width with its depth cut to
# LOADER_T5_LAYERS of 24 on disk, two shards and an index), loaded, encoded
# through (ENCODE_BATCH prompts), then sampled (INFER_ARGV's eval_sd3_fast)
# and trained one epoch (TRAIN_ARGV's smoke_sd3_fast cuts) from it
LOADER_T5_LAYERS = 4
ENCODE_BATCH = 32
# the family loader slice: Flux.1-dev and Wan2.1-T2V-1.3B diffusers
# directories written from the seed + 11 at the published widths. Flux's
# transformer bf16 in FAMILY_FLUX_SHARDS shards with its index, its depth cut
# on disk to FAMILY_FLUX_DEPTH = (double, single) blocks of (19, 38) (the
# full depth runs from random weights in the Flux phases); the Flux VAE fp32.
# WAN's transformer at full depth (30 layers) in fp32, so the loader's bf16
# rounding runs; its AutoencoderKLWan fp32, encoder included, with Wan2.1's
# latent statistics. From them: cli.infer (flux_smoke, 512^2, FLUX_STEPS
# steps), one flux_smoke epoch at FLUX_TRAIN_OVERRIDES, the WAN demo path
# (WAN_STEPS steps, WAN_FRAMES frames of WAN_RES^2), one wan_smoke epoch at
# WAN_TRAIN_OVERRIDES, and the WAN VAE encoder on the card against the CPU
FAMILY_FLUX_DEPTH = (3, 6)
FAMILY_FLUX_SHARDS = 3
WAN_LATENTS_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
                    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENTS_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
                   3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)
# the full-width WAN VAE encoder in fp32 on the card (TF32 off) against the
# CPU on a 5-frame 64^2 clip: relative L2 of the mean and of the logvar (two
# fp32 conv stacks summing in other orders)
WAN_ENCODE_REL_L2 = 1e-4
# relative L2 bound of the 2-layer full-width T5-XXL in bf16 against fp32, at
# scores of order one (_t5_weights_at_scale_); the same T5 with its bias table
# lost, or its mask, must read above it (_check_encoders_on_card)
T5_BF16_BOUND = 5e-2
# the HF names of the port's CLIP text tower and T5 encoder, to write their
# files as CLIPTextModelWithProjection / T5EncoderModel checkpoints
HF_CLIP_LAYER = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
HF_T5_LAYER = {"ln_attn": "0.layer_norm", "q": "0.SelfAttention.q", "k": "0.SelfAttention.k",
               "v": "0.SelfAttention.v", "o": "0.SelfAttention.o", "ln_ff": "1.layer_norm",
               "wi_0": "1.DenseReluDense.wi_0", "wi_1": "1.DenseReluDense.wi_1",
               "wo": "1.DenseReluDense.wo"}


def per_forward_counts(mcfg):
    """Kernel launches of one MMDiT forward: (modulated LN, joint attention,
    single-stream attention). Per block: the image, context and MLP norms,
    one more for a dual-attention block, one more for the context MLP of every
    block but the last (context_pre_only); then the output norm."""
    n, dual = mcfg.num_layers, len(mcfg.dual_attention_layers)
    return 3 * n + dual + (n - 1) + 1, n, dual


def per_recompute_counts(mcfg):
    """Launches of the blocks' recompute in one MMDiT backward
    (``models/remat.py``): under remat, at either policy, every block's
    forward kernels again (a forward's, but the output norm); none without
    remat."""
    if not mcfg.remat:
        return 0, 0, 0
    ln, joint, single = per_forward_counts(mcfg)
    return ln - 1, joint, single


def per_backward_counts(mcfg):
    """Backward-kernel launches of one MMDiT backward with respect to the
    LoRA: every joint attention, and the dual attention of every dual block
    but block 0, whose input is the patch embedding that no LoRA factor
    reaches (so autograd never differentiates it)."""
    return mcfg.num_layers, len([i for i in mcfg.dual_attention_layers if i > 0])


def _median_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _host_ms(fn, calls=100):
    """The host's ms per call of ``fn``: ``calls`` calls enqueued back to back
    (fewer than the launch queue holds, so the host never waits for the
    device), then one synchronize outside the clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def _three_ms(fn, bound_ms, reps=20, tries=3, one_kernel=True):
    """(median ms of 50 CUDA-event-timed calls after 5 warm-ups, the host's
    time between the events included; device kernel ms per call, the mean of
    ``reps`` traced calls; the host's ms per call, 100 enqueued back to back)
    for ``fn``, which launches one kernel (``one_kernel``; else each of its
    kernels once a call). A trace is kept only if it recorded ``reps`` of
    each kernel and their time is not under ``bound_ms``, the least the card
    could take; one that is not is printed with its kernels and taken again,
    up to ``tries`` times, after which the device kernel ms is None (not
    measured)."""
    kernel_ms = None
    for _ in range(tries):
        events = []
        total, _ = _profile_forward(fn, reps=reps, events=events, cpu=True)
        counted = (sum(n for _, n, _ in events) == reps if one_kernel
                   else bool(events) and all(n == reps for _, n, _ in events))
        if counted and total >= bound_ms:
            kernel_ms = total
            break
        print(f"  trace discarded: {reps} calls recorded {events} (kernel, launches, ms), "
              f"{total:.4f} ms a call against a bound of {bound_ms:.4f} ms", flush=True)
    return _median_ms(fn, iters=50, warmup=5), kernel_ms, _host_ms(fn)


def _ms(v):
    """A time for a print: 4 decimals, or "not measured" for None."""
    return "not measured" if v is None else f"{v:.4f}"


def _bound(nbytes, flops, flop_rate):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops`` at ``flop_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _attn_bound(tensors, batch, heads, s_q, s_kv, d, products=2):
    """Bound of an attention over ``tensors`` (inputs and outputs): ``products``
    matmuls of 2*s_q*s_kv*d FLOP per (batch, head) on the bf16 tensor cores
    (2 forward, 5 backward)."""
    return _bound(_nbytes(*tensors), 2.0 * products * batch * heads * s_q * s_kv * d,
                  BF16_TENSOR_FLOPS)


def _entry(name, source, replaces, max_abs_err, ms, plain_ms, bound, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def _bf16_ulp(ref):
    """Spacing of bf16 numbers at |ref| (8 significant bits), taken at no less
    than |ref| = 2^-8: below that the fp32 rounding of the cancelling terms
    (~1e-6 absolute) exceeds the bf16 spacing itself."""
    import torch

    exp = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -8)))
    return torch.exp2(exp - 7)


def _row_ulps(got, ref, heads):
    """Max |got - ref| of (B, S, H*D) outputs in bf16 spacings, each taken at
    the largest |ref| of its (row, head): where two fp32 sum orders flip the
    bf16 rounding of one p, the row's outputs move by up to about one
    spacing at its largest output, whatever their own size."""
    b, s, hd = ref.shape
    peak = ref.float().abs().view(b, s, heads, hd // heads).amax(-1, keepdim=True)
    diff = (got.float() - ref.float()).view(b, s, heads, hd // heads).abs()
    return (diff / _bf16_ulp(peak)).max().item()


def joint_inputs(case):
    """q, k, v of both streams (bf16 (B, S, H*D) on the card) and the RMS
    weights (1 + 0.1 randn, or None) of a JOINT_CASES / JOINT_EDGES case,
    drawn from the case's own seed."""
    import torch

    _, b, s_i, s_t, h, d, rms = case
    seed = SEED + 40 + (JOINT_CASES + JOINT_EDGES).index(case)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(n):
        return torch.randn((b, n, h * d), generator=g, device="cuda").to(torch.bfloat16)

    streams = [randn(n) for n in (s_i, s_i, s_i, s_t, s_t, s_t)]
    w = ([(1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")).float() for _ in range(4)]
         if rms else None)
    return streams, w


def joint_errors(ja, case):
    """The forward of ``ja`` (an ``ops.joint_attention`` module) on a case's
    inputs, with the lse: #2, or #3 where S_txt = 0. Returns (max abs error
    of the outputs, of the lse) against the fp32 plain version, the outputs
    and lse per stream, and the inputs."""
    _, b, s_i, s_t, h, d, rms = case
    streams, w = joint_inputs(case)
    f32 = [t.float() for t in streams]
    if s_t:
        oi, ot, li, lt = ja.joint_attention_fwd(*streams, w, h, 1e-6, d ** -0.5, True)
        outs, lses = [oi, ot], [li, lt]
        ri, rt, rli, rlt = ja.joint_mha_reference(*f32, num_heads=h, rms_weights=w,
                                                  return_lse=True)
        refs, ref_lses = [ri, rt], [rli, rlt]
    else:
        w = w and w[:2]
        o, lse = ja.mha_rms_fwd(*streams[:3], w, h, 1e-6, d ** -0.5, True)
        outs, lses = [o], [lse]
        r, rl = ja.mha_rms_reference(*f32[:3], num_heads=h, rms_weights=w, return_lse=True)
        refs, ref_lses = [r], [rl]
    err = max((o.float() - r).abs().max().item() for o, r in zip(outs, refs))
    lse_err = max((a - r).abs().max().item() for a, r in zip(lses, ref_lses))
    return err, lse_err, outs, lses, streams, w


def check_joint_cases(cases):
    """#2 / #3 on the wgmma + TMA kernel at ``cases``: output and lse against
    fp32 (2e-2, 5e-3), against the kernel-order twin (1 bf16 spacing at each
    row's largest output, lse 1e-4) and against JOINT_PARENT_FACTOR x
    the parent's error on the same inputs; returns {case name: (output
    error, lse error)}."""
    from adv_grpo_torch.ops import joint_attention as ja

    errs = {}
    for case in cases:
        name, b, s_i, s_t, h, d, rms = case
        err, lse_err, outs, lses, streams, w = joint_errors(ja, case)
        n = len(outs)
        pairs = None if w is None else [tuple(w[2 * i:2 * i + 2]) for i in range(n)]
        t_outs, t_lses = ja.joint_fwd_tiled_reference(streams[0::3][:n], streams[1::3][:n],
                                                      streams[2::3][:n], num_heads=h,
                                                      rms_weights=pairs)
        ulps = max(_row_ulps(o, t, h) for o, t in zip(outs, t_outs))
        t_lse = max((a - t).abs().max().item() for a, t in zip(lses, t_lses))
        finite = all(bool(o.isfinite().all()) for o in outs + lses)
        parent = JOINT_PARENT_ERR.get(name)
        vs_parent = ("" if parent is None else f"; the parent's {parent[0]:.3e} / "
                     f"{parent[1]:.3e} (bound {JOINT_PARENT_FACTOR}x)")
        print(f"  #{2 if s_t else 3} {name} (B={b}, {s_i} + {s_t}, {h}x{d}, RMS {rms}): max abs "
              f"err {err:.3e} (2e-2), lse {lse_err:.3e} (5e-3); against the twin "
              f"{ulps:.2f} bf16 ulp (1), lse {t_lse:.3e} (1e-4){vs_parent}", flush=True)
        ok = finite and err <= 2e-2 and lse_err <= 5e-3 and ulps <= 1.0 and t_lse <= 1e-4
        if parent is not None:
            ok = ok and err <= JOINT_PARENT_FACTOR * parent[0] and (
                lse_err <= JOINT_PARENT_FACTOR * parent[1])
        if not ok:
            raise AssertionError(f"joint forward {name}: err {err}, lse {lse_err}, twin {ulps} "
                                 f"ulp / lse {t_lse}, finite {finite}, parent {parent}")
        errs[name] = (err, lse_err)
    return errs


def check_kernels():
    """Phase 3: each kernel vs its plain version at the slice's shapes."""
    import torch

    from adv_grpo_torch.ops import fused_norms, joint_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    results = []
    b, s_img, s_txt, heads, dim = 2, 1024, 154, 24, 1536

    # 1: modulated LayerNorm; bound: 1 bf16 ulp of the fp32 result
    worst_ulps, max_err = 0.0, 0.0
    for s in (s_img, s_txt):
        x = randn(b, s, dim) + randn(b, 1, dim)
        sc, sh = randn(b, dim, scale=0.5), randn(b, dim, scale=0.5)
        y = fused_norms.modulated_layer_norm(x, sc, sh)
        ref = fused_norms.lnmod_reference(x.float(), sc.float(), sh.float(), 1e-6,
                                          torch.float32)
        err = (y.float() - ref).abs()
        worst_ulps = max(worst_ulps, (err / _bf16_ulp(ref)).max().item())
        max_err = max(max_err, err.max().item())
    x, sc, sh = randn(b, s_img, dim), randn(b, dim), randn(b, dim)
    least = _bound(_nbytes(x, sc, sh, x), 8.0 * x.numel(), FP32_FLOPS)
    ms, kernel_ms, host_ms = _three_ms(lambda: fused_norms.modulated_layer_norm(x, sc, sh),
                                       least[0])
    plain_ms = _median_ms(
        lambda: fused_norms.lnmod_reference(x, sc, sh, 1e-6, torch.bfloat16))
    print(f"kernel modulated_layer_norm: max_abs_err {max_err:.3e}, max err "
          f"{worst_ulps:.2f} bf16 ulp (bound 1 ulp of the fp32 result, ulp floored at 2^-15); "
          f"(2,1024,1536) median {ms:.4f} ms (device kernel {_ms(kernel_ms)}, host "
          f"{host_ms:.4f} ms a call) vs plain {plain_ms:.4f} ms", flush=True)
    if worst_ulps > 1.0:
        raise AssertionError(f"modulated_layer_norm off by {worst_ulps} ulp")
    # no single PyTorch call computes it: F.layer_norm has no per-item
    # (1 + scale, shift) modulation
    results.append(_entry("modulated_layer_norm", "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:252", max_err, ms, plain_ms,
                          least, None))

    # 2/3: the joint forward and its single-stream form on the wgmma + TMA
    # kernel: SD3.5-M's shapes at CFG batch 2 and 8, and ragged tile edges
    errs = check_joint_cases([c for c in JOINT_CASES if c[5] == 64] + list(JOINT_EDGES))
    for name, case, replaces in (
            ("joint_mha", JOINT_CASES[0], "adv_grpo_tpu/ops/joint_attention.py:73"),
            ("mha_rms", JOINT_CASES[2], "adv_grpo_tpu/ops/joint_attention.py:644")):
        _, b, s_i, s_t, h, d, _ = case
        streams, w = joint_inputs(case)
        if s_t:
            ms = _median_ms(lambda: joint_attention.joint_mha(*streams, num_heads=h,
                                                              rms_weights=w))
            plain_ms = _median_ms(lambda: joint_attention.joint_mha_reference(
                *streams, num_heads=h, rms_weights=w))
            tensors = streams + streams[0::3]
        else:
            ms = _median_ms(lambda: joint_attention.mha_rms(*streams[:3], num_heads=h,
                                                            rms_weights=w[:2]))
            plain_ms = _median_ms(lambda: joint_attention.mha_rms_reference(
                *streams[:3], num_heads=h, rms_weights=w[:2]))
            tensors = streams[:3] + streams[:1]
        err = max(e for n, (e, _) in errs.items()
                  if (n.startswith("edge_rms") or n.startswith("rms")) == (s_t == 0))
        print(f"kernel {name}: max_abs_err {err:.3e} (bound 2e-2) over the cases above; B={b}, "
              f"{s_i} + {s_t} tokens, {h}x{d} median {ms:.4f} ms vs plain {plain_ms:.4f} ms",
              flush=True)
        # no library call fuses the qk-RMS into the attention
        results.append(_entry(name, FWD_SM90_SOURCE, replaces, err, ms, plain_ms,
                              _attn_bound(tensors, b, h, s_i + s_t, s_i + s_t, d), None))
    return results


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _check_rel_l2(what, got, ref, bound=2e-2):
    """Relative L2 of each of ``got`` against ``ref``; raises above ``bound``
    (or on NaN); returns the largest absolute error."""
    errs = [_rel_l2(a, r) for a, r in zip(got, ref)]
    max_abs = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
    print(f"  {what}: relative L2 {', '.join(f'{e:.2e}' for e in errs)}; max abs "
          f"{max_abs:.3e} (bound {bound} relative L2)", flush=True)
    if not all(e <= bound for e in errs):
        raise AssertionError(f"{what}: relative L2 {errs} above {bound}")
    return max_abs


def _check_attn_out(what, o, ref, lse=None, ref_lse=None):
    """An attention output against ``ref`` by relative L2 (MHA_O_REL_L2) and,
    where given, its lse against ``ref_lse`` in absolute terms (MHA_LSE_ABS);
    raises above either (or on NaN); returns the largest absolute error of
    the two."""
    rel = _rel_l2(o, ref)
    o_abs = (o.float() - ref.float()).abs().max().item()
    lse_abs = 0.0 if lse is None else (lse - ref_lse).abs().max().item()
    print(f"  {what}: output relative L2 {rel:.3e} (bound {MHA_O_REL_L2}), max abs "
          f"{o_abs:.3e}" + ("" if lse is None else f"; lse max abs {lse_abs:.3e} (bound "
                                                 f"{MHA_LSE_ABS})"), flush=True)
    if not (rel <= MHA_O_REL_L2 and lse_abs <= MHA_LSE_ABS):
        raise AssertionError(f"{what}: output relative L2 {rel}, lse max abs {lse_abs}")
    return max(o_abs, lse_abs)


def _grad_ms(outs, inputs, cots):
    """Median ms of one backward through a retained graph."""
    import torch

    return _median_ms(lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True),
                      iters=10)


def _check_prepass(ja, qs, ks, heads, pairs):
    """The operands the joint backward's pre-pass wrote in its last call (q^,
    q_s and, with RMS weights, k^ per stream) against the twin's
    (``joint_operands``, from which the forward's twin takes q^ and k^), bit
    for bit; raises on any difference."""
    import torch

    from adv_grpo_torch.ops.attention import to_bhsd

    got = ja.bwd_operands(qs[0], [q.shape[1] for q in qs], pairs is not None)
    want = ja.joint_operands(qs, ks, num_heads=heads, rms_weights=pairs)
    same = [torch.equal(to_bhsd(g, heads).float(), w) for gs, ws in zip(got, want)
            for g, w in zip(gs, ws) if g is not None]
    print(f"  pre-pass q^, q_s{', k^' if pairs else ''} per stream bitwise equal to the "
          f"twin's (the forward's q^, k^): {same}", flush=True)
    if not all(same):
        raise AssertionError(f"the backward's pre-pass differs from the forward's operands: {same}")


def _sdpa_bwd_ms(q, k, v, do, heads):
    """(B, S, H*D) bf16 -> the median ms of SDPA's backward alone (one
    ``autograd.grad`` through a retained graph of
    ``scaled_dot_product_attention``; the port never calls it)."""
    import torch.nn.functional as F

    from adv_grpo_torch.ops.attention import to_bhsd

    leaves = [to_bhsd(t, heads).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    return _grad_ms((out,), leaves, (to_bhsd(do, heads),))


def check_backward_kernels():
    """Phase: the two joint backward kernels (and the lse the forwards now
    write) against their plain twin at the training shape: CFG batch 8 of
    the 4-image microbatch, 1024 + 154 tokens, 24x64, bf16. Bound: relative
    L2 2e-2 per cotangent — bf16 rounding of p and t, the same budget as the
    forward's 2e-2; the pre-pass's operands bit for bit."""
    import torch

    from adv_grpo_torch.ops import joint_attention as ja
    from adv_grpo_torch.ops.attention import bwd_row_stats
    from adv_grpo_torch.ops.fused_norms import rms_reference

    bound = 2e-2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, s_img, s_txt, heads, dim = 8, 1024, 154, 24, 1536

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def weights(n):
        return [(1.0 + 0.1 * torch.randn(64, generator=g, device=dev)).float()
                for _ in range(n)]

    def check(what, got, ref):
        return _check_rel_l2(what, got, ref, bound)

    results = []
    streams = [randn(b, s_img, dim) for _ in range(3)] + [randn(b, s_txt, dim)
                                                          for _ in range(3)]
    w4 = weights(4)
    cots = [randn(b, s_img, dim), randn(b, s_txt, dim)]
    lens = (s_img, s_txt)
    cases = [
        ("joint_attention_bwd", "adv_grpo_tpu/ops/joint_attention.py:224", ja.joint_mha,
         ja.joint_mha_reference, ja.joint_attention_fwd, ja.joint_attention_bwd,
         streams, w4, cots),
        ("mha_rms_bwd", "adv_grpo_tpu/ops/joint_attention.py:387", ja.mha_rms,
         ja.mha_rms_reference, ja.mha_rms_fwd, ja.mha_rms_bwd, streams[:3], w4[:2],
         cots[:1]),
    ]
    for name, replaces, fn, ref_fn, fwd, bwd, ins, w, do in cases:
        n = len(do)
        qs, ks, vs = ins[0::3], ins[1::3], ins[2::3]
        # the forward's lse against the fp32 plain forward on the same inputs
        out = fwd(*ins, w, heads, 1e-6, 0.125, True)
        o, lse = out[:n], out[n:]
        ref = ref_fn(*(t.float() for t in ins), num_heads=heads, rms_weights=w,
                     return_lse=True)
        check(f"{fn.__name__} forward lse", lse, ref[n:])
        di = [bwd_row_stats(a, c, heads) for a, c in zip(o, do)]
        kw = dict(num_heads=heads, rms_weights=w)
        got = bwd(*ins, *do, *lse, *di, **kw)
        pairs = [tuple(w[i:i + 2]) for i in range(0, len(w), 2)]  # (wq, wk) per stream
        _check_prepass(ja, qs, ks, heads, pairs)
        twin = ja.attention_bwd_reference(
            [q.float() for q in qs], [k.float() for k in ks], [v.float() for v in vs],
            [c.float() for c in do], lse, di, num_heads=heads, rms_weights=pairs)
        twin = [a for s in twin for a in s]  # dyq, dyk, dv per stream
        got = [got[i * 3 + j] for i in range(n) for j in range(3)]
        max_abs = check(f"{name} kernel vs its plain twin (dyq, dyk, dv per stream)",
                        got, twin)
        ms = _median_ms(lambda: bwd(*ins, *do, *lse, *di, **kw))
        plain_ms = _median_ms(lambda: ja.attention_bwd_reference(
            qs, ks, vs, do, lse, di, num_heads=heads, rms_weights=pairs))
        # a yardstick, not the same function (no lse input, no fused qk-RMS):
        # SDPA's backward on the normalised streams, concatenated
        normed = [rms_reference(x, wx, heads, 1e-6, x.dtype)
                  for x, wx in zip(qs + ks, [p_[0] for p_ in pairs] + [p_[1] for p_ in pairs])]
        cat = [torch.cat(normed[:n], 1), torch.cat(normed[n:], 1), torch.cat(vs, 1)]
        sdpa_ms = _sdpa_bwd_ms(*cat, torch.cat(do, 1), heads)
        del normed, cat
        print(f"kernel {name}: B={b} {'+'.join(map(str, lens[:n]))} tokens 24x64 median "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; SDPA backward on the normalised "
              f"streams, concatenated (not the same function) {sdpa_ms:.4f} ms", flush=True)

        # the whole autograd backward against fp32 autograd of the plain forward
        leaves = [t.clone().requires_grad_() for t in ins] + [
            x.clone().requires_grad_() for x in w]
        outs = fn(*leaves[:len(ins)], num_heads=heads, rms_weights=leaves[len(ins):])
        outs = outs if n > 1 else (outs,)
        grads = torch.autograd.grad(outs, leaves, do, retain_graph=True)
        f_leaves = [t.detach().float().requires_grad_() for t in leaves]
        f_outs = ref_fn(*f_leaves[:len(ins)], num_heads=heads,
                        rms_weights=f_leaves[len(ins):])
        f_outs = f_outs if n > 1 else (f_outs,)
        ref_grads = torch.autograd.grad(f_outs, f_leaves, [c.float() for c in do])
        check(f"{fn.__name__} autograd backward vs fp32 plain autograd "
              "(dq, dk, dv per stream, then dwq, dwk)", grads, ref_grads)
        del f_outs, ref_grads
        bf_leaves = [t.detach().requires_grad_() for t in leaves]
        p_outs = ref_fn(*bf_leaves[:len(ins)], num_heads=heads,
                        rms_weights=bf_leaves[len(ins):])
        p_outs = p_outs if n > 1 else (p_outs,)
        auto_ms = _grad_ms(outs, leaves, do)
        auto_plain_ms = _grad_ms(p_outs, bf_leaves, do)
        print(f"  {fn.__name__} whole autograd backward: median {auto_ms:.4f} ms vs plain "
              f"autograd {auto_plain_ms:.4f} ms", flush=True)
        del outs, p_outs, grads
        s_tot = sum(lens[:n])
        least = _attn_bound(list(ins) + list(do) + list(lse) + list(di) + list(ins), b, heads,
                            s_tot, s_tot, 64, products=5)
        # no library call takes the forward's lse and the fused qk-RMS
        results.append(_entry(name, BWD_SM90_SOURCE, replaces, max_abs, ms, plain_ms, least,
                              None))
    return results


def check_model():
    """Phase 4: 2 full-width layers on the card (bf16 + kernels) vs the CPU
    (fp32 + plain versions), same weights, 16x16 latents, 154 text tokens."""
    import torch

    from adv_grpo_torch.models.mmdit import MMDiT, MMDiTConfig
    from adv_grpo_torch.models.lora import init_params_

    cfg = MMDiTConfig.sd35_medium(num_layers=2, dual_attention_layers=(0,),
                                  lora_rank=32, lora_alpha=64.0, dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED)
    cpu = MMDiT(cfg, device="cpu")
    init_params_(cpu, g)
    for name, p in cpu.named_parameters():
        if name.endswith("lora_b"):  # non-zero adapters, so LoRA is exercised
            p.data.normal_(0.0, 0.02, generator=g)
    gpu = MMDiT(MMDiTConfig.sd35_medium(num_layers=2, dual_attention_layers=(0,),
                                        lora_rank=32, lora_alpha=64.0),
                device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    lat = torch.randn(2, 16, 16, 16, generator=g)
    t = torch.tensor([1000.0, 500.0])
    ctx = torch.randn(2, 154, 4096, generator=g) * 0.2
    pooled = torch.randn(2, 2048, generator=g) * 0.2
    with torch.inference_mode():
        ref = cpu(lat, t, ctx, pooled)
        out = gpu(lat.cuda(), t.cuda(), ctx.cuda(), pooled.cuda()).float().cpu()
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"model check: 2-layer full-width MMDiT, card bf16 vs CPU fp32 relative "
          f"L2 error {rel:.3e} (bound 5e-2, bf16 rounding through 2 layers)", flush=True)
    if not (torch.isfinite(out).all() and rel <= 5e-2):
        raise AssertionError(f"card MMDiT disagrees with the CPU reference: {rel}")
    return cpu, gpu, (lat, t, ctx, pooled), g


def _lora_grads(model, call, cot):
    """The concatenated fp32 LoRA gradients of ``call(model)`` through the
    cotangent ``cot``, on the CPU."""
    import torch

    from adv_grpo_torch.models.lora import freeze_non_lora

    lora = freeze_non_lora(model)
    out = call(model)
    gs = torch.autograd.grad(out.float(), list(lora.values()), cot.to(out.device))
    return torch.cat([x.float().flatten().cpu() for x in gs])


# the LoRA gradients of a 2-layer full-width model with remat against those
# without, on the card: identical runs without remat differ by up to a few
# 1e-4 relative L2 on an H100 80GB HBM3 at 700 W, in bursts (the backward
# kernels' fp32 reduce-adds are unordered, and a flipped bf16 rounding of dq
# moves a row; other pairs read 0 or 1e-6), so the gap to the nearest plain
# run is bounded by the larger of this and twice the plain runs' own spread;
# the recompute itself is held bit for bit (``_recompute_matches``)
REMAT_GRAD_SPREAD = 1e-3


def _blocks(model):
    """The checkpointed blocks of an MMDiT, Flux or WAN transformer."""
    return [b for name in ("transformer_blocks", "single_transformer_blocks", "blocks")
            for b in getattr(model, name, ())]


def _recompute_matches(model, fn):
    """Run ``fn()`` (a forward and backward with remat on) with every
    block's calls recorded and the recompute's early stop off: each block
    runs twice, the forward and its recompute in the backward. Returns the
    blocks whose two calls' outputs are not bitwise equal (or that did not
    run twice)."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    calls = {}
    for i, block in enumerate(_blocks(model)):
        forward = block.forward

        def recorded(*a, _i=i, _forward=forward, **kw):
            out = _forward(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.setdefault(_i, []).append([None if o is None else o.detach().clone()
                                             for o in outs])
            return out
        block.forward = recorded
    try:
        with set_checkpoint_early_stop(False):
            fn()
    finally:
        for block in _blocks(model):
            del block.forward
    return [i for i in range(len(_blocks(model)))
            if len(calls.get(i, ())) != 2 or not all(
                (x is None and y is None) or (x is not None and y is not None and x.equal(y))
                for x, y in zip(*calls[i]))]


def _check_remat_grads(what, model, grads_of, ref):
    """The LoRA gradients ``grads_of(model)`` on the card with remat off,
    three times, and on (the MMDiT at its default policy): each within
    5e-2 of the fp32 CPU gradients ``ref`` (the forward's bf16 budget); with
    remat, every block's recompute bitwise its first forward
    (``_recompute_matches``), and the gradients within the larger of
    REMAT_GRAD_SPREAD and twice the plain runs' spread of the nearest plain
    run."""
    import dataclasses
    import itertools

    import torch

    base = model.cfg
    remat = [("on", dict(remat=True))]
    plain, got, mismatched = [], {}, {}
    try:
        model.cfg = dataclasses.replace(base, remat=False)
        plain = [grads_of(model) for _ in range(3)]
        for name, kw in remat:
            model.cfg = dataclasses.replace(base, **kw)
            mismatched[name] = _recompute_matches(
                model, lambda n=name: got.__setitem__(n, grads_of(model)))
    finally:
        model.cfg = base
    spread = max(_rel_l2(x, y) for x, y in itertools.combinations(plain, 2))
    bound = max(REMAT_GRAD_SPREAD, 2 * spread)
    bad = []
    for i, gr in enumerate(plain):
        fp32 = _rel_l2(gr, ref)
        print(f"model gradients: {what}, remat off (run {i + 1} of 3): LoRA gradients card bf16 "
              f"vs CPU fp32 relative L2 {fp32:.3e} over {ref.numel()} values (bound 5e-2)",
              flush=True)
        if not (torch.isfinite(gr).all() and fp32 <= 5e-2):
            bad.append(f"off {i + 1}")
    for name, gr in got.items():
        fp32 = _rel_l2(gr, ref)
        gap = min(_rel_l2(gr, x) for x in plain)
        print(f"model gradients: {what}, remat {name}: LoRA gradients card bf16 vs CPU fp32 "
              f"relative L2 {fp32:.3e} (bound 5e-2); vs the nearest plain run {gap:.3e} (bound "
              f"{bound:.1e}: the plain runs' spread {spread:.3e}); blocks whose recompute is "
              f"not bitwise their forward: {mismatched[name]} of {len(_blocks(model))}",
              flush=True)
        if not (torch.isfinite(gr).all() and fp32 <= 5e-2 and gap <= bound
                and not mismatched[name]):
            bad.append(name)
    if bad:
        raise AssertionError(f"{what}: card LoRA gradients out of bounds: {bad}")


def check_model_grads(cpu, gpu, inputs, g, what="2-layer full-width MMDiT"):
    """Phase: LoRA gradients of the same 2-layer full-width model (the MMDiT,
    or the WAN; non-zero LoRA B) on the card (bf16, forward and backward
    kernels) and on the CPU (fp32, plain versions), through one fixed
    cotangent, with remat off and on (``_check_remat_grads``)."""
    import torch

    cot = torch.randn(inputs[0].shape, generator=g)

    def grads_of(dev):
        return lambda model: _lora_grads(model, lambda m: m(*(a.to(dev) for a in inputs)), cot)

    _check_remat_grads(what, gpu, grads_of("cuda"), grads_of("cpu")(cpu))


def run_pipeline():
    """Phases 5 and 6; returns the launch counts of the main-path run."""
    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import infer
    from adv_grpo_torch.ops import fused_norms, joint_attention

    kernels = (fused_norms.modulated_layer_norm, joint_attention.joint_mha,
               joint_attention.mha_rms)
    with tempfile.TemporaryDirectory() as out_dir:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        paths = infer.main(INFER_ARGV + ["--out_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        img = np.asarray(Image.open(paths[0]))
    print(f"infer.main eval_sd3_fast full width 512^2 {STEPS} steps CFG 4.5: {wall:.2f} s "
          f"wall (pipeline build included); PNG {img.shape}, pixel range "
          f"{img.min()}..{img.max()}; launches {counts}", flush=True)
    if img.shape != (512, 512, 3) or img.min() == img.max():
        raise AssertionError(f"bad PNG: shape {img.shape}, range {img.min()}..{img.max()}")
    from adv_grpo_torch.models.mmdit import MMDiTConfig

    want = [c * STEPS for c in per_forward_counts(MMDiTConfig.sd35_medium())]
    if counts != want:
        raise AssertionError(f"kernel launch counts {counts}, expected {want}")

    # CFG batch 2 and 8 on one warm pipeline
    from adv_grpo_torch.cli.common import apply_overrides, build_pipeline, \
        build_text_encoder, resolve_config

    config = apply_overrides(resolve_config("eval_sd3_fast"), ["pretrained.model=''"])
    pipeline = build_pipeline(config)
    encode = build_text_encoder(config, pipeline)
    for prompts in (["a flower"], ["a flower", "a red bicycle", "a city at night",
                                   "a bowl of fruit"]):
        infer.generate(pipeline, encode, prompts, config, seed=SEED)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = infer.generate(pipeline, encode, prompts, config, seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if images.shape != (len(prompts), 3, 512, 512) or not torch.isfinite(images).all():
            raise AssertionError(f"bad images: {tuple(images.shape)}, finite="
                                 f"{bool(torch.isfinite(images).all())}")
        print(f"generate {len(prompts)} prompt(s), CFG batch {2 * len(prompts)}: "
              f"{dt:.3f} s, {dt / len(prompts):.3f} s/image (40 steps + VAE decode)",
              flush=True)
        # one CFG-batched MMDiT forward: its CUDA-event time and its device
        # time by kernel group
        n = 2 * len(prompts)
        emb, pooled = (torch.from_numpy(np.asarray(a)).cuda()
                       for a in encode(prompts + [""] * len(prompts)))
        x = pipeline.prepare_latents(torch.Generator(device="cuda").manual_seed(SEED), n)
        t = torch.full((n,), 500.0, device="cuda")
        vfn = pipeline.velocity_fn()
        with torch.inference_mode():
            fwd_ms = _median_ms(lambda: vfn(x, t, emb, pooled), iters=5, warmup=1)
            kernel_ms, groups = _profile_forward(lambda: vfn(x, t, emb, pooled))
        print(f"  one MMDiT forward at CFG batch {n}: {fwd_ms:.2f} ms; device kernel time "
              f"{kernel_ms:.2f} ms = {100 * kernel_ms / fwd_ms:.1f}% busy", flush=True)
        for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"    {grp}: {ms:.2f} ms, {calls:.0f} launches per forward", flush=True)

    # the SD3 noise sweep (cli.sde_noise_sweep) on the warm pipeline
    from adv_grpo_torch.cli import sde_noise_sweep

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = sde_noise_sweep.sweep(pipeline, encode, "a photo of a red panda", DEMO_LEVELS,
                                    DEMO_STEPS, float(config.sample.guidance_scale), 64, out_dir)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check_demo("cli.sde_noise_sweep (eval_sd3_fast, full width, 512^2)", res, DEMO_LEVELS,
                    dt, (512, 512, 3))
    return counts


def _check_demo(what, results, levels, seconds, png_shape):
    """A demo sweep's PNGs (of ``png_shape``, one a level; the first two
    levels' differ) and rollouts (finite latents; finite log-probs at each
    noise level above 0: at 0 the Flow-SDE step's Gaussian is degenerate,
    and its log-prob is NaN, as in the JAX script): printed, and raises on a
    bad one."""
    import numpy as np
    import torch
    from PIL import Image

    pngs = [np.asarray(Image.open(p)) for p, _ in results]
    finite = all(bool(torch.isfinite(o.final_latents).all())
                 and (nl == 0.0 or bool(torch.isfinite(o.log_probs).all()))
                 for (_, o), nl in zip(results, levels))
    print(f"{what}: {len(results)} levels of {DEMO_STEPS} steps in {seconds:.2f} s; PNGs "
          f"{[os.path.basename(p) for p, _ in results]} {[x.shape for x in pngs]}; mean log-probs "
          f"{[round(float(o.log_probs.mean()), 4) for _, o in results]}; finite {finite}",
          flush=True)
    if (not finite or any(x.shape != png_shape for x in pngs)
            or np.array_equal(pngs[0], pngs[1])):
        raise AssertionError(f"{what}: bad sweep, PNGs {[x.shape for x in pngs]}, finite {finite}")


def expected_train_counts(config, mcfg, epochs=EPOCHS, g_epochs=None):
    """Launches of the 5 kernels in ``epochs`` epochs of a training run, from
    the config: rollout forwards (one CFG-batched forward per step), and in
    the ``g_epochs`` of them that take the GRPO update (all by default; a
    D-epoch runs only its rollouts) the replay forwards, their blocks'
    recompute (``per_recompute_counts``) and their backwards (one per
    microbatch, two with cfg_sequential; with ``train.beta`` > 0 a LoRA-off
    replay forward more per microbatch, under no_grad: no recompute); and
    the microsteps of one G epoch."""
    s, t = config.sample, config.train
    g_epochs = epochs if g_epochs is None else g_epochs
    per_epoch = (max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
                 * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    replay = g_epochs * per_epoch * (2 if bool(t.cfg_sequential) and bool(t.cfg) else 1)
    # train.beta > 0 (the DPO preset's KL anchor) replays each microbatch once
    # more with the LoRA off, forward only
    fwd = (epochs * int(s.num_batches_per_epoch) * int(s.num_steps)
           + replay * (2 if float(t.beta) > 0 else 1))
    return ([f * fwd + r * replay
             for f, r in zip(per_forward_counts(mcfg), per_recompute_counts(mcfg))]
            + [c * replay for c in per_backward_counts(mcfg)]), per_epoch


def _remat_on_off(what, model, epoch, n_micro, smi):
    """``epoch()`` (``n_micro`` microsteps of the trainer's epoch, run once
    before as a warm-up) with remat off and on, in turns there and back
    (off, on, on, off): each variant's ms per microstep (CUDA events, each
    turn's and their mean) and peak device memory, the model's weights, the
    optimizer's state and the epoch's inputs included. Leaves the model's
    configuration as it was."""
    import dataclasses

    import torch

    base = model.cfg
    variants = [("off", dict(remat=False)), ("on", dict(remat=True))]
    turns, peaks = {}, {}
    try:
        for name, kw in variants + variants[::-1]:
            model.cfg = dataclasses.replace(base, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            turns.setdefault(name, []).append(_median_ms(epoch, iters=1, warmup=0) / n_micro)
            peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    finally:
        model.cfg = base
    for name, _ in variants:
        ms = turns[name]
        print(f"  {what}, remat {name}: {sum(ms) / len(ms):.1f} ms per microstep (CUDA events; "
              f"turns {', '.join(f'{t:.1f}' for t in ms)}), peak device memory "
              f"{peaks[name]:.2f} GiB; {smi}", flush=True)


def run_training_slice(kernels, smi, remat_ab=False):
    """Phase: ``adv_grpo_torch.cli.train.main`` on TRAIN_ARGV (full width,
    random weights from the seed); returns the kernels' launch counts. Then
    the last inner epoch's microsteps again on the trained state, traced:
    one microstep's device time by kernel group; with ``remat_ab`` also with
    remat off and on (``_remat_on_off``)."""
    import os

    import numpy as np
    import torch

    from adv_grpo_torch.cli import train
    from adv_grpo_torch.cli.common import build_pipeline
    from adv_grpo_torch.models.lora import lora_params
    from adv_grpo_torch.train import driver

    # keep the last inner epoch's (minibatches, negative embeddings)
    last, make_epoch = {}, driver.make_train_epoch_fn

    def recording_epoch_fn(*args, **kwargs):
        fn = make_epoch(*args, **kwargs)

        def epoch(state, batched, neg_e, neg_p):
            last["args"] = (batched, neg_e, neg_p)
            return fn(state, batched, neg_e, neg_p)
        return epoch

    with tempfile.TemporaryDirectory() as save_dir:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        driver.make_train_epoch_fn = recording_epoch_fn
        try:
            trainer = train.main(TRAIN_ARGV + ["--set", f"save_dir={save_dir}"])
        finally:
            driver.make_train_epoch_fn = make_epoch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    config, mcfg = trainer.config, trainer.pipeline.mmdit_cfg
    want, micro = expected_train_counts(config, mcfg)
    print(f"cli.train smoke_sd3_fast full width 512^2, {config.sample.num_steps}-step "
          f"rollouts, {EPOCHS} epochs: {wall:.2f} s wall (pipeline build included); peak "
          f"device memory {peak / 2**30:.2f} GiB; launches {counts}", flush=True)
    nb = int(config.sample.num_batches_per_epoch)
    for r in records:
        rollout = r["time/rollout"] * nb
        reward = r["time/reward_wait"]
        print(f"  epoch {r['epoch']}: rollout+decode {rollout:.3f} s, reward {reward:.3f} s "
              f"(not overlapped with a rollout), train {r['time/train']:.3f} s = "
              f"{r['time/train'] / micro:.3f} s per microstep ({micro} microsteps); reward "
              f"{r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}, "
              f"clipfrac {r['clipfrac']:.3f}", flush=True)
        bad = [k for k in ("reward_avg", "loss", "approx_kl", "clipfrac")
               if not np.isfinite(r[k])]
        if bad:
            raise AssertionError(f"epoch {r['epoch']}: non-finite {bad}")
    if len(records) != EPOCHS or trainer.state.global_step == 0:
        raise AssertionError(f"{len(records)} epochs logged, global step "
                             f"{trainer.state.global_step}")

    # the starting LoRA: the same seed builds the same weights
    start = lora_params(build_pipeline(config, device="cuda").mmdit)
    # the last block's text query feeds only the text output, which that
    # block drops: its B factor starts at 0 and gets no gradient
    idle = {f"block_{mcfg.num_layers - 1}/attn/add_q_proj/lora_b"}
    lora, ema = trainer.state.lora, trainer.state.ema
    unchanged = {k for k, p in lora.items() if torch.equal(p, start[k])}
    ema_unchanged = {k for k, e in ema.items() if torch.equal(e, start[k])}
    finite = all(bool(torch.isfinite(p).all()) for p in lora.values())
    print(f"  LoRA: {len(lora) - len(unchanged)} of {len(lora)} tensors changed, finite "
          f"{finite}; EMA: {len(ema) - len(ema_unchanged)} changed; optimizer steps "
          f"{trainer.state.global_step}", flush=True)
    if not finite or not unchanged <= idle or not ema_unchanged <= idle:
        raise AssertionError(f"LoRA finite={finite}, unchanged {sorted(unchanged)}, EMA "
                             f"unchanged {sorted(ema_unchanged)}")
    del start
    if counts != want:
        raise AssertionError(f"training launch counts {counts}, expected {want}")

    # the last inner epoch's microsteps (replay forward, backward, optimizer)
    # once more, traced
    batched, neg_e, neg_p = last["args"]
    n_micro = batched["latents"].shape[0] * int(config.sample.train_num_steps)

    def epoch():
        trainer.train_epoch_fn(trainer.state, batched, neg_e, neg_p)

    step_ms = _median_ms(epoch, iters=3, warmup=1) / n_micro
    kernel_ms, groups = _profile_forward(epoch, reps=1)
    print(f"  one microstep ({batched['latents'].shape[1]} rows): {step_ms:.1f} ms (CUDA "
          f"events); device kernel "
          f"time {kernel_ms / n_micro:.1f} ms = {100 * kernel_ms / n_micro / step_ms:.1f}% busy",
          flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms / n_micro:.2f} ms, {calls / n_micro:.0f} launches per microstep",
              flush=True)
    if remat_ab:
        _remat_on_off(f"smoke_sd3_fast microstep ({batched['latents'].shape[1]} rows)",
                      trainer.pipeline.mmdit, epoch, n_micro, smi)
    return counts


def _reference_images(out_dir, prompts, n=4):
    """``n`` smooth random 512^2 PNGs from the seed in ``out_dir`` and a
    prompt -> file JSON over ``prompts``; returns the JSON's path."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    for i in range(n):
        small = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(small).resize((512, 512), Image.BICUBIC).save(
            os.path.join(out_dir, f"ref{i}.png"))
    path = os.path.join(out_dir, "refs.json")
    with open(path, "w") as f:
        json.dump({p: [f"ref{i % n}.png"] for i, p in enumerate(prompts)}, f)
    return path


def _train_recorded(argv, work, kernels, hold, on_build=None):
    """``cli.train.main(argv)`` against reference PNGs it writes in ``work``
    for the dataset's prompts (its run directory there too), the launch
    counts zeroed just before. ``hold`` gets the trainer, its LoRA and EMA
    as built, the last sampling phase's samples, and the wall time of each
    sampling phase ("sample"), D-epoch ("d") and G update ("g"), those run
    after ``main`` too; ``on_build(trainer)`` runs on the trainer as built.
    Returns (counts, the metrics.jsonl records, wall s)."""
    import torch

    from adv_grpo_torch.cli import train
    from adv_grpo_torch.data.datasets import TextPromptDataset

    build = train.build_trainer

    def timed(key, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            hold[key].append(time.perf_counter() - t0)
            if key == "sample":
                hold["samples"] = out
            return out
        return call

    def recording_build(*args, **kwargs):
        trainer = build(*args, **kwargs)
        hold.update(trainer=trainer, sample=[], d=[], g=[],
                    lora={k: p.detach().clone() for k, p in trainer.state.lora.items()},
                    ema={k: e.clone() for k, e in trainer.state.ema.items()})
        if on_build is not None:
            on_build(trainer)
        trainer.sample_phase = timed("sample", trainer.sample_phase)
        trainer.d_phase = timed("d", trainer.d_phase)
        trainer.train_phase = timed("g", trainer.train_phase)
        return trainer

    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    run = os.path.join(work, "run")
    argv = argv + ["--set", f"json_path={_reference_images(work, prompts)}",
                   "--set", f"reference_image_path={work}", "--set", f"save_dir={run}"]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    train.build_trainer = recording_build
    try:
        train.main(argv)
    finally:
        train.build_trainer = build
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return counts, records, wall


def run_cotrain_slice(kernels, smi):
    """Phase: ``adv_grpo_torch.cli.train.main`` on COTRAIN_ARGV, the paper's
    main path (full SD3.5-M width, random weights from the seed; the
    full-width CLIP-H PickScore discriminator, random weights from the seed
    + 1, fp32), against reference PNGs it writes for the dataset's prompts.
    The gate decides each epoch's branch; then the branch it never took runs
    once on the last epoch's samples, so both run. Checks: the launch counts
    of #1-#5 as derived from the config and the branches; after the D-steps
    the trainable tail moved and is finite, every other CLIP tensor and the
    frozen 'pickscore' score of a fixed batch are bitwise unchanged, the
    'pickscore_cotrain' score moved, d_loss / d_acc finite; after the G
    update the LoRA and its EMA moved. Prints the D-step ms per sampling
    batch, CLIP-H scoring ms per batch (generated and reference images), s
    per epoch on each branch and the peak device memory."""
    import numpy as np
    import torch

    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.train.grpo_trainer import compute_advantages

    probe = np.random.default_rng(SEED + 1).uniform(-1, 1, (4, 3, 512, 512)).astype(np.float32)
    probe_prompts = ["a flower", "a red bicycle", "a city at night", "a bowl of fruit"]

    def probe_scores(ctx):  # (frozen 'pickscore', live 'pickscore_cotrain') of the probe
        return tuple(multi_score({name: 1.0}, ctx)(probe, probe_prompts)[0][name]
                     for name in ("pickscore", "pickscore_cotrain"))

    def on_build(trainer):
        clip = trainer.reward_ctx.pickscore.clip
        hold.update(scores=probe_scores(trainer.reward_ctx),
                    clip={k: v.to("cpu", copy=True) for k, v in clip.state_dict().items()})

    hold = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        counts, records, wall = _train_recorded(COTRAIN_ARGV, work, kernels, hold, on_build)
    trainer, samples = hold["trainer"], hold["samples"]
    config, mcfg, nb = trainer.config, trainer.pipeline.mmdit_cfg, trainer.num_batches
    branches = [bool(r["d_epoch"]) for r in records]
    print(f"cli.train pickscore_cotrain_sd3_fast full width (SD3.5-M 512^2, CLIP-H/14 fp32 "
          f"random), {config.sample.num_steps}-step rollouts of "
          f"{samples['epoch_images'][0].shape[0]} images, {nb} sampling batches an epoch, "
          f"{COTRAIN_EPOCHS} epochs: {wall:.2f} s wall (builds included); launches {counts}; "
          f"{smi}", flush=True)
    if len(records) != COTRAIN_EPOCHS:
        raise AssertionError(f"{len(records)} epochs logged")
    for r in records:
        print(f"  epoch {r['epoch']}: gate d_epoch={r['d_epoch']} (reward_avg "
              f"{r['reward_avg']:.6f}, reference_reward_avg {r['reference_reward_avg']:.6f})",
              flush=True)
        keys = ["reward_avg", "reference_reward_avg"] + (
            ["d_loss", "d_acc"] if r["d_epoch"] else ["loss", "approx_kl", "clipfrac"])
        if not all(np.isfinite(r[k]) for k in keys) or r["d_epoch"] != int(
                r["reference_reward_avg"] < r["reward_avg"]):
            raise AssertionError(f"epoch {r['epoch']}: {r}")
        if r["d_epoch"] and not 0.0 <= r["d_acc"] <= 1.0:
            raise AssertionError(f"d_acc {r['d_acc']}")
    want, _ = expected_train_counts(config, mcfg, COTRAIN_EPOCHS, branches.count(False))
    if counts != want:
        raise AssertionError(f"co-train launch counts {counts}, expected {want} (branches "
                             f"{branches})")

    # the branch the gate never took, once, on the last epoch's samples
    extra = None if len(set(branches)) == 2 else ("G" if branches[0] else "D")
    for k in kernels:
        k.launches = 0
    if extra == "D":
        out = trainer.d_phase(samples)
        print(f"  extra D-epoch on the last samples: d_loss {out['d_loss']:.5f}, d_acc "
              f"{out['d_acc']:.3f}", flush=True)
        if not (np.isfinite(out["d_loss"]) and 0.0 <= out["d_acc"] <= 1.0):
            raise AssertionError(f"extra D-epoch {out}")
        want_extra = [0] * len(kernels)
    elif extra == "G":
        adv, _ = compute_advantages(trainer.tracker, samples["prompt_ids"],
                                    np.asarray(samples["rewards"]["avg"], np.float32))
        info = trainer.train_phase(samples, adv)
        print(f"  extra G epoch on the last samples: loss {info['loss']:.3e}, approx_kl "
              f"{info['approx_kl']:.3e}", flush=True)
        if not all(np.isfinite(v) for v in info.values()):
            raise AssertionError(f"extra G epoch {info}")
        want_extra = expected_train_counts(config, mcfg, 0, 1)[0]
    else:
        want_extra = [0] * len(kernels)
    extra_counts = [k.launches for k in kernels]
    if extra_counts != want_extra:
        raise AssertionError(f"extra {extra} launch counts {extra_counts}, expected {want_extra}")
    peak = torch.cuda.max_memory_allocated()

    # the discriminator: only the tail moved; the frozen reward did not
    ctx, clip = trainer.reward_ctx, trainer.reward_ctx.pickscore.clip
    tail = {n for n, p in clip.named_parameters() if p.requires_grad}
    moved_tail = [n for n in tail if not torch.equal(clip.state_dict()[n].cpu(), hold["clip"][n])]
    finite_tail = all(bool(torch.isfinite(p).all()) for n, p in clip.named_parameters()
                      if n in tail)
    changed_frozen = [n for n, v in clip.state_dict().items()
                      if n not in tail and not torch.equal(v.cpu(), hold["clip"][n])]
    frozen, live = probe_scores(ctx)
    print(f"  PickScore D: {len(moved_tail)} of {len(tail)} tail tensors moved (vision layer "
          f"{config.tune_layer}), finite {finite_tail}; {len(changed_frozen)} frozen tensors "
          f"changed; probe 'pickscore' max change "
          f"{np.abs(frozen - hold['scores'][0]).max():.3e}, 'pickscore_cotrain' "
          f"{np.abs(live - hold['scores'][1]).max():.3e}", flush=True)
    if (not tail or len(moved_tail) != len(tail) or not finite_tail or changed_frozen
            or not np.array_equal(frozen, hold["scores"][0])
            or np.array_equal(live, hold["scores"][1])):
        raise AssertionError(f"discriminator: tail moved {moved_tail}, finite {finite_tail}, "
                             f"frozen changed {changed_frozen}")
    idle = {f"block_{mcfg.num_layers - 1}/attn/add_q_proj/lora_b"}
    lora, ema = trainer.state.lora, trainer.state.ema
    unchanged = {k for k, p in lora.items() if torch.equal(p, hold["lora"][k])}
    ema_unchanged = {k for k, e in ema.items() if torch.equal(e, hold["ema"][k])}
    print(f"  LoRA: {len(lora) - len(unchanged)} of {len(lora)} tensors changed; EMA "
          f"{len(ema) - len(ema_unchanged)} changed; global step {trainer.state.global_step}",
          flush=True)
    if not unchanged <= idle or not ema_unchanged <= idle:
        raise AssertionError(f"LoRA unchanged {sorted(unchanged)}, EMA {sorted(ema_unchanged)}")

    # CLIP-H scoring of one sampling batch: generated and reference images
    images, refs, prompts = samples["last_images"], samples["last_refs"], samples["last_prompts"]
    refs = refs.reshape((-1,) + refs.shape[-3:])[:len(prompts)]
    score_ms = {}
    for what, batch in (("generated", images), ("reference", refs)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.reward_fn(batch, prompts)  # ends in a copy to the host
            times.append((time.perf_counter() - t0) * 1e3)
        score_ms[what] = sorted(times)[1]
    branch_s = {"D": [], "G": []}
    d_i = g_i = 0
    for e, is_d in enumerate(branches + ([extra == "D"] if extra else [])):
        update = hold["d"][d_i] if is_d else hold["g"][g_i]
        d_i, g_i = d_i + is_d, g_i + (not is_d)
        branch_s["D" if is_d else "G"].append(hold["sample"][min(e, len(hold["sample"]) - 1)]
                                              + update)
    print(f"  co-train timings ({smi}): D-step "
          f"{[round(1e3 * t / nb, 1) for t in hold['d']]} ms per sampling batch of "
          f"{len(images)} pairs; CLIP-H scoring {score_ms['generated']:.1f} ms per batch of "
          f"{len(images)} generated images, {score_ms['reference']:.1f} ms of {len(refs)} "
          f"references; s per epoch (sampling + update) D {[round(t, 2) for t in branch_s['D']]}"
          f", G {[round(t, 2) for t in branch_s['G']]} (the extra {extra or 'none'} epoch "
          f"reuses the last sampling); sampling {[round(t, 2) for t in hold['sample']]} s; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    return [c + x for c, x in zip(counts, extra_counts)]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path)
               for f in files)


def _state_snapshot(trainer):
    """Copies of every tensor a checkpoint holds (the generator state, the
    discriminator's module and Adam state) and the counters."""
    st, d = trainer.state, trainer.disc
    tensors = {f"{g}/{k}": v.detach().clone() for g in ("lora", "acc", "mu", "nu", "ema")
               for k, v in getattr(st, g).items()}
    tensors.update({f"d/{k}": v.detach().clone() for k, v in d.params.state_dict().items()})
    tensors.update({f"dopt/{i}/{k}": v.clone() for i, s in
                    d.opt_state.state_dict()["state"].items() for k, v in s.items()})
    return tensors, (st.count, st.global_step, st.micro_step)


def run_checkpoint_slice(kernels, smi):
    """Phase: checkpoints, resume and the LoRA interchange at full width.
    ``cli.train.main`` on COTRAIN_ARGV with ``save_freq=1``: the driver's own
    ``run`` writes ``checkpoint-{global_step}`` (``state.pt``, ``extra.pt``,
    the peft ``lora/``) at the start of epoch 1. The gate takes G in both
    epochs with the seed's CLIP-H (epoch 0 must be G, else the adapter would
    be the starting one), so no D-step has given the discriminator Adam
    moments: one D-epoch on the last samples, then ``save`` once more, every
    state tensor copied aside at each save. Then ``main`` again with
    ``--resume latest`` (that second checkpoint) and one epoch in the same
    run directory; before its first phase: LoRA, accumulator,
    Adam moments, EMA, the counters, the CLIP-H tail and its Adam state
    bitwise those at the save, the frozen 'pickscore' score of the probe
    bitwise that of the first (fresh) build and 'pickscore_cotrain' bitwise
    that at the save; the epoch counter starts again at 0 (as in the JAX
    package). The resumed epoch's launches of #1-#5 as derived for the
    branch its gate takes. Then ``cli.infer.main --lora <checkpoint>/lora``
    at ``eval_sd3_fast`` full width: launches of #1-#3 as derived, the image
    bitwise that of the same pipeline with the saved EMA LoRA merged by
    ``merge_lora_params``, and different from its image without the adapter
    (LoRA B at 0). Prints the bytes on disk, save and restore seconds and
    s/image."""
    import gc

    import numpy as np
    import torch

    from adv_grpo_torch.cli import common, infer
    from adv_grpo_torch.models.lora import lora_params, merge_lora_params
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.train import driver

    gc.collect()
    torch.cuda.empty_cache()
    probe = np.random.default_rng(SEED + 1).uniform(-1, 1, (4, 3, 512, 512)).astype(np.float32)
    probe_prompts = ["a flower", "a red bicycle", "a city at night", "a bowl of fruit"]

    def probe_scores(ctx):  # (frozen 'pickscore', live 'pickscore_cotrain') of the probe
        return tuple(multi_score({name: 1.0}, ctx)(probe, probe_prompts)[0][name]
                     for name in ("pickscore", "pickscore_cotrain"))

    snap = {}
    save = driver.GRPOTrainer.save

    def recording_save(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(self)
        snap.update(save_s=time.perf_counter() - t0, path=path,
                    state=_state_snapshot(self), scores=probe_scores(self.reward_ctx))
        return path

    def first_build(trainer):
        hold["fresh_scores"] = probe_scores(trainer.reward_ctx)

    def describe(path):
        sizes = [os.path.getsize(os.path.join(path, "state.pt")),
                 os.path.getsize(os.path.join(path, "extra.pt")),
                 _dir_bytes(os.path.join(path, "lora"))]
        return (f"{os.path.basename(path)} in {snap['save_s']:.3f} s: state.pt {sizes[0]:,} B, "
                f"extra.pt {sizes[1]:,} B, lora/ {sizes[2]:,} B")

    with tempfile.TemporaryDirectory() as work:
        hold = {}
        driver.GRPOTrainer.save = recording_save
        try:
            counts, records, wall = _train_recorded(
                COTRAIN_ARGV + ["--set", "save_freq=1"], work, kernels, hold, first_build)
            periodic = snap["path"]
            written = describe(periodic)
            # the run's save follows a G epoch (see below), before any D-step:
            # one D-epoch on the last samples gives the discriminator Adam
            # moments, and a second save holds them
            trainer = hold["trainer"]
            trainer.d_phase(hold["samples"])
            trainer.save()
        finally:
            driver.GRPOTrainer.save = save
        config, mcfg = trainer.config, trainer.pipeline.mmdit_cfg
        fresh_scores, branches = hold["fresh_scores"], [r["d_epoch"] for r in records]
        del hold, trainer
        gc.collect()
        torch.cuda.empty_cache()
        path = snap["path"]
        print(f"cli.train pickscore_cotrain_sd3_fast full width, save_freq 1, "
              f"{COTRAIN_EPOCHS} epochs: {wall:.2f} s wall (builds included); branches "
              f"{branches}; launches {counts}; the run wrote {written} at the start of epoch 1; "
              f"after one more D-epoch on the last samples, save wrote {describe(path)}; {smi}",
              flush=True)
        want = expected_train_counts(config, mcfg, COTRAIN_EPOCHS, branches.count(0))[0]
        layouts = [sorted(os.listdir(p)) for p in (periodic, path)]
        if layouts != [["extra.pt", "lora", "state.pt"]] * 2 or counts != want:
            raise AssertionError(f"checkpoints {layouts}; launches {counts}, expected {want}")
        if branches[0]:  # the seed's weights decide (the random CLIP-H took G first)
            raise AssertionError("epoch 0 was a D-epoch: the saved adapter is the starting "
                                 "one, which infer --lora cannot tell from no adapter")
        if not any(k.startswith("dopt/") for k in snap["state"][0]):
            raise AssertionError("the saved discriminator has no Adam state")

        # the resume: checked before its first phase
        checked = {}

        def resumed_build(trainer):
            restore, run = trainer.restore, trainer.run

            def timed_restore(p):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = restore(p)
                torch.cuda.synchronize()
                checked["restore_s"] = time.perf_counter() - t0
                return out

            def checked_run(**kw):
                tensors, counters = _state_snapshot(trainer)
                want_t, want_c = snap["state"]
                differ = [k for k, v in want_t.items() if not torch.equal(tensors[k], v)]
                frozen, live = probe_scores(trainer.reward_ctx)
                checked.update(epoch=trainer.epoch, n=len(want_t))
                if (set(tensors) != set(want_t) or differ or counters != want_c
                        or not np.array_equal(frozen, fresh_scores[0])
                        or not np.array_equal(live, snap["scores"][1])
                        or np.array_equal(live, fresh_scores[1])):
                    raise AssertionError(
                        f"resume: {len(differ)} tensors differ ({differ[:4]}), counters "
                        f"{counters} vs {want_c}, frozen score max change "
                        f"{np.abs(frozen - fresh_scores[0]).max():.3e}, live "
                        f"{np.abs(live - snap['scores'][1]).max():.3e}")
                return run(**kw)

            trainer.restore, trainer.run = timed_restore, checked_run

        hold = {}
        counts, records, wall = _train_recorded(
            COTRAIN_ARGV + ["--resume", "latest", "--max_epochs", "1"], work, kernels, hold,
            resumed_build)
        records = records[COTRAIN_EPOCHS:]  # the run directory's log goes on
        d_epoch = records[0]["d_epoch"]
        want = expected_train_counts(config, mcfg, 1, 1 - d_epoch)[0]
        print(f"cli.train --resume latest, 1 epoch: {wall:.2f} s wall (build included); restore "
              f"{checked['restore_s']:.3f} s; {checked['n']} tensors (generator state, CLIP-H "
              f"tail and its Adam state) and (count, global_step, micro_step) "
              f"{snap['state'][1]} bitwise those at the save; frozen 'pickscore' of the probe "
              f"bitwise a fresh build's, 'pickscore_cotrain' bitwise the save's (not a fresh "
              f"build's); epoch counter "
              f"restarted at {checked['epoch']}; d_epoch {d_epoch}; launches {counts}", flush=True)
        if len(records) != 1 or counts != want or checked["epoch"] != 0:
            raise AssertionError(f"resumed epoch: {len(records)} records, launches {counts}, "
                                 f"expected {want}")
        del hold
        gc.collect()
        torch.cuda.empty_cache()

        # infer --lora <checkpoint>/lora
        bare, call = {}, {}
        build, generate = common.build_pipeline, infer.generate

        def recording_build(*args, **kwargs):  # the LoRA as built: B at 0
            pipeline = build(*args, **kwargs)
            bare.update({k: p.detach().clone() for k, p in
                         lora_params(pipeline.transformer).items()})
            return pipeline

        def timed_generate(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(*args, **kwargs)
            torch.cuda.synchronize()
            call.update(args=args, kwargs=kwargs, images=out, s=time.perf_counter() - t0)
            return out

        _zero_counts(kernels)
        common.build_pipeline, infer.generate = recording_build, timed_generate
        try:
            infer.main(INFER_ARGV + ["--lora", os.path.join(path, "lora"),
                                     "--out_dir", os.path.join(work, "infer")])
        finally:
            common.build_pipeline, infer.generate = build, generate
        infer_counts = [k.launches for k in kernels[:3]]
    pipeline, config = call["args"][0], call["args"][3]
    want = [c * int(config.sample.eval_num_steps) for c in per_forward_counts(pipeline.mmdit_cfg)]
    ema = {k[len("ema/"):]: v for k, v in snap["state"][0].items() if k.startswith("ema/")}
    merge_lora_params(pipeline.transformer, ema)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = generate(*call["args"], **call["kwargs"])
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    merge_lora_params(pipeline.transformer, bare)
    without = generate(*call["args"], **call["kwargs"])
    via_file = call["images"]
    same = torch.equal(via_file, direct)
    print(f"cli.infer --lora {os.path.basename(path)}/lora, eval_sd3_fast full width 512^2 "
          f"{config.sample.eval_num_steps} steps: {call['s']:.3f} s/image (the pipeline's "
          f"first generate), {direct_s:.3f} s/image warm; launches {infer_counts}; image "
          f"bitwise that with the saved EMA LoRA merged directly: {same}; max |difference| "
          f"from the image without the adapter {float((via_file - without).abs().max()):.4e}; "
          f"{smi}", flush=True)
    if infer_counts != want or not same or torch.equal(via_file, without):
        raise AssertionError(f"infer --lora: launches {infer_counts} (expected {want}), bitwise "
                             f"{same}, max |difference| from the directly merged adapter's "
                             f"{float((via_file - direct).abs().max()):.3e}")
    del pipeline, call, via_file, direct, without, snap
    gc.collect()
    torch.cuda.empty_cache()


def _check_dino_backbone(smi):
    """DINOv2-B/14 (random weights from the seed + 3) at 518^2 on the card
    against the same weights on the CPU, on the same preprocessed pixels of
    2 images: the tokens within 1e-4 relative L2; and the card's
    preprocessing (512 -> 518) against the CPU's, in uint8 levels."""
    import copy

    import numpy as np
    import torch

    from adv_grpo_torch.rewards.scorers import DINOScorer

    cpu = DINOScorer.random_init(torch.Generator().manual_seed(SEED + 3), "cpu")
    gpu = DINOScorer(copy.deepcopy(cpu.vision).to("cuda"))
    images = torch.from_numpy(np.random.default_rng(SEED + 4).uniform(
        -1, 1, (2, 3, 512, 512)).astype(np.float32))
    pix = cpu.preprocess(images)
    levels = ((gpu.preprocess(images).cpu() - pix).abs()
              * torch.tensor((0.229, 0.224, 0.225)).view(1, 3, 1, 1) * 255)
    with torch.no_grad():
        ref = cpu.vision(pix)["tokens"]
        got = gpu.vision(pix.cuda())["tokens"].cpu()
    err = _rel_l2(got, ref)
    print(f"DINOv2-B/14 at 518^2 ({tuple(got.shape)} tokens, fp32, TF32 off), card against "
          f"the CPU on the same pixels: relative L2 {err:.3e} (bound 1e-4); preprocessing "
          f"512 -> 518 on the card against the CPU: {int((levels > 0.5).sum())} of "
          f"{levels.numel()} values one or more uint8 levels apart (max "
          f"{float(levels.max()):.2f}); {smi}", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"DINOv2 backbone on the card: relative L2 {err:.3e}")


def _check_moved(what, module, start, backbone, backbone_start):
    """Every tensor of ``module`` moved and is finite, but for a bias whose
    last gradient is exactly zero (a hinge whose real and fake terms are
    active in equal shares gives its output bias none: Adam leaves it);
    every weight moved; every backbone tensor is bitwise unchanged."""
    import torch

    params = dict(module.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p.detach(), start[k])]
    idle = [k for k in still if k.endswith(".bias") and params[k].grad is not None
            and not params[k].grad.any()]
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    changed = [k for k, v in backbone.state_dict().items() if not torch.equal(v, backbone_start[k])]
    print(f"  {what}: {len(params) - len(still)} of {len(params)} tensors moved (unmoved, with "
          f"a zero gradient: {idle}), finite {finite}; {len(changed)} of {len(backbone_start)} "
          f"backbone tensors changed", flush=True)
    if set(still) - set(idle) or not finite or changed:
        raise AssertionError(f"{what}: unmoved {still}, finite {finite}, backbone changed "
                             f"{changed}")


def run_dino_slice(kernels, smi):
    """Phase: the DINO discriminators at full width. First the DINOv2-B/14
    backbone on the card against the CPU; then ``cli.train.main`` on
    DINO_ARGV (``dino_cotrain_sd3_patch_fast``: SD3.5-M, a random fp32
    DINOv2-B/14 with its head, CLIP-H for the eval reward) against
    reference PNGs it writes: epoch 0 a D-epoch, epoch 1 a G epoch (the
    periodic gate at d_times 2). Checks: the branches [1, 0] with finite
    d_loss, d_acc in [0, 1], finite loss and KL; the launch counts of #1-#5
    as derived from the config (one G epoch); the head moved and finite,
    every backbone tensor bitwise unchanged; on a fixed probe batch
    'image_similarity' bitwise unchanged and 'dino_cotrain' moved; the LoRA
    and its EMA moved. Then one ``eval_phase`` on 4 prompts: finite
    ``eval_reward_image_similarity`` in [-1, 1] and ``eval_reward_pickscore``,
    the launches of #1-#3 as derived. Then ``dino_cotrain_sd3_multi_fast``
    (DINO_MULTI_ARGV, layer 11) for one D-epoch: the heads and the fusion
    moved, the backbone did not, 'dino_multi_cotrain' in (0, 1). Prints the
    DINO scoring ms per batch of 16 (generated and reference images), the
    D-step ms per sampling batch (single and multi), s per epoch on each
    branch and the peak device memory."""
    import gc

    import numpy as np
    import torch

    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.rewards.registry import multi_score

    gc.collect()  # the co-train phase's trainer
    torch.cuda.empty_cache()
    _check_dino_backbone(smi)
    rng = np.random.default_rng(SEED + 5)
    probe = rng.uniform(-1, 1, (4, 3, 512, 512)).astype(np.float32)
    probe_refs = rng.uniform(-1, 1, (4, 1, 3, 512, 512)).astype(np.float32)
    prompts4 = TextPromptDataset("dataset/pickscore_small").prompts[:4]  # each has a PNG

    def probe_scores(ctx):  # ('image_similarity', live 'dino_cotrain') of the probe
        return (multi_score({"image_similarity": 1.0}, ctx)(
                    probe, prompts4, ref_images=probe_refs)[0]["avg"],
                multi_score({"dino_cotrain": 1.0}, ctx)(probe, prompts4)[0]["avg"])

    def on_build(trainer):  # the discriminator as built, and the probe's scores
        disc = trainer.disc
        hold.update(backbone={k: v.clone() for k, v in disc.backbone.state_dict().items()},
                    head={k: v.clone() for k, v in disc.params.state_dict().items()})
        if disc.kind != "dino_multi":
            hold.update(scores=probe_scores(trainer.reward_ctx))

    hold = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        counts, records, wall = _train_recorded(DINO_ARGV, work, kernels, hold, on_build)
    trainer, samples = hold["trainer"], hold["samples"]
    config, mcfg, nb = trainer.config, trainer.pipeline.mmdit_cfg, trainer.num_batches
    ctx, disc = trainer.reward_ctx, trainer.disc
    branches = [r["d_epoch"] for r in records]
    print(f"cli.train dino_cotrain_sd3_patch_fast full width (SD3.5-M 512^2, DINOv2-B/14 "
          f"518^2 fp32 random, CLIP-H/14 for the eval reward), {config.sample.num_steps}-step "
          f"rollouts of {samples['epoch_images'][0].shape[0]} images, {nb} sampling batches "
          f"an epoch, d_times {config.d_times}, {DINO_EPOCHS} epochs: {wall:.2f} s wall "
          f"(builds included); branches {branches}; launches {counts}; {smi}", flush=True)
    for r in records:
        keys = ["reward_avg"] + (["d_loss", "d_acc"] if r["d_epoch"] else
                                 ["loss", "approx_kl", "clipfrac"])
        print(f"  epoch {r['epoch']}: d_epoch={r['d_epoch']}, "
              + ", ".join(f"{k} {r[k]:.5g}" for k in keys), flush=True)
        if not all(np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"epoch {r['epoch']}: {r}")
        if r["d_epoch"] and not 0.0 <= r["d_acc"] <= 1.0:
            raise AssertionError(f"d_acc {r['d_acc']}")
    if branches != [1, 0]:
        raise AssertionError(f"DINO branches {branches}, expected [1, 0] at d_times 2")
    want, _ = expected_train_counts(config, mcfg, DINO_EPOCHS, 1)
    if counts != want:
        raise AssertionError(f"DINO launch counts {counts}, expected {want}")
    _check_moved("DINO head", disc.params, hold["head"], disc.backbone, hold["backbone"])
    sim, live = probe_scores(ctx)
    print(f"  probe: 'image_similarity' max change {np.abs(sim - hold['scores'][0]).max():.3e}, "
          f"'dino_cotrain' {np.abs(live - hold['scores'][1]).max():.3e}", flush=True)
    if not np.array_equal(sim, hold["scores"][0]) or np.array_equal(live, hold["scores"][1]):
        raise AssertionError("probe: image_similarity changed or dino_cotrain did not")
    lora, ema = trainer.state.lora, trainer.state.ema
    idle = {f"block_{mcfg.num_layers - 1}/attn/add_q_proj/lora_b"}
    unchanged = {k for k, p in lora.items() if torch.equal(p, hold["lora"][k])}
    ema_unchanged = {k for k, e in ema.items() if torch.equal(e, hold["ema"][k])}
    print(f"  LoRA: {len(lora) - len(unchanged)} of {len(lora)} tensors changed; EMA "
          f"{len(ema) - len(ema_unchanged)} changed; global step {trainer.state.global_step}",
          flush=True)
    if not unchanged <= idle or not ema_unchanged <= idle:
        raise AssertionError(f"LoRA unchanged {sorted(unchanged)}, EMA {sorted(ema_unchanged)}")

    # the eval phase on 4 prompts: image_similarity against the store's refs
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = trainer.eval_phase(prompts4)
    eval_s = time.perf_counter() - t0
    eval_counts = [k.launches for k in kernels]
    steps = int(config.sample.eval_num_steps)
    want_eval = [c * steps for c in per_forward_counts(mcfg)] + [0, 0]
    sim_e, ps_e = metrics["eval_reward_image_similarity"], metrics["eval_reward_pickscore"]
    print(f"  eval_phase, 4 prompts x {steps} steps: {eval_s:.2f} s; eval_reward_image_similarity "
          f"{sim_e:.7f}, eval_reward_pickscore {ps_e:.5f}; launches {eval_counts}", flush=True)
    # a mean of cosines, in [-1, 1] up to fp32 rounding (the random backbone's
    # CLS tokens nearly coincide, so it sits at 1)
    if not (np.isfinite(sim_e) and abs(sim_e) <= 1.0 + 1e-6 and np.isfinite(ps_e)):
        raise AssertionError(f"eval metrics {metrics}")
    if eval_counts != want_eval:
        raise AssertionError(f"eval launch counts {eval_counts}, expected {want_eval}")

    # DINO scoring of one sampling batch: generated and reference images
    images, refs, prompts = samples["last_images"], samples["last_refs"], samples["last_prompts"]
    refs = refs.reshape((-1,) + refs.shape[-3:])[:len(prompts)]
    score_ms = {}
    for what, batch in (("generated", images), ("reference", refs)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.reward_fn(batch, prompts)  # ends in a copy to the host
            times.append((time.perf_counter() - t0) * 1e3)
        score_ms[what] = sorted(times)[1]
    peak = torch.cuda.max_memory_allocated()
    d_s, g_s = hold["sample"][0] + hold["d"][0], hold["sample"][1] + hold["g"][0]
    d_step_ms = 1e3 * hold["d"][0] / nb
    del trainer, samples, ctx, disc, hold
    gc.collect()
    torch.cuda.empty_cache()

    # the multi-layer preset: one D-epoch at layer 11
    hold = {}
    with tempfile.TemporaryDirectory() as work:
        counts, records, wall = _train_recorded(DINO_MULTI_ARGV, work, kernels, hold, on_build)
    trainer = hold["trainer"]
    config, ctx = trainer.config, trainer.reward_ctx
    r = records[0]
    print(f"cli.train dino_cotrain_sd3_multi_fast full width (layers "
          f"{ctx.dino_multi.layer_ids}, temperature {ctx.dino_multi.temperature}), 1 epoch: "
          f"{wall:.2f} s wall (builds included); d_epoch {r['d_epoch']}, d_loss "
          f"{r.get('d_loss', float('nan')):.5f}, d_acc {r.get('d_acc', float('nan')):.3f}, "
          f"reward_dino_multi_cotrain {r['reward_dino_multi_cotrain']:.5f}; launches {counts}",
          flush=True)
    if (len(records) != 1 or r["d_epoch"] != 1 or not np.isfinite(r["d_loss"])
            or not 0.0 < r["reward_dino_multi_cotrain"] < 1.0):
        raise AssertionError(f"multi preset: {records}")
    if counts != expected_train_counts(config, trainer.pipeline.mmdit_cfg, 1, 0)[0]:
        raise AssertionError(f"multi preset launch counts {counts}")
    _check_moved("DINO multi heads + fusion", trainer.disc.params, hold["head"],
                 trainer.disc.backbone, hold["backbone"])
    after = multi_score({"dino_multi_cotrain": 1.0}, ctx)(probe, prompts4)[0]["avg"]
    if not ((after > 0) & (after < 1)).all():
        raise AssertionError(f"dino_multi_cotrain of the probe {after}")
    multi_ms = 1e3 * hold["d"][0] / trainer.num_batches
    peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"  DINO timings ({smi}): DINO scoring (patch reward) {score_ms['generated']:.1f} ms "
          f"per batch of {len(images)} generated images, {score_ms['reference']:.1f} ms of "
          f"{len(refs)} references; D-step {d_step_ms:.1f} ms per sampling batch (single head), "
          f"{multi_ms:.1f} ms (multi); s per epoch (sampling + update) D {d_s:.2f}, G {g_s:.2f}; "
          f"sampling {[round(t, 2) for t in hold['sample']]} s (multi); peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    del trainer, ctx, hold
    gc.collect()
    torch.cuda.empty_cache()


def hf_clip_state_dict(sd):
    """The port's CLIPTextEncoder state dict in HF CLIPTextModelWithProjection
    names (the tests write their CLIP files with it too)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("layers."):
            i, module, leaf = k[len("layers."):].split(".")
            out[f"text_model.encoder.layers.{i}.{HF_CLIP_LAYER.get(module, module)}.{leaf}"] = v
        elif k in ("token_embedding.weight", "position_embedding"):
            out[f"text_model.embeddings.{k.split('.')[0]}.weight"] = v
        elif k.startswith("final_layer_norm."):
            out["text_model." + k] = v
        else:
            out[k] = v  # text_projection.weight
    return out


def hf_t5_state_dict(sd):
    """The port's T5Encoder state dict in HF T5EncoderModel names (the
    embedding as shared.weight, the tied encoder.embed_tokens.weight left out
    as save_pretrained leaves it out; the tests write their T5 files with it
    too)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            i, module, leaf = k[len("blocks."):].split(".")
            out[f"encoder.block.{i}.layer.{HF_T5_LAYER[module]}.{leaf}"] = v
        elif k == "relative_attention_bias":
            out["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = v
        elif k == "final_ln.weight":
            out["encoder.final_layer_norm.weight"] = v
        else:
            out["shared.weight"] = v
    return out


def hf_umt5_state_dict(sd):
    """The port's T5Encoder state dict at ``per_layer_rel_bias=True`` in HF
    UMT5EncoderModel names: ``hf_t5_state_dict``'s, with every block's bias
    table in its own ``layer.0.SelfAttention`` (the tests write their UMT5
    files with it)."""
    tables = {k: v for k, v in sd.items() if k.endswith(".relative_attention_bias")}
    out = hf_t5_state_dict({k: v for k, v in sd.items() if k not in tables})
    for k, v in tables.items():
        out[f"encoder.block.{k.split('.')[1]}.layer.0.SelfAttention.relative_attention_bias"
            ".weight"] = v
    return out


def _frozen(sd):
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in ("lora_a", "lora_b")}


def hf_flux_state_dict(sd):
    """The port's FluxTransformer state dict in diffusers
    FluxTransformer2DModel names: the port keeps diffusers' names, so the
    frozen weights as they are, without the LoRA factors (a checkpoint holds
    none). The tests hold its names and shapes to the diffusers mirror's."""
    return _frozen(sd)


def hf_wan_state_dict(sd):
    """The port's WanTransformer state dict in diffusers
    WanTransformer3DModel names (the port's own, without the LoRA factors)."""
    return _frozen(sd)


def hf_wan_vae_state_dict(sd):
    """The port's WanVideoVAE state dict in diffusers AutoencoderKLWan names
    (the port's own: encoder, quant convs, decoder)."""
    return dict(sd)


HF_VIT_LAYER = {"norm1": "layer_norm1", "norm2": "layer_norm2", **HF_CLIP_LAYER}


def hf_clip_model_state_dict(sd):
    """The port's CLIPDualEncoder state dict in HF CLIPModel names (the
    PickScore checkpoint's layout), with the ``position_ids`` buffers older
    checkpoints carry; the patch Linear back to the bias-free Conv2d
    (D, 3, p, p)."""
    import torch

    out = hf_clip_state_dict({k[len("text_model."):]: v for k, v in sd.items()
                              if k.startswith("text_model.")})
    out["text_model.embeddings.position_ids"] = torch.arange(
        sd["text_model.position_embedding"].shape[0])[None]
    v = "vision_model."
    patch = sd[v + "patch_embed.weight"]
    p = int(round((patch.shape[1] // 3) ** 0.5))
    out.update({
        v + "embeddings.patch_embedding.weight": patch.reshape(-1, p, p, 3).permute(0, 3, 1, 2)
        .contiguous(),
        v + "embeddings.class_embedding": sd[v + "class_embedding"],
        v + "embeddings.position_embedding.weight": sd[v + "position_embedding"],
        v + "embeddings.position_ids": torch.arange(sd[v + "position_embedding"].shape[0])[None],
        "visual_projection.weight": sd[v + "visual_projection.weight"],
        "logit_scale": sd["logit_scale"]})
    for k, t in sd.items():
        if k.startswith(v + "layers."):
            i, module, leaf = k[len(v + "layers."):].split(".")
            out[f"{v}encoder.layers.{i}.{HF_VIT_LAYER[module]}.{leaf}"] = t
        elif k.startswith((v + "pre_layernorm.", v + "post_layernorm.")):
            out[k.replace("pre_layernorm", "pre_layrnorm")] = t
    return out


def hf_dinov2_state_dict(sd, layout, mask_token=True):
    """The port's DINOv2 VisionTransformer state dict in timm / original
    checkpoint names (``layout="timm"``: fused ``attn.qkv``,
    ``ls{1,2}.gamma``, ``mask_token`` (1, D)) or HF ``Dinov2Model`` names
    (``"hf"``: ``embeddings.mask_token``); the mask token is zeros, as no
    forward reads it; the patch Linear back to the Conv2d. A tower without
    LayerScale (BLIP's ViT) gets no ``ls`` tensors, and ``mask_token=False``
    leaves the mask token out."""
    import torch

    patch = sd["patch_embed.weight"]
    p = int(round((patch.shape[1] // 3) ** 0.5))
    conv = patch.reshape(-1, p, p, 3).permute(0, 3, 1, 2).contiguous()
    d = conv.shape[0]
    timm = layout == "timm"
    e = "" if timm else "embeddings."
    out = {e + "cls_token": sd["class_embedding"].reshape(1, 1, d),
           e + ("pos_embed" if timm else "position_embeddings"):
               sd["position_embedding"].reshape(1, -1, d),
           ("patch_embed.proj." if timm else e + "patch_embeddings.projection.") + "weight": conv,
           ("patch_embed.proj." if timm else e + "patch_embeddings.projection.") + "bias":
               sd["patch_embed.bias"],
           ("norm." if timm else "layernorm.") + "weight": sd["post_layernorm.weight"],
           ("norm." if timm else "layernorm.") + "bias": sd["post_layernorm.bias"]}
    names = {"norm1": "norm1", "norm2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
             "out_proj": "attn.proj" if timm else "attention.output.dense",
             "q_proj": "attention.attention.query", "k_proj": "attention.attention.key",
             "v_proj": "attention.attention.value"}
    if mask_token:
        out[e + "mask_token"] = torch.zeros(1, d, dtype=conv.dtype, device=conv.device)
    for i in range(sum(k.endswith(".norm1.weight") for k in sd)):
        s, b = f"layers.{i}.", f"blocks.{i}." if timm else f"encoder.layer.{i}."
        for leaf in ("weight", "bias"):
            for m, hf in names.items():
                if not (timm and m in ("q_proj", "k_proj", "v_proj")):
                    out[f"{b}{hf}.{leaf}"] = sd[f"{s}{m}.{leaf}"]
            if timm:
                out[f"{b}attn.qkv.{leaf}"] = torch.cat([sd[f"{s}{m}.{leaf}"] for m in (
                    "q_proj", "k_proj", "v_proj")])
        if s + "ls1" in sd:
            out[b + ("ls1.gamma" if timm else "layer_scale1.lambda1")] = sd[s + "ls1"]
            out[b + ("ls2.gamma" if timm else "layer_scale2.lambda1")] = sd[s + "ls2"]
    return out


def _patch_conv(patch):
    """A patch Linear weight (D, p*p*3), flattened (ph, pw, c), back to the
    Conv2d weight (D, 3, p, p)."""
    p = int(round((patch.shape[1] // 3) ** 0.5))
    return patch.reshape(-1, p, p, 3).permute(0, 3, 1, 2).contiguous()


def hf_siglip_state_dict(sd):
    """The port's SigLIPVisionTower state dict in HF ``SiglipVisionModel``
    names (``vision_model.*``): the patch Linear back to the Conv2d, the MAP
    head's q / k / v packed into ``attention.in_proj`` as
    ``nn.MultiheadAttention`` holds them."""
    import torch

    v = "vision_model."
    out = {v + "embeddings.patch_embedding.weight": _patch_conv(sd["patch_embed.weight"]),
           v + "embeddings.patch_embedding.bias": sd["patch_embed.bias"],
           v + "embeddings.position_embedding.weight": sd["position_embedding"],
           v + "head.probe": sd["head.probe"]}
    for leaf in ("weight", "bias"):
        out[f"{v}post_layernorm.{leaf}"] = sd[f"post_layernorm.{leaf}"]
        out[f"{v}head.attention.in_proj_{leaf}"] = torch.cat(
            [sd[f"head.{m}.{leaf}"] for m in ("q_proj", "k_proj", "v_proj")])
        for m, hf in (("out_proj", "attention.out_proj"), ("layernorm", "layernorm"),
                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[f"{v}head.{hf}.{leaf}"] = sd[f"head.{m}.{leaf}"]
    for k, t in sd.items():
        if k.startswith("layers."):
            i, module, leaf = k[len("layers."):].split(".")
            out[f"{v}encoder.layers.{i}.{HF_VIT_LAYER[module]}.{leaf}"] = t
    return out


HF_BLIP_MODULE = {"query": "self.query", "key": "self.key", "value": "self.value",
                  "out_dense": "output.dense", "out_ln": "output.LayerNorm",
                  "self_attn": "attention", "cross_attn": "crossattention",
                  "intermediate": "intermediate.dense", "output": "output.dense",
                  "output_ln": "output.LayerNorm"}


def hf_blip_text_state_dict(sd, prefix=""):
    """The port's BlipTextEncoder state dict in BLIP med-BERT / HF
    ``BlipTextModel`` names under ``prefix``, with the ``position_ids``
    buffer the ImageReward checkpoint carries."""
    import torch

    e = prefix + "embeddings."
    out = {e + "word_embeddings.weight": sd["word_embeddings.weight"],
           e + "position_embeddings.weight": sd["position_embeddings"],
           e + "position_ids": torch.arange(sd["position_embeddings"].shape[0])[None]}
    for leaf in ("weight", "bias"):
        out[f"{e}LayerNorm.{leaf}"] = sd[f"embeddings_ln.{leaf}"]
    for k, t in sd.items():
        if k.startswith("layers."):
            i, *path = k[len("layers."):].split(".")
            hf = ".".join(HF_BLIP_MODULE[m] for m in path[:-1])
            out[f"{prefix}encoder.layer.{i}.{hf}.{path[-1]}"] = t
    return out


def imagereward_pt_state_dict(sd):
    """The port's ImageRewardModel state dict in the ImageReward checkpoint's
    names: ``blip.visual_encoder`` (timm ViT, fused qkv),
    ``blip.text_encoder`` (the med-BERT) and ``mlp.layers.{0,2,4,6,7}``."""
    from adv_grpo_torch.models.convert import AESTHETIC_LAYERS

    out = {"blip.visual_encoder." + k: t for k, t in hf_dinov2_state_dict(
        {k[len("vision."):]: t for k, t in sd.items() if k.startswith("vision.")}, "timm",
        mask_token=False).items()}
    out.update(hf_blip_text_state_dict(
        {k[len("text."):]: t for k, t in sd.items() if k.startswith("text.")},
        "blip.text_encoder."))
    for name, i in AESTHETIC_LAYERS:  # ImageReward's head has the aesthetic head's layout
        for leaf in ("weight", "bias"):
            out[f"mlp.layers.{i}.{leaf}"] = sd[f"head.{name}.{leaf}"]
    return out


BERT_SPECIAL = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}


def write_bert_tokenizer(d, words, size=None):
    """A BERT tokenizer directory as ``BertTokenizer.save_pretrained`` writes
    ImageReward's (``bos_token`` [DEC] and the additional special token
    [ENC] added after the vocabulary): ``vocab.txt`` with bert-base-uncased's
    special ids (0, 100-103; ``[unusedN]`` filling 1-99), then ``words`` in
    order, filled with ``[unusedN]`` to ``size`` lines where given, and
    ``tokenizer_config.json`` with ``do_lower_case`` and the
    ``added_tokens_decoder``. Returns the vocabulary's size."""
    vocab = [BERT_SPECIAL.get(i) or f"[unused{i - 1}]" for i in range(104)]
    unused = 99
    seen = set(vocab)
    for w in words:
        if w not in seen:
            vocab.append(w)
            seen.add(w)
    while size is not None and len(vocab) < size:
        vocab.append(f"[unused{unused}]")
        unused += 1
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(w + "\n" for w in vocab))
    added = dict(BERT_SPECIAL)
    added.update({len(vocab): "[DEC]", len(vocab) + 1: "[ENC]"})
    config = {"added_tokens_decoder": {str(i): {
        "content": t, "lstrip": False, "normalized": False, "rstrip": False,
        "single_word": False, "special": True} for i, t in sorted(added.items())},
        "additional_special_tokens": ["[ENC]"], "bos_token": "[DEC]", "clean_up_tokenization_spaces":
        True, "cls_token": "[CLS]", "do_basic_tokenize": True, "do_lower_case": True,
        "mask_token": "[MASK]", "model_max_length": 512, "never_split": None, "pad_token": "[PAD]",
        "sep_token": "[SEP]", "strip_accents": None, "tokenize_chinese_chars": True,
        "tokenizer_class": "BertTokenizer", "unk_token": "[UNK]"}
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2)
    return len(vocab) + 2


class JudgeFixture:
    """A loopback ``http.server`` (a free port on 127.0.0.1, in a thread)
    that answers the remote judges' wire formats and records every request
    as (path, headers, body): ``/geneval`` (GenEval's pickle),
    ``/deqa`` and ``/unifiedreward`` (the pickle ``outputs``),
    ``/v1/chat/completions`` (sglang's JSON, ``Final Score: X``), and
    ``/flaky``, which answers 500 to its first ``fail`` requests, then as
    ``/deqa``, and ``/busy``, which answers them 503 with a lower-case
    ``retry-after: 1`` header; any other path 404. The answers are
    functions of the request (the JPEG / PNG sizes, the prompts), so a client that mixes requests up scores
    otherwise. ``with JudgeFixture() as judge:`` serves until the block
    ends; ``judge.url``."""

    def __init__(self, fail=0):
        import http.server
        import threading

        self.requests, self.fail = [], fail
        fixture = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                fixture.requests.append((self.path, dict(self.headers), body))
                status, out, kind = fixture.answer(self.path, body)
                self.send_response(status)
                if status == 503:
                    self.send_header("retry-after", "1")
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def answer(self, path, body):
        import pickle

        if path == "/v1/chat/completions":
            req = json.loads(body)
            url = req["messages"][0]["content"][0]["image_url"]["url"]
            text = f"The image is fine.\nFinal Score: {1 + len(url) % 4}.{len(url) % 10}"
            return 200, json.dumps({"choices": [{"message": {"content": text}}]}).encode(), \
                "application/json"
        if path in ("/flaky", "/busy") and sum(p == path for p, _, _ in self.requests) <= self.fail:
            return (500 if path == "/flaky" else 503), b"busy", "text/plain"
        if path not in ("/geneval", "/deqa", "/unifiedreward", "/flaky", "/busy"):
            return 404, b"not found", "text/plain"
        req = pickle.loads(body)
        sizes = [len(j) for j in req["images"]]
        if path == "/geneval":
            tags = [m.get("tag", "none") for m in req["meta_datas"]]
            groups = {t: [float(n % 2) for n, g in zip(sizes, tags) if g == t] for t in tags}
            out = {"scores": [n % 97 / 97 for n in sizes], "rewards": [n % 3 / 2 for n in sizes],
                   "strict_rewards": [float(n % 2 and req["only_strict"]) for n in sizes],
                   "group_rewards": groups, "group_strict_rewards": {
                       t: [1.0 - v for v in vals] for t, vals in groups.items()}}
        elif path == "/unifiedreward":
            out = {"outputs": [n % 5 + len(p) % 3 for n, p in zip(sizes, req["prompts"])]}
        else:  # /deqa, /flaky, /busy
            out = {"outputs": [n % 13 / 13 for n in sizes]}
        return 200, pickle.dumps(out), "application/octet-stream"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def precompiled_charsmap(mappings):
    """A SentencePiece ``precompiled_charsmap`` for {key: replacement}: the
    uint32 byte size of a darts-clone double array over the keys' UTF-8
    bytes (each node's children at ``base ^ byte``, a distinct base per node,
    a leaf's value, its replacement's offset, at ``base ^ 0`` with bit 31
    set), the array, then the replacements, each ended by NUL."""
    import struct

    keys = sorted(mappings, key=lambda k: k.encode("utf-8"))
    blob, root = b"", {}
    for k in keys:
        node = root
        for b in k.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = len(blob)
        blob += mappings[k].encode("utf-8") + b"\0"
    units, bases, used = {}, set(), {0}
    stack = [(root, 0)]
    while stack:
        node, pos = stack.pop()
        labels = sorted(b for b in node if b is not None)
        need = labels + ([0] if None in node else [])
        base = 1
        while base in bases or any(base ^ b in used for b in need):
            base += 1
        bases.add(base)
        used.update(base ^ b for b in need)
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10) | ((None in node) << 8)
        if None in node:
            units[base] = (1 << 31) | node[None]
        for b in labels:
            units[base ^ b] = b
            stack.append((node[b], base ^ b))
    size = max(b | 0xFF for b in bases) + 1
    return struct.pack(f"<I{size}I", 4 * size, *(units.get(i, 0) for i in range(size))) + blob


# a charsmap in the manner of T5's (nmt_nfkc): full-width ASCII, ligatures,
# the no-break space, whitespace controls to a space, other C0 controls dropped
T5_CHARSMAP = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
               "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl", "ﬃ": "ffi", "ﬄ": "ffl", "\xa0": " ",
               "\t": " ", "\n": " ", "\r": " ",
               **{chr(c): "" for c in range(1, 32) if chr(c) not in "\t\n\r"}}


def clip_vocab(words, n_merges):
    """A CLIP byte-pair vocabulary in the published layout: the 256 byte
    symbols, their 256 ``</w>`` forms, one token per merge, then
    ``<|startoftext|>`` and ``<|endoftext|>``. The merges build ``words``
    (byte-encoded) left to right, in the order given, then pair byte symbols
    as filler, up to ``n_merges``. Returns (vocab, merges)."""
    from adv_grpo_torch.data.tokenizers import _bytes_to_unicode

    syms = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(syms + [s + "</w>" for s in syms])}
    merges, seen = [], set()

    def add(a, b):
        if len(merges) < n_merges and (a, b) not in seen and a + b not in vocab:
            seen.add((a, b))
            merges.append((a, b))
            vocab[a + b] = len(vocab)

    enc = _bytes_to_unicode()
    for w in words:
        parts = [enc[b] for b in w.encode("utf-8")]
        parts[-1] += "</w>"
        cur = parts[0]
        for p in parts[1:]:
            add(cur, p)
            cur += p
    for a in syms:
        for b in syms + [s + "</w>" for s in syms]:
            add(a, b)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    return vocab, merges


def write_clip_tokenizer(d, vocab, merges, pad_token):
    """A CLIP tokenizer directory as SD3's ``tokenizer/`` (pad
    ``<|endoftext|>``) or ``tokenizer_2/`` (pad ``!``, itself an added
    token) holds it: ``vocab.json``, ``merges.txt`` under its ``#version``
    line, ``tokenizer_config.json`` and ``special_tokens_map.json``."""
    def added(content, normalized):
        return {"content": content, "lstrip": False, "normalized": normalized,
                "rstrip": False, "single_word": False, "special": True}

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    decoder = {str(vocab["<|startoftext|>"]): added("<|startoftext|>", True),
               str(vocab["<|endoftext|>"]): added("<|endoftext|>", False)}
    if pad_token != "<|endoftext|>":
        decoder[str(vocab[pad_token])] = added(pad_token, False)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"add_prefix_space": False, "added_tokens_decoder": decoder,
                   "bos_token": "<|startoftext|>", "clean_up_tokenization_spaces": True,
                   "do_lower_case": True, "eos_token": "<|endoftext|>", "errors": "replace",
                   "model_max_length": 77, "pad_token": pad_token,
                   "tokenizer_class": "CLIPTokenizer", "unk_token": "<|endoftext|>"}, f)
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": pad_token, "unk_token": "<|endoftext|>"}, f)


def t5_pieces(words, size):
    """A T5 unigram vocabulary of ``size`` pieces in the published layout:
    ``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2, then ``▁word`` for ``words``
    (scored by rank), the single characters of the words, filler pieces,
    and last the 100 ``<extra_id_N>``, N falling. Returns [[piece, score]]."""
    pieces = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    have = {p for p, _ in pieces}

    def add(piece, score):
        if piece not in have and len(pieces) < size - 100:
            have.add(piece)
            pieces.append([piece, score])

    add("▁", -2.0)
    for r, w in enumerate(words):
        add("▁" + w, -3.0 - r * 1e-3)
    for ch in sorted({c for w in words for c in w}):
        add(ch, -12.0)
        add("▁" + ch, -11.0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for lead in ("", "▁"):
        for a in letters:
            for b in letters:
                for c in letters:
                    add(lead + a + b + c, -14.0 - len(pieces) * 1e-6)
    return pieces + [[f"<extra_id_{i}>", 0.0] for i in range(99, -1, -1)]


def write_t5_tokenizer(d, pieces, charsmap):
    """A T5 ``tokenizer_3/`` directory in the published layout:
    ``tokenizer.json`` (the special and the 100 extra ids as added tokens; a
    ``Precompiled`` normaliser over ``charsmap`` and the collapse of space
    runs; ``WhitespaceSplit`` then ``Metaspace``; the Unigram model with
    ``<unk>`` 2; the ``$A </s>`` template) and ``tokenizer_config.json``."""
    import base64

    os.makedirs(d, exist_ok=True)
    special = {p for p, _ in pieces if p in ("<pad>", "</s>", "<unk>") or p.startswith("<extra_id_")}
    metaspace = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": p, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, (p, _) in enumerate(pieces) if p in special],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                precompiled_charsmap(charsmap)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"}, metaspace]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": pieces, "byte_fallback": False}}
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    extra = [p for p, _ in pieces if p.startswith("<extra_id_")]
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
                   "extra_ids": len(extra), "additional_special_tokens": extra[::-1],
                   "model_max_length": 512, "tokenizer_class": "T5Tokenizer"}, f)


def write_folder(d, sd, config, shards=1, stem="diffusion_pytorch_model"):
    """A diffusers / HF model folder ``d``: ``config.json`` and
    ``{stem}.safetensors``, or with ``shards`` > 1 the names cut in that many
    files ``{stem}-0000i-of-0000n.safetensors`` and their
    ``{stem}.safetensors.index.json``; written by the port's own
    safetensors writer."""
    from adv_grpo_torch.utils import safetensors_io

    os.makedirs(d)
    names = sorted(sd)
    if shards == 1:
        safetensors_io.save_file(sd, os.path.join(d, f"{stem}.safetensors"))
    else:
        cut = [names[i * len(names) // shards:(i + 1) * len(names) // shards]
               for i in range(shards)]
        files = [f"{stem}-{i + 1:05d}-of-{shards:05d}.safetensors" for i in range(shards)]
        for fname, keys in zip(files, cut):
            safetensors_io.save_file({k: sd[k] for k in keys}, os.path.join(d, fname))
        with open(os.path.join(d, f"{stem}.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": {k: fn for fn, ks in zip(files, cut)
                                                      for k in ks}}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)


def write_flux_dirs(root, transformer_sd, vae_sd, fcfg, vcfg, shards=1, vae_factors=True):
    """A Flux.1 diffusers directory under ``root``: ``transformer/``
    (``transformer_sd`` in FluxTransformer2DModel names, in its own dtype, in
    ``shards`` files) and ``vae/`` (``vae_sd``, the SD3-layout AutoencoderKL),
    with the config.json keys of Flux.1-dev's folders at ``fcfg`` / ``vcfg``;
    ``vae_factors=False`` leaves ``scaling_factor`` / ``shift_factor`` out of
    the VAE's."""
    write_folder(os.path.join(root, "transformer"), transformer_sd, {
        "_class_name": "FluxTransformer2DModel", "patch_size": 1,
        "in_channels": fcfg.in_channels, "num_layers": fcfg.num_double_layers,
        "num_single_layers": fcfg.num_single_layers,
        "attention_head_dim": fcfg.attention_head_dim,
        "num_attention_heads": fcfg.num_attention_heads,
        "joint_attention_dim": fcfg.joint_attention_dim,
        "pooled_projection_dim": fcfg.pooled_projection_dim,
        "guidance_embeds": fcfg.guidance_embeds, "axes_dims_rope": list(fcfg.rope_axes_dims)},
        shards)
    factors = ({"scaling_factor": vcfg.scaling_factor, "shift_factor": vcfg.shift_factor}
               if vae_factors else {})
    write_folder(os.path.join(root, "vae"), vae_sd, {
        "_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
        "latent_channels": vcfg.latent_channels,
        "block_out_channels": list(vcfg.block_out_channels),
        "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_num_groups,
        "use_quant_conv": False, "use_post_quant_conv": False, **factors})


def write_wan_dirs(root, transformer_sd, vae_sd, wcfg, vcfg, shards=1):
    """A Wan2.1 diffusers directory under ``root``: ``transformer/``
    (``transformer_sd`` in WanTransformer3DModel names, in its own dtype, in
    ``shards`` files) and ``vae/`` (``vae_sd``, AutoencoderKLWan, its latent
    statistics in config.json), with the config.json keys of
    Wan2.1-T2V-1.3B's folders at ``wcfg`` / ``vcfg``."""
    write_folder(os.path.join(root, "transformer"), transformer_sd, {
        "_class_name": "WanTransformer3DModel", "patch_size": list(wcfg.patch_size),
        "in_channels": wcfg.in_channels, "out_channels": wcfg.out_channels,
        "num_layers": wcfg.num_layers, "attention_head_dim": wcfg.attention_head_dim,
        "num_attention_heads": wcfg.num_attention_heads, "text_dim": wcfg.text_dim,
        "ffn_dim": wcfg.ffn_dim, "freq_dim": 256, "cross_attn_norm": wcfg.cross_attn_norm,
        "qk_norm": "rms_norm_across_heads", "eps": 1e-6, "added_kv_proj_dim": None,
        "image_dim": None, "rope_max_seq_len": 1024}, shards)
    write_folder(os.path.join(root, "vae"), vae_sd, {
        "_class_name": "AutoencoderKLWan", "base_dim": vcfg.base_dim, "z_dim": vcfg.z_dim,
        "dim_mult": list(vcfg.dim_mult), "num_res_blocks": vcfg.num_res_blocks,
        "attn_scales": list(vcfg.attn_scales),
        "temperal_downsample": list(vcfg.temperal_downsample), "dropout": 0.0,
        "latents_mean": list(vcfg.latents_mean), "latents_std": list(vcfg.latents_std)})


def _base_scaled_table(dim, max_size, base, device):
    """diffusers' persisted PatchEmbed table (get_2d_sincos_pos_embed: positions
    scaled by base / max_size; the column half first), (1, max_size^2, dim)
    in fp32, computed on the card in fp64."""
    import torch

    pos = torch.arange(max_size, dtype=torch.float64, device=device) * (base / max_size)
    omega = 1.0 / 10000 ** (torch.arange(dim // 4, dtype=torch.float64, device=device)
                            / (dim / 4))
    half = torch.cat([torch.sin(pos[:, None] * omega), torch.cos(pos[:, None] * omega)], 1)
    cols = half[None, :, :].expand(max_size, max_size, dim // 2)
    rows = half[:, None, :].expand(max_size, max_size, dim // 2)
    return torch.cat([cols, rows], dim=-1).reshape(1, max_size * max_size, dim).float()


def _write_sd3_dir(root, generator, mcfg, vcfg, clip_cfgs, t5cfg, device="cuda"):
    """An SD3 diffusers directory under ``root`` at the given configs (the
    loader phase: SD3.5-M, the SD3 VAE, CLIP-L and CLIP-G, T5-XXL cut to
    LOADER_T5_LAYERS layers), its weights from ``generator`` on ``device``
    (the port's initialiser: lecun-normal matrices, zero biases, unit norms):
    ``transformer/`` bf16 with its base-scaled table, ``vae/`` fp32 (encoder
    and decoder), ``text_encoder/`` and ``text_encoder_2/`` fp16,
    ``text_encoder_3/`` fp16 in two shards with an index; HF / diffusers
    names and config.json files. Returns {folder: state dict as written, on
    ``device``}."""
    import dataclasses

    import torch

    from adv_grpo_torch.models.clip_text import CLIPTextEncoder
    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.mmdit import MMDiT
    from adv_grpo_torch.models.t5 import T5Encoder
    from adv_grpo_torch.models.vae import AutoencoderKL
    from adv_grpo_torch.train.pipeline import _build

    def module_sd(cls, cfg, dtype):
        m = init_params_(_build(cls, cfg, device), generator)
        return {k: v.detach().to(dtype) for k, v in m.state_dict().items()}

    def write(sub, sd, config, shards=1):
        write_folder(os.path.join(root, sub), sd, config, shards, stem="model")

    sd = module_sd(MMDiT, dataclasses.replace(mcfg, dtype=torch.bfloat16), torch.bfloat16)
    base = mcfg.sample_size // mcfg.patch_size
    sd["pos_embed.pos_embed"] = _base_scaled_table(mcfg.hidden_dim, mcfg.pos_embed_max_size,
                                                   base, device).to(torch.bfloat16)
    written = {"transformer": sd}
    write("transformer", sd, {
        "_class_name": "SD3Transformer2DModel", "patch_size": mcfg.patch_size,
        "in_channels": mcfg.in_channels, "out_channels": mcfg.out_channels,
        "num_layers": mcfg.num_layers, "attention_head_dim": mcfg.attention_head_dim,
        "num_attention_heads": mcfg.num_attention_heads,
        "joint_attention_dim": mcfg.joint_attention_dim, "caption_projection_dim": 1536,
        "pooled_projection_dim": mcfg.pooled_projection_dim,
        "pos_embed_max_size": mcfg.pos_embed_max_size, "qk_norm": "rms_norm",
        "dual_attention_layers": list(mcfg.dual_attention_layers),
        "sample_size": mcfg.sample_size})
    written["vae"] = module_sd(AutoencoderKL, vcfg, torch.float32)
    write("vae", written["vae"], {
        "_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
        "latent_channels": vcfg.latent_channels,
        "block_out_channels": list(vcfg.block_out_channels),
        "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_num_groups,
        "scaling_factor": vcfg.scaling_factor, "shift_factor": vcfg.shift_factor,
        "use_quant_conv": False, "use_post_quant_conv": False})
    for sub, cfg in zip(("text_encoder", "text_encoder_2"), clip_cfgs):
        written[sub] = hf_clip_state_dict(module_sd(CLIPTextEncoder, cfg, torch.float16))
        write(sub, written[sub], {
            "architectures": ["CLIPTextModelWithProjection"], "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "projection_dim": cfg.projection_dim,
            "hidden_act": cfg.hidden_act, "max_position_embeddings": 77,
            "vocab_size": cfg.vocab_size, "bos_token_id": 49406,
            "eos_token_id": cfg.eos_token_id, "torch_dtype": "float16"})
    tcfg = dataclasses.replace(t5cfg, dtype=torch.float16)
    written["text_encoder_3"] = hf_t5_state_dict(module_sd(T5Encoder, tcfg, torch.float16))
    write("text_encoder_3", written["text_encoder_3"], {
        "architectures": ["T5EncoderModel"], "d_model": tcfg.d_model, "d_kv": tcfg.d_kv,
        "d_ff": tcfg.d_ff, "num_layers": tcfg.num_layers, "num_heads": tcfg.num_heads,
        "vocab_size": tcfg.vocab_size, "feed_forward_proj": "gated-gelu",
        "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
        "torch_dtype": "float16"}, shards=2)
    _write_sd3_tokenizers(root)
    return written


def _by_count(words):
    import collections

    return [w for w, _ in sorted(collections.Counter(words).items(),
                                 key=lambda kv: (-kv[1], kv[0]))]


def _write_sd3_tokenizers(root):
    """SD3's three tokenizers at the published id spaces, from the words of
    ``dataset/pickscore_small``'s prompts, most frequent first: CLIP's 49,408
    ids (``clip_vocab``: the 48,894 merges build the words, then filler
    pairs) in ``tokenizer/`` (pad ``<|endoftext|>``) and ``tokenizer_2/``
    (pad ``!``); T5's 32,100 pieces (``t5_pieces``, ``T5_CHARSMAP``) in
    ``tokenizer_3/``."""
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.data.tokenizers import clip_clean, clip_words

    prompts = (TextPromptDataset("dataset/pickscore_small").prompts
               + TextPromptDataset("dataset/pickscore_small", "test").prompts)
    vocab, merges = clip_vocab(_by_count(w for p in prompts for w in clip_words(clip_clean(p))),
                               48894)
    write_clip_tokenizer(os.path.join(root, "tokenizer"), vocab, merges, "<|endoftext|>")
    write_clip_tokenizer(os.path.join(root, "tokenizer_2"), vocab, merges, "!")
    write_t5_tokenizer(os.path.join(root, "tokenizer_3"),
                       t5_pieces(_by_count(w for p in prompts for w in p.split()), 32100),
                       T5_CHARSMAP)


def _write_scorer_dirs(work, generator):
    """The scorer checkpoints, random from ``generator`` on the card (the
    port's initialiser; DINOv2's LayerScale 0.1): PickScore CLIP-H/14 in HF
    ``CLIPModel`` names, fp32, with its ``position_ids`` buffers and a
    ``config.json``; DINOv2-B/14 at 518^2 in timm names with ``mask_token``
    and in HF ``Dinov2Model`` names with ``embeddings.mask_token``. Returns
    ({name: directory}, {name: the port's state dict as drawn, on the
    card})."""
    import torch

    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig, VisionTransformer
    from adv_grpo_torch.rewards.scorers import CLIPDualEncoder, random_init_
    from adv_grpo_torch.utils import safetensors_io

    tcfg, vcfg, dcfg = CLIPTextConfig.clip_h_text(), ViTConfig.clip_h(), ViTConfig.dinov2_base()
    clip = CLIPDualEncoder(tcfg, vcfg, device="meta").to_empty(device="cuda")
    vit = VisionTransformer(dcfg, device="meta").to_empty(device="cuda")
    drawn = {"pickscore": {k: v.detach() for k, v in
                           random_init_(clip, generator).state_dict().items()},
             "dinov2": {k: v.detach() for k, v in
                        random_init_(vit, generator, 0.1).state_dict().items()}}
    if drawn["pickscore"]["vision_model.patch_embed.bias"].any():
        raise AssertionError("CLIP's patch conv has no bias: the drawn bias must be zero")
    clip_json = {
        "architectures": ["CLIPModel"], "projection_dim": tcfg.projection_dim,
        "text_config": {"hidden_size": tcfg.hidden_size, "intermediate_size":
                        tcfg.intermediate_size, "num_hidden_layers": tcfg.num_layers,
                        "num_attention_heads": tcfg.num_heads, "hidden_act": tcfg.hidden_act,
                        "max_position_embeddings": tcfg.max_position_embeddings,
                        "vocab_size": tcfg.vocab_size},
        "vision_config": {"hidden_size": vcfg.hidden_size, "intermediate_size":
                          vcfg.intermediate_size, "num_hidden_layers": vcfg.num_layers,
                          "num_attention_heads": vcfg.num_heads, "image_size": vcfg.image_size,
                          "patch_size": vcfg.patch_size, "hidden_act": vcfg.hidden_act}}
    dino_json = {"architectures": ["Dinov2Model"], "hidden_size": dcfg.hidden_size,
                 "num_hidden_layers": dcfg.num_layers, "num_attention_heads": dcfg.num_heads,
                 "mlp_ratio": dcfg.intermediate_size // dcfg.hidden_size,
                 "image_size": dcfg.image_size, "patch_size": dcfg.patch_size,
                 "layer_norm_eps": dcfg.layer_norm_eps}
    dirs = {}
    for name, sd, config in (
            ("pickscore", hf_clip_model_state_dict(drawn["pickscore"]), clip_json),
            ("dinov2_timm", hf_dinov2_state_dict(drawn["dinov2"], "timm"), None),
            ("dinov2_hf", hf_dinov2_state_dict(drawn["dinov2"], "hf"), dino_json)):
        dirs[name] = os.path.join(work, name)
        os.makedirs(dirs[name])
        safetensors_io.save_file(sd, os.path.join(dirs[name], "model.safetensors"))
        if config is not None:
            with open(os.path.join(dirs[name], "config.json"), "w") as f:
                json.dump(config, f)
    del clip, vit
    torch.cuda.empty_cache()
    return dirs, drawn


def _bitwise_differ(got, want):
    """The names whose tensors differ bitwise, or are missing on either side."""
    import torch

    return sorted(set(got) ^ set(want)) + [k for k in want if k in got and not torch.equal(
        got[k].to(want[k].device), want[k])]


def _t5_weights_at_scale_(t5, generator):
    """Rescale a T5 drawn by ``init_params_`` so its attention scores are of
    order one, as in HF's T5 init and a trained T5 (the 1/sqrt(d_kv) the
    attention leaves out lives in q): q times d_kv^-1/2, and the bucket bias
    table drawn N(0, 1), of the scores' order, so that a lost bias shows.
    With lecun-normal q alone the scores reach tens, and bf16's spacing
    there is a good part of a logit."""
    import torch

    with torch.no_grad():
        for block in t5.blocks:
            block.q.weight.mul_(t5.cfg.d_kv ** -0.5)
        t5.relative_attention_bias.normal_(0.0, 1.0, generator=generator)
    return t5


def _check_encoders_on_card(smi):
    """A 2-layer full-width T5-XXL (weights at the scale of
    ``_t5_weights_at_scale_``, one of two prompts masked after 20 of its 77
    tokens by ``encode_with_length_mask``) and CLIP-G on the card against the
    same weights on the CPU in fp32 (relative L2 1e-4). Beside it the T5 in
    bf16, as it runs in the pipeline, against the CPU's fp32, within
    T5_BF16_BOUND; the same bf16 T5 with its bias table zeroed, and run
    without the mask, are read against the same reference and must land
    above the bound, so the bound tells a sound bf16 T5 from one that lost
    either. Returns the readings."""
    import copy

    import torch

    from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.t5 import T5Config, T5Encoder, encode_with_length_mask
    from adv_grpo_torch.train.pipeline import _build

    g = torch.Generator().manual_seed(SEED + 7)
    ids = torch.randint(2, 32000, (2, 77), generator=g)
    lengths = torch.tensor([77, 20])
    clip_ids = torch.randint(1, 49000, (2, 77), generator=g)
    clip_ids[:, -1] = 49407
    rows = {}
    for name, cls, cfg, x in (
            ("T5-XXL", T5Encoder, T5Config(num_layers=2, dtype=torch.float32), ids),
            ("CLIP-G", CLIPTextEncoder, CLIPTextConfig.clip_g(num_layers=2), clip_ids)):
        cpu = init_params_(_build(cls, cfg, "cpu"), g)
        if name == "T5-XXL":
            cpu = _t5_weights_at_scale_(cpu, g)
            forward = lambda m, x: encode_with_length_mask(m, x, lengths.to(x.device))  # noqa: E731
        else:
            forward = lambda m, x: torch.cat(m(x)[:2])  # noqa: E731
        gpu = _build(cls, cfg, "cuda")
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            ref = forward(cpu, x)
            err = _rel_l2(forward(gpu, x.cuda()).float().cpu(), ref)
            rows[name] = err
            print(f"{name} 2 layers full width: card fp32 against the CPU fp32, relative L2 "
                  f"{err:.3e} (bound 1e-4)", flush=True)
            if err > 1e-4:
                raise AssertionError(f"{name} on the card: relative L2 {err:.3e}")
            if name == "T5-XXL":
                bf = _build(cls, T5Config(num_layers=2), "cuda")
                bf.load_state_dict(cpu.state_dict())
                rows["T5-XXL bf16"] = _rel_l2(forward(bf, x.cuda()).float().cpu(), ref)
                no_bias = copy.deepcopy(bf)
                no_bias.relative_attention_bias.zero_()
                rows["T5-XXL bf16, bias lost"] = _rel_l2(
                    forward(no_bias, x.cuda()).float().cpu(), ref)
                keep = (torch.arange(77)[None] < lengths[:, None])[..., None]
                rows["T5-XXL bf16, mask lost"] = _rel_l2(
                    torch.where(keep, bf(x.cuda()).float().cpu(), 0.0), ref)
                print(f"  T5-XXL in bf16 (the pipeline's dtype) on the card against the CPU "
                      f"fp32: relative L2 {rows['T5-XXL bf16']:.3e} (bound {T5_BF16_BOUND}); "
                      f"with the bias table zeroed {rows['T5-XXL bf16, bias lost']:.3e}, "
                      f"without the mask {rows['T5-XXL bf16, mask lost']:.3e} (each must "
                      f"exceed the bound)", flush=True)
                if rows["T5-XXL bf16"] > T5_BF16_BOUND:
                    raise AssertionError(f"T5-XXL bf16 on the card: relative L2 "
                                         f"{rows['T5-XXL bf16']:.3e}")
                if min(rows["T5-XXL bf16, bias lost"],
                       rows["T5-XXL bf16, mask lost"]) <= T5_BF16_BOUND:
                    raise AssertionError(f"the T5 bf16 bound {T5_BF16_BOUND} does not tell a "
                                         f"lost bias or mask from a sound T5: {rows}")
                del bf, no_bias
        del cpu, gpu
    return rows


def run_loader_slice(kernels, smi):
    """Phase: the checkpoint loaders and tokenizers at full width, and the
    paper's co-trained runs started from files. Writes a full-width SD3.5-M
    diffusers directory from the seed (``_write_sd3_dir``, its tokenizers at
    the published id spaces too); checks ``preflight``'s parameter counts
    against the configs' on the meta device and ``load_sd3_pipeline(dir,
    lora_rank=32)`` on the card: every frozen tensor bitwise the file's,
    ``lora_a`` bitwise the numpy draws of ``sd3_lora_init``, ``lora_b``
    zero, the VAE (encoder too) bitwise. Writes the scorer checkpoints
    (``_write_scorer_dirs``) and loads each through ``build_reward_context``
    with ``PICKSCORE_DIR`` / ``DINOV2_DIR`` set: every tensor bitwise the
    drawn one. Then the encoders: a 2-layer full-width T5-XXL and CLIP-G
    against the CPU (``_check_encoders_on_card``); the host ms of the
    directory's three tokenizers over ENCODE_BATCH prompts; its CLIP-L /
    CLIP-G / 4-layer T5 through ``cli.common.load_real_text_encoder`` with
    its own tokenizers, the encode of ENCODE_BATCH prompts timed with them
    and with a full-depth (24-layer) T5-XXL built from the seed;
    ``cli.precompute_embeds`` of the dataset's train split from the
    directory, its first batch's rows bitwise a direct encode's at fp16. Then from the directory
    and the store: ``cli.infer.main`` at ``eval_sd3_fast`` (launches of
    #1-#3 as derived, a non-constant 512^2 PNG, s/image);
    ``cli.train.main`` for one epoch on TRAIN_ARGV, on COTRAIN_ARGV with
    ``PICKSCORE_DIR`` (the live tail and its frozen copy bitwise the file's
    last layer before the first D-step) and on DINO_ARGV with both scorer
    directories: launches of #1-#5 as ``expected_train_counts`` derives them
    from the branches taken, finite metrics (TRAIN_ARGV: the LoRA and its
    EMA moved from the loaded adapter). A RANDOM-INIT warning is an error
    in the phase, and no tokenizer package may be loaded after it. Prints
    bytes written, the write, preflight and load seconds, the tokenize and
    encode ms, each epoch's seconds, and the peak host and device memory."""
    import gc
    import resource
    import warnings

    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import common, infer, precompute_embeds, train
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.data.embed_store import EmbeddingStore
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adv_grpo_torch.models.lora import init_params_, jax_lora_path
    from adv_grpo_torch.models.mmdit import MMDiT, MMDiTConfig
    from adv_grpo_torch.models.t5 import T5Config, T5Encoder
    from adv_grpo_torch.models.vae import AutoencoderKL, VAEConfig
    from adv_grpo_torch.train.pipeline import _build

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    env = {k: os.environ.get(k) for k in ("PICKSCORE_DIR", "DINOV2_DIR")}
    with tempfile.TemporaryDirectory() as work, warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOM-INIT")
        root = os.path.join(work, "sd3")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcfg, vcfg = MMDiTConfig.sd35_medium(), VAEConfig.sd3()
        clip_cfgs = (CLIPTextConfig.clip_l(), CLIPTextConfig.clip_g())
        t5cfg = T5Config(num_layers=LOADER_T5_LAYERS)
        written = _write_sd3_dir(root, torch.Generator(device="cuda").manual_seed(SEED + 6),
                                 mcfg, vcfg, clip_cfgs, t5cfg)
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        sizes = {sub: _dir_bytes(os.path.join(root, sub))
                 for sub in list(written) + ["tokenizer", "tokenizer_2", "tokenizer_3"]}
        print(f"wrote a full-width SD3.5-M diffusers directory ({LOADER_T5_LAYERS}-layer T5-XXL) "
              f"in {write_s:.2f} s: {sum(sizes.values()):,} B ("
              + ", ".join(f"{k} {v:,}" for k, v in sizes.items()) + f"); {smi}", flush=True)

        t0 = time.perf_counter()
        report = convert.preflight(root)
        preflight_s = time.perf_counter() - t0
        meta = {"transformer": MMDiT(mcfg, device="meta"),
                "vae": AutoencoderKL(vcfg, device="meta"),
                "text_encoder": CLIPTextEncoder(clip_cfgs[0], device="meta"),
                "text_encoder_2": CLIPTextEncoder(clip_cfgs[1], device="meta"),
                "text_encoder_3": T5Encoder(t5cfg, device="meta")}
        want = {k: sum(p.numel() for p in m.parameters()) for k, m in meta.items()}
        got = {k: report[k]["params"] for k in want}
        print(f"preflight in {preflight_s:.2f} s: parameter counts {got} (the configs' on the "
              f"meta device {want}); pos_embed_base_size "
              f"{report['transformer']['pos_embed_base_size']}", flush=True)
        if got != want or report["transformer"]["pos_embed_base_size"] != \
                mcfg.sample_size // mcfg.patch_size:
            raise AssertionError(f"preflight {report}, expected counts {want}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = convert.load_sd3_pipeline(root, lora_rank=32, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = pipe.mmdit.state_dict()
        frozen = [k for k in written["transformer"] if k != "pos_embed.pos_embed"]
        differ = [k for k in frozen
                  if not torch.equal(state[k].to(written["transformer"][k].dtype),
                                     written["transformer"][k])]
        init = convert.sd3_lora_init(pipe.mmdit_cfg)
        lora_differ = [k for k, v in init.items() if not torch.equal(state[k].cpu(), v)]
        vstate = pipe.vae.state_dict()
        vae_differ = [k for k, v in written["vae"].items() if not torch.equal(vstate[k], v)]
        print(f"load_sd3_pipeline(lora_rank=32) on the card in {load_s:.2f} s: {len(frozen)} "
              f"frozen tensors bitwise the file's ({len(differ)} differ), {len(init)} LoRA "
              f"factors bitwise the numpy draws / zero ({len(lora_differ)} differ), "
              f"{len(vstate)} VAE tensors bitwise ({len(vae_differ)} differ); MMDiT "
              f"{pipe.mmdit_cfg.dtype}", flush=True)
        if differ or lora_differ or vae_differ or set(state) - set(frozen) - set(init):
            raise AssertionError(f"load: frozen {differ[:4]}, LoRA {lora_differ[:4]}, VAE "
                                 f"{vae_differ[:4]}")
        del pipe, state, vstate, written, init
        gc.collect()
        torch.cuda.empty_cache()

        # the scorer checkpoints, written from the seed and loaded from their files
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dirs, drawn = _write_scorer_dirs(work, torch.Generator(device="cuda").manual_seed(
            SEED + 9))
        torch.cuda.synchronize()
        scorer_write_s = time.perf_counter() - t0
        ps_config = common.apply_overrides(common.resolve_config("pickscore_cotrain_sd3_fast"),
                                           ["smoke_test=False", f"pretrained.model={root}"])
        loads = {}
        for name, env_name, reward in (("pickscore", "PICKSCORE_DIR", "pickscore"),
                                       ("dinov2_timm", "DINOV2_DIR", "image_similarity"),
                                       ("dinov2_hf", "DINOV2_DIR", "image_similarity")):
            os.environ[env_name] = dirs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx = common.build_reward_context(ps_config, {reward}, device="cuda")
            torch.cuda.synchronize()
            loaded = (ctx.pickscore.clip if name == "pickscore" else ctx.dino.vision).state_dict()
            bad = _bitwise_differ(loaded, drawn[name.split("_")[0]])
            loads[name] = (time.perf_counter() - t0, len(loaded), len(bad))
            if bad:
                raise AssertionError(f"{name} loaded from {dirs[name]}: {bad[:4]} differ")
            del ctx, loaded
            gc.collect()
            torch.cuda.empty_cache()
        # the file's last tune_layer vision layers: the live tail's start
        n_layers = 1 + max(int(k.split(".")[2]) for k in drawn["pickscore"]
                                              if k.startswith("vision_model.layers."))
        first = range(n_layers)[int(ps_config.tune_layer):][0]
        tail_start = {f"{int(k.split('.')[2]) - first}.{k.split('.', 3)[3]}": v
                      for k, v in drawn["pickscore"].items()
                      if k.startswith("vision_model.layers.") and int(k.split(".")[2]) >= first}
        del drawn
        scorer_bytes = {k: _dir_bytes(v) for k, v in dirs.items()}
        print(f"scorer checkpoints written in {scorer_write_s:.2f} s: "
              + ", ".join(f"{k} {v:,} B" for k, v in scorer_bytes.items())
              + "; loaded through build_reward_context: " + ", ".join(
                  f"{k} {s:.2f} s ({n} tensors, {d} differ bitwise)"
                  for k, (s, n, d) in loads.items()) + f"; {smi}", flush=True)

        enc_rows = _check_encoders_on_card(smi)
        config = common.apply_overrides(common.resolve_config("smoke_sd3_fast"),
                                        [f"pretrained.model={root}"])
        holder = type("Pipeline", (), {"text_seq_len": 154, "device": torch.device("cuda")})()
        # the store holds the train split, which every run of the phase samples
        uniq = list(dict.fromkeys([""] + TextPromptDataset("dataset/pickscore_small").prompts))
        batch = uniq[1:ENCODE_BATCH + 1]
        tok_ms = {}
        for name, tok in zip(("tokenizer/", "tokenizer_2/", "tokenizer_3/"),
                             common.sd3_tokenizers(root, 77)):
            t0 = time.perf_counter()
            first_ids = tok(batch)  # a fresh tokenizer: nothing cached
            cold = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for _ in range(3):
                tok(batch)
            tok_ms[name] = (cold, (time.perf_counter() - t0) / 3 * 1e3, first_ids.shape)
        t0 = time.perf_counter()
        encode = common.load_real_text_encoder(config, holder)
        enc_load_s = time.perf_counter() - t0

        def encode_ms(fn):
            fn(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                e, p = fn(batch)
            return (time.perf_counter() - t0) / 3 * 1e3, e, p

        ms_dir, e, p = encode_ms(encode)
        if e.shape != (ENCODE_BATCH, 154, 4096) or p.shape != (ENCODE_BATCH, 2048) or \
                not (np.isfinite(e).all() and np.isfinite(p).all()):
            raise AssertionError(f"encode: {e.shape}, {p.shape}")
        # the full-depth T5-XXL, built from the seed beside the directory's CLIPs
        clip_l, clip_g, _ = common.load_sd3_text_encoders(root, "cuda")
        t5 = init_params_(_build(T5Encoder, T5Config(), "cuda"),
                          torch.Generator(device="cuda").manual_seed(SEED + 8))
        ms_full, e24, _ = encode_ms(common.make_sd3_encode(
            (clip_l, clip_g, t5), common.sd3_tokenizers(root, 77), "cuda"))
        del clip_l, clip_g, t5
        gc.collect()
        torch.cuda.empty_cache()
        store = os.path.join(work, "store")
        t0 = time.perf_counter()
        precompute_embeds.main(["--config", "smoke_sd3_fast", "--set", f"pretrained.model={root}",
                                "--set", "dataset=dataset/pickscore_small", "--set",
                                "smoke_test=False", "--splits", "train", "--batch",
                                str(ENCODE_BATCH), "--out", store, "--device", "cuda"])
        store_s = time.perf_counter() - t0
        direct_e, direct_p = encode(uniq[:ENCODE_BATCH])
        se, sp = EmbeddingStore(store)(uniq[:ENCODE_BATCH])
        same = (np.array_equal(se, direct_e.astype(np.float16).astype(np.float32))
                and np.array_equal(sp, direct_p.astype(np.float16).astype(np.float32)))
        print("the directory's tokenizers, host ms over " f"{ENCODE_BATCH} prompts (a fresh "
              "tokenizer, then warm): " + ", ".join(
                  f"{k} {c:.1f} / {w:.1f} ({s[1]} ids)" for k, (c, w, s) in tok_ms.items())
              + f"; text encoders (CLIP-L, CLIP-G fp32; T5-XXL bf16) loaded in {enc_load_s:.2f} "
              f"s; encode of {ENCODE_BATCH} prompts (77 + 77 tokens, the directory's tokenizers "
              f"included): {ms_dir:.1f} ms with its {LOADER_T5_LAYERS}-layer T5, {ms_full:.1f} ms "
              f"with a full-depth 24-layer T5-XXL (finite {bool(np.isfinite(e24).all())}); "
              f"cli.precompute_embeds of {len(uniq)} prompts in {store_s:.2f} s (the pipeline's "
              f"load included), its first batch's rows bitwise a direct encode's at fp16: "
              f"{same}; {smi}", flush=True)
        if not same or not np.isfinite(e24).all():
            raise AssertionError(f"store rows equal {same}; full-depth encode finite "
                                 f"{bool(np.isfinite(e24).all())}")
        del encode
        gc.collect()
        torch.cuda.empty_cache()

        # the main path from the directory and the store: sampling, then one epoch
        call = {}
        generate = infer.generate

        def timed_generate(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(*args, **kwargs)
            torch.cuda.synchronize()
            call.update(s=time.perf_counter() - t0, n=len(args[2]))
            return out

        _zero_counts(kernels)
        infer.generate = timed_generate
        try:
            paths = infer.main(INFER_ARGV[:3] + [uniq[1]] + [
                "--set", f"pretrained.model={root}", "--set", f"text_embeds_dir={store}",
                "--out_dir", os.path.join(work, "infer")])
        finally:
            infer.generate = generate
        infer_counts = [k.launches for k in kernels[:3]]
        img = np.asarray(Image.open(paths[0]))
        want_infer = [c * STEPS for c in per_forward_counts(mcfg)]
        print(f"cli.infer eval_sd3_fast from the directory and the store, 512^2 {STEPS} steps: "
              f"{call['s'] / call['n']:.3f} s/image (the pipeline's first generate); PNG "
              f"{img.shape}, pixel range {img.min()}..{img.max()}; launches {infer_counts} "
              f"(expected {want_infer})", flush=True)
        if infer_counts != want_infer or img.shape != (512, 512, 3) or img.min() == img.max():
            raise AssertionError(f"infer from the directory: launches {infer_counts}, PNG "
                                 f"{img.shape} {img.min()}..{img.max()}")

        _zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train.main(TRAIN_ARGV + [
            "--max_epochs", "1", "--set", f"pretrained.model={root}",
            "--set", f"text_embeds_dir={store}", "--set", f"save_dir={os.path.join(work, 'run')}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        with open(os.path.join(work, "run", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        want_train = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg,
                                           epochs=1)[0]
        start = {jax_lora_path(k): v.cuda()
                 for k, v in convert.sd3_lora_init(trainer.pipeline.mmdit_cfg).items()}
        idle = {f"block_{mcfg.num_layers - 1}/attn/add_q_proj/lora_b"}
        lora, ema = trainer.state.lora, trainer.state.ema
        unchanged = {k for k, v in lora.items() if torch.equal(v, start[k])}
        ema_unchanged = {k for k, v in ema.items() if torch.equal(v, start[k])}
        finite = [k for k in ("reward_avg", "loss", "approx_kl", "clipfrac")
                  if np.isfinite(records[0][k])]
        print(f"cli.train smoke_sd3_fast from the directory and the store, 1 epoch: {wall:.2f} "
              f"s wall (build included); launches {counts} (expected {want_train}); LoRA "
              f"{len(lora) - len(unchanged)} of {len(lora)} tensors moved from the loaded "
              f"adapter, EMA {len(ema) - len(ema_unchanged)}; reward "
              f"{records[0]['reward_avg']:.5f}, loss {records[0]['loss']:.3e}", flush=True)
        if (counts != want_train or len(records) != 1 or len(finite) != 4
                or not unchanged <= idle or not ema_unchanged <= idle):
            raise AssertionError(f"train from the directory: launches {counts}, {len(records)} "
                                 f"records, finite {finite}, unchanged {sorted(unchanged)[:4]}, "
                                 f"EMA unchanged {sorted(ema_unchanged)[:4]}")
        del trainer, lora, ema, start
        gc.collect()
        torch.cuda.empty_cache()

        # the paper's main path and its headline config, from the files
        from_files = ["--max_epochs", "1", "--set", f"pretrained.model={root}",
                      "--set", f"text_embeds_dir={store}"]
        os.environ["PICKSCORE_DIR"], os.environ["DINOV2_DIR"] = dirs["pickscore"], \
            dirs["dinov2_timm"]
        epochs = {}
        for name, argv in (("pickscore_cotrain_sd3_fast", COTRAIN_ARGV),
                           ("dino_cotrain_sd3_patch_fast", DINO_ARGV)):
            hold, tail_bad = {}, []

            def on_build(trainer):
                if trainer.disc.kind == "pickscore":  # the tails as built, before any D-step
                    ctx = trainer.reward_ctx
                    for tail in (ctx.pickscore_params, ctx.pickscore_frozen_params):
                        tail_bad.extend(_bitwise_differ(tail.state_dict(), tail_start))

            run_dir = os.path.join(work, name)
            os.makedirs(run_dir)
            counts, records, wall = _train_recorded(argv + from_files, run_dir, kernels, hold,
                                                    on_build)
            trainer = hold["trainer"]
            branches = [r["d_epoch"] for r in records]
            want_run = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg, 1,
                                             branches.count(0))[0]
            keys = ["reward_avg"] + (["d_loss", "d_acc"] if branches[0] else
                                     ["loss", "approx_kl", "clipfrac"])
            epochs[name] = round(wall, 2)
            print(f"cli.train {name} from the directory, the store and "
                  f"{'PICKSCORE_DIR' if 'pickscore' in name else 'PICKSCORE_DIR and DINOV2_DIR'}"
                  f", 1 epoch: {wall:.2f} s wall (build included), sampling "
                  f"{[round(t, 2) for t in hold['sample']]} s, D {[round(t, 2) for t in hold['d']]}"
                  f" s, G {[round(t, 2) for t in hold['g']]} s; branch d_epoch={branches}; "
                  f"launches {counts} (expected {want_run}); "
                  + ", ".join(f"{k} {records[0][k]:.5g}" for k in keys)
                  + (f"; the live tail and its frozen copy bitwise the file's last layer "
                     f"({len(tail_bad)} differ)" if "pickscore" in name else "")
                  + f"; {smi}", flush=True)
            if (counts != want_run or len(records) != 1 or tail_bad
                    or not all(np.isfinite(records[0][k]) for k in keys)):
                raise AssertionError(f"{name} from files: launches {counts} (expected "
                                     f"{want_run}), records {records}, tail {tail_bad[:4]}")
            del trainer, hold
            gc.collect()
            torch.cuda.empty_cache()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    leaked = [m for m in ("transformers", "tokenizers", "regex", "ftfy", "sentencepiece")
              if m in sys.modules]
    peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"loader phase: {time.perf_counter() - phase_t0:.1f} s of wall time (the co-train "
          f"epochs from the files {epochs} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, the process's peak host "
          f"RSS {peak_host:.2f} GiB; card against CPU "
          f"{ {k: float(f'{v:.3e}') for k, v in enc_rows.items()} }; tokenizer packages "
          f"loaded: {leaked}; {smi}", flush=True)
    if leaked:
        raise AssertionError(f"the phase loaded {leaked}")


def flux_per_forward_counts(fcfg):
    """Kernel launches of one Flux forward: (modulated LN, per-head RMS, joint
    attention, BSHD attention). A double block: 4 LNs (attention and MLP of
    both streams), 4 qk-norms, 1 joint attention; a single block: 1 LN, 2
    qk-norms, 1 attention; the output head: 1 LN."""
    n2, n1 = fcfg.num_double_layers, fcfg.num_single_layers
    return 4 * n2 + n1 + 1, 4 * n2 + 2 * n1, n2, n1


def flux_per_recompute_counts(fcfg):
    """Launches of the blocks' recompute in one Flux backward under remat
    (every block's forward kernels again, ``models/remat.py``): a forward's
    but the output head's LN; none without remat."""
    if not fcfg.remat:
        return 0, 0, 0, 0
    ln, rms, joint, bshd = flux_per_forward_counts(fcfg)
    return ln - 1, rms, joint, bshd


def check_flux_kernels():
    """Phase: the Flux kernels against their plain versions at the
    Flux.1-dev 512^2 shapes (1024 image + 512 text tokens, 24 heads of 128,
    width 3072), with median times beside the plain version's and one
    PyTorch library call's."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import attention, fused_norms, joint_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    heads, d, s_img, s_txt = 24, 128, 1024, 512
    dim, s = heads * d, s_img + s_txt

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    results = []
    # 7: per-head RMS (Flux qk-norm, d = 128; the main shape, timed) and one
    # head across the row (WAN's 5120 wide); bound: 1 bf16 ulp of the fp32
    # result
    worst, max_err = 0.0, 0.0
    for shape, nh in (((1, s, dim), heads), ((1, 1560, 5120), 1)):
        x = randn(*shape) + 0.3
        w = (1.0 + 0.1 * torch.randn(shape[-1] // nh, generator=g, device=dev)).float()
        y = fused_norms.rms_norm_heads(x, w, num_heads=nh)
        ref = fused_norms.rms_reference(x.float(), w, nh, 1e-6, torch.float32)
        err = (y.float() - ref).abs()
        worst = max(worst, (err / _bf16_ulp(ref)).max().item())
        max_err = max(max_err, err.max().item())
        med = _median_ms(lambda: fused_norms.rms_norm_heads(x, w, num_heads=nh))
        print(f"  rms_norm_heads {shape} {nh} head(s): median {med:.4f} ms", flush=True)
        if nh == heads:
            ms, main = med, (x, w)
            plain_ms = _median_ms(lambda: fused_norms.rms_reference(x, w, heads, 1e-6,
                                                                    torch.bfloat16))
            x4, wb = x.view(1, s, heads, d), w.to(torch.bfloat16)
            lib_ms = _median_ms(lambda: F.rms_norm(x4, (d,), wb, 1e-6))
    print(f"kernel rms_norm_heads: max_abs_err {max_err:.3e}, max err {worst:.2f} bf16 ulp "
          f"(bound 1 ulp of the fp32 result); (1,1536,3072) 24x128 median {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms vs F.rms_norm {lib_ms:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"rms_norm_heads off by {worst} ulp")
    x, w = main
    results.append(_entry("rms_norm_heads", "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:127", max_err, ms, plain_ms,
                          _bound(_nbytes(x, w, x), 4.0 * x.numel(), FP32_FLOPS), lib_ms))

    # 8: BSHD attention of the single blocks (B=1 the main shape, timed);
    # bound 2e-2 absolute (the bf16 bound of the TPU kernels' own tests),
    # the lse too
    err = 0.0
    for b, n, kv_len in ((1, s, None), (4, s, None), (1, 4608, 4600)):
        q, k, v = (randn(b, n, dim) for _ in range(3))
        o, lse = attention.mha_bshd_fwd(q, k, v, heads, d ** -0.5, kv_len, want_lse=True)
        ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(),
                                                    num_heads=heads, kv_len=kv_len,
                                                    return_lse=True)
        e = max((o.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        if b == 1 and kv_len is None:  # scaling the fp32 scores must not make it larger
            old = _prescaled_q_err(q, k, v, heads, ref, ref_lse)
            print(f"  #8 score scaling at (1,1536,3072): max abs err {e:.3e} (output and lse); "
                  f"the pre-scaled-q order (q rounded to bf16) on the same inputs {old:.3e}",
                  flush=True)
            if not e <= old:
                raise AssertionError(f"mha_bshd (1,1536,3072) error {e} grew past the "
                                     f"pre-scaled-q order's {old} on the same inputs")
        del ref, ref_lse
        err = max(err, e)
        med = _median_ms(lambda: attention.mha_bshd(q, k, v, num_heads=heads, kv_len=kv_len))
        print(f"  mha_bshd B={b} S={n} kv_len={kv_len}: max abs err {e:.3e} (output and "
              f"lse); median {med:.4f} ms", flush=True)
        if b == 1 and kv_len is None:
            ms, main = med, (q, k, v)
            plain_ms = _median_ms(lambda: attention.mha_bshd_reference(q, k, v,
                                                                        num_heads=heads))
            q4, k4, v4 = (attention.to_bhsd(t, heads) for t in (q, k, v))
            lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    print(f"kernel mha_bshd: max_abs_err {err:.3e} (bound 2e-2); (1,1536,3072) 24x128 median "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA {lib_ms:.4f} ms", flush=True)
    if not err <= 2e-2:
        raise AssertionError(f"mha_bshd error {err}")
    q, k, v = main
    results.append(_entry("mha_bshd", FWD_SM90_SOURCE,
                          "adv_grpo_tpu/ops/attention.py:346", err, ms, plain_ms,
                          _attn_bound((q, k, v, q), 1, heads, s, s, d), lib_ms))

    # 2 at head width 128, no RMS (Flux's double blocks), B = 1 (timed) and 4
    errs = check_joint_cases([c for c in JOINT_CASES if c[0].startswith("flux")])
    streams, _ = joint_inputs(JOINT_CASES[4])
    qi, ki, vi, qt, kt, vt = streams
    ms = _median_ms(lambda: joint_attention.joint_mha(*streams, num_heads=heads))
    plain_ms = _median_ms(lambda: joint_attention.joint_mha_reference(*streams, num_heads=heads))
    cat4 = [attention.to_bhsd(torch.cat([a, c], dim=1), heads)
            for a, c in ((qi, qt), (ki, kt), (vi, vt))]
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(*cat4))
    err = max(e for e, _ in errs.values())
    print(f"kernel joint_mha (d=128, no RMS): max_abs_err {err:.3e} (bound 2e-2) at B=1 and 4; "
          f"img 1024 + txt 512, 24x128, B=1 median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"SDPA on the concatenated streams {lib_ms:.4f} ms", flush=True)
    results.append(_entry("joint_mha_d128", FWD_SM90_SOURCE,
                          "adv_grpo_tpu/ops/joint_attention.py:73", err, ms, plain_ms,
                          _attn_bound(streams + [qi, qt], 1, heads, s, s, d), lib_ms))
    del streams, qi, ki, vi, qt, kt, vt, cat4

    # 1 at Flux's width D = 3072 (image and text streams)
    worst = 0.0
    for n in (s_img, s_txt):
        x = randn(1, n, dim) + randn(1, 1, dim)
        mods = randn(1, 6 * dim, scale=0.5)
        sc, sh = mods[:, dim:2 * dim], mods[:, :dim]  # strided chunks, as from AdaLN
        y = fused_norms.modulated_layer_norm(x, sc, sh)
        ref = fused_norms.lnmod_reference(x.float(), sc.float(), sh.float(), 1e-6,
                                          torch.float32)
        worst = max(worst, ((y.float() - ref).abs() / _bf16_ulp(ref)).max().item())
    ms = _median_ms(lambda: fused_norms.modulated_layer_norm(x, sc, sh))
    print(f"kernel modulated_layer_norm at D=3072: max err {worst:.2f} bf16 ulp (bound 1); "
          f"(1,512,3072) median {ms:.4f} ms", flush=True)
    if worst > 1.0:
        raise AssertionError(f"modulated_layer_norm at D=3072 off by {worst} ulp")
    return results


def check_flux_backward_kernels():
    """Phase: the attention backward kernels of Flux training against their
    plain twins (on the same inputs, lse and di) at the Flux.1-dev 512^2
    shapes: the BSHD backward (#9) at B = 1, S = 1536 (timed) and at 4608
    tokens with kv_len 4600; the joint backward (#4) at head width 128
    without RMS, 1024 + 512 tokens. Bound: relative L2 2e-2 per cotangent,
    the bf16 rounding of p and t. Median times beside the plain twin's and
    the SDPA backward's (one ``autograd.grad`` through a retained graph of
    ``scaled_dot_product_attention``; the port never calls it)."""
    import torch

    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops import joint_attention as ja
    from adv_grpo_torch.ops.attention import bwd_row_stats

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    heads, d, s_img, s_txt = 24, 128, 1024, 512
    dim, s = heads * d, s_img + s_txt
    sm_scale = d ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    results, max_abs = [], 0.0
    for n, kv_len in ((s, None), (4608, 4600)):
        q, k, v, do = (randn(1, n, dim) for _ in range(4))
        o, lse = attention.mha_bshd_fwd(q, k, v, heads, sm_scale, kv_len, want_lse=True)
        di = bwd_row_stats(o, do, heads)
        got = attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads, kv_len=kv_len)
        twin = attention.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                            di, num_heads=heads, kv_len=kv_len)
        max_abs = max(max_abs, _check_rel_l2(
            f"mha_bshd_bwd B=1 S={n} kv_len={kv_len} kernel vs its plain twin (dq, dk, dv)",
            got, twin))
        del twin
        if kv_len is None:
            ms = _median_ms(lambda: attention.mha_bshd_bwd(q, k, v, do, lse, di,
                                                           num_heads=heads))
            plain_ms = _median_ms(lambda: attention.bshd_bwd_reference(
                q, k, v, do, lse, di, num_heads=heads), iters=5)
            lib_ms = _sdpa_bwd_ms(q, k, v, do, heads)
            least = _attn_bound((q, k, v, do, lse, di) + tuple(got), 1, heads, s, s, d,
                                products=5)
    print(f"kernel mha_bshd_bwd: (1,1536,3072) 24x128 median {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms vs SDPA backward {lib_ms:.4f} ms; bound {least[0]:.4f} ms",
          flush=True)
    results.append(_entry("mha_bshd_bwd", BWD_SM90_SOURCE,
                          "adv_grpo_tpu/ops/attention.py:395", max_abs, ms, plain_ms, least,
                          lib_ms))

    streams = [randn(1, s_img, dim) for _ in range(3)] + [randn(1, s_txt, dim)
                                                          for _ in range(3)]
    do = [randn(1, s_img, dim), randn(1, s_txt, dim)]
    oi, ot, lse_i, lse_t = ja.joint_attention_fwd(*streams, None, heads, 1e-6, sm_scale, True)
    lse, di = [lse_i, lse_t], [bwd_row_stats(oi, do[0], heads), bwd_row_stats(ot, do[1], heads)]
    got = ja.joint_attention_bwd(*streams, *do, *lse, *di, num_heads=heads)
    _check_prepass(ja, streams[0::3], streams[1::3], heads, None)
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    twin = ja.attention_bwd_reference(f32(streams[0::3]), f32(streams[1::3]),
                                      f32(streams[2::3]), f32(do), lse, di, num_heads=heads)
    max_abs = _check_rel_l2("joint_attention_bwd d=128 kernel vs its plain twin (dyq, dyk, dv "
                            "per stream)", got, [a for st in twin for a in st])
    del twin
    ms = _median_ms(lambda: ja.joint_attention_bwd(*streams, *do, *lse, *di, num_heads=heads))
    plain_ms = _median_ms(lambda: ja.attention_bwd_reference(
        streams[0::3], streams[1::3], streams[2::3], do, lse, di, num_heads=heads), iters=5)
    cat = [torch.cat([a, c], dim=1) for a, c in zip(streams[:3], streams[3:])]
    lib_ms = _sdpa_bwd_ms(*cat, torch.cat(do, dim=1), heads)
    least = _attn_bound(tuple(streams) + tuple(do) + tuple(lse) + tuple(di) + tuple(got), 1,
                        heads, s, s, d, products=5)
    print(f"kernel joint_attention_bwd (d=128, no RMS): img 1024 + txt 512, 24x128, B=1 median "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA backward on the concatenated "
          f"streams {lib_ms:.4f} ms; bound {least[0]:.4f} ms", flush=True)
    results.append(_entry("joint_attention_bwd_d128", BWD_SM90_SOURCE,
                          "adv_grpo_tpu/ops/joint_attention.py:224", max_abs, ms, plain_ms, least,
                          lib_ms))
    return results


def check_flux_model():
    """Phase: a 1-double + 1-single block Flux.1-dev at full width on the
    card (bf16, kernels) against the same weights on the CPU (fp32, plain
    versions): a 16x16 packed grid, 64 text tokens, non-zero LoRA B, guidance
    embedded. Bound: relative L2 5e-2, bf16 rounding through 2 blocks."""
    import numpy as np
    import torch

    from adv_grpo_torch.models.flux import FluxConfig, FluxTransformer, make_latent_ids
    from adv_grpo_torch.models.lora import init_params_

    kw = dict(num_double_layers=1, num_single_layers=1, lora_rank=32, lora_alpha=64.0)
    g = torch.Generator().manual_seed(SEED)
    cpu = init_params_(FluxTransformer(FluxConfig.dev(dtype=torch.float32, **kw),
                                       device="cpu"), g)
    for name, p in cpu.named_parameters():
        if name.endswith("lora_b"):  # non-zero adapters, so LoRA is exercised
            p.data.normal_(0.0, 0.02, generator=g)
    gpu = FluxTransformer(FluxConfig.dev(**kw), device="meta").to_empty(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    lat = torch.randn(2, 256, 64, generator=g)
    t = torch.tensor([1000.0, 500.0])
    ctx = torch.randn(2, 64, 4096, generator=g) * 0.2
    pooled = torch.randn(2, 768, generator=g) * 0.2
    guidance = torch.tensor([3.5, 3.5])
    ids = (make_latent_ids(16, 16), np.zeros((64, 3), np.int32))
    with torch.inference_mode():
        ref = cpu(lat, t, ctx, pooled, *ids, guidance=guidance)
        out = gpu(*(a.cuda() for a in (lat, t, ctx, pooled)), *ids,
                  guidance=guidance.cuda()).float().cpu()
    rel = _rel_l2(out, ref)
    print(f"model check: 1-double + 1-single full-width Flux.1-dev, card bf16 vs CPU fp32 "
          f"relative L2 error {rel:.3e} (bound 5e-2)", flush=True)
    if not (torch.isfinite(out).all() and rel <= 5e-2):
        raise AssertionError(f"card Flux disagrees with the CPU reference: {rel}")
    return cpu, gpu, (lat, t, ctx, pooled, guidance, ids), g


def check_flux_model_grads(cpu, gpu, inputs, g):
    """Phase: LoRA gradients of the same 1-double + 1-single full-width Flux
    (non-zero LoRA B) on the card (bf16, forward and backward kernels: the
    joint backward at d = 128 and the BSHD backward) and on the CPU (fp32,
    plain versions), through one fixed cotangent, with remat off and on
    (``_check_remat_grads``)."""
    import torch

    lat, t, ctx, pooled, guidance, ids = inputs
    cot = torch.randn(lat.shape, generator=g)

    def grads_of(dev):
        return lambda model: _lora_grads(
            model, lambda m: m(*(a.to(dev) for a in (lat, t, ctx, pooled)), *ids,
                               guidance=guidance.to(dev)), cot)

    _check_remat_grads("1-double + 1-single full-width Flux.1-dev", gpu, grads_of("cuda"),
                       grads_of("cpu")(cpu))


_KERNEL_GROUPS = (  # (group, substrings of the kernel name), first match wins
    # the joint forwards (#2, #3): attn_fwd_sm90_kernel's modes 1 and 2, and
    # the k RMS pre-pass of mode 2 (and the mma.sync `attn_fwd_kernel` of
    # trees before it, which ``--sd3-forward-ab`` runs)
    ("joint attention forward", ("rms_k_kernel", "attn_fwd_kernel<") + tuple(
        f"attn_fwd_sm90_kernel<{d}, {m}>" for d in (64, 128) for m in (1, 2))),
    ("attention kernel", ("attn_fwd_sm90_kernel",)),
    # the joint backwards (#4, #5): attn_bwd_sm90_kernel's mode 2 and its
    # operand pre-pass (and the mma.sync kernels of trees before it)
    ("joint attention backward", ("attn_bwd_prepass_kernel", "attn_bwd_dkdv_kernel",
                                  "attn_bwd_dq_kernel") + tuple(
        f"attn_bwd_sm90_kernel<{d}, 2>" for d in (64, 128))),
    ("attention backward kernels", ("attn_bwd_",)),
    ("per-head RMS kernel", ("rms_heads_kernel",)),
    ("modulated LN kernel", ("layer_norm_kernel<__nv_bfloat16, true",)),
    ("LN kernel", ("layer_norm_kernel<__nv_bfloat16, false",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "splitK")),
    ("concatenations", ("CatArrayBatchedCopy",)),
    ("copies and casts", ("copy_", "direct_copy", "to_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _profile_forward(fn, reps=2, events=None, warm=False, cpu=False):
    """Trace ``reps`` warm calls of ``fn`` with torch.profiler (after one
    untraced call, unless ``warm`` says the caller has run it): (device
    kernel time per call, {kernel group: (launches, ms) per call}); where
    ``events`` is a list, (kernel name, launches, ms per call) of every
    kernel is appended to it. The busy share is the kernel time over the
    call's untraced CUDA-event time (the profiler slows the host, so its own
    wall is no measure of idleness). By default the trace records the
    device's activity alone: only its kernels are read, and the host events
    of a microstep's tens of thousands of operators take the profiler tens
    of seconds to gather; ``cpu=True`` records them too (the single-kernel
    timings, whose traces were checked that way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups, total = {}, 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.self_device_time_total <= 0:
            continue  # host-side ops; the kernels carry the device time
        ms = e.self_device_time_total / 1e3 / reps
        total += ms
        grp = next((g for g, parts in _KERNEL_GROUPS if any(p in e.key for p in parts)), "other")
        calls, acc = groups.get(grp, (0.0, 0.0))
        groups[grp] = (calls + e.count / reps, acc + ms)
        if events is not None:
            events.append((e.key[:60], e.count, round(ms, 5)))
    return total, groups


def run_flux_inference(kernels):
    """Phase: ``cli.infer.generate`` on a full-width Flux.1-dev pipeline (random
    weights from the seed; LoRA rank and alpha of the flux_smoke preset) at
    512^2, 28 steps, guidance 3.5; returns the kernels' launch counts of the
    1-prompt run."""
    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import infer
    from adv_grpo_torch.cli.common import apply_overrides, build_text_encoder, resolve_config
    from adv_grpo_torch.models.flux import FluxConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.flux_pipeline import FluxPipeline
    from adv_grpo_torch.utils.flops import flux_forward_flops
    from adv_grpo_torch.utils.images import images_to_uint8

    config = apply_overrides(resolve_config("flux_smoke"),
                             ["resolution=512", f"sample.eval_num_steps={FLUX_STEPS}"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fcfg = FluxConfig.dev(lora_rank=int(config.train.lora_rank),
                          lora_alpha=float(config.train.lora_alpha))
    pipeline = FluxPipeline.random_init(
        torch.Generator(device="cuda").manual_seed(SEED), fcfg, VAEConfig.flux(), "cuda",
        latent_hw=64, text_seq_len=512, guidance=float(config.sample.guidance_scale))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipeline.transformer.parameters())
    print(f"Flux.1-dev pipeline: {n_params / 1e9:.3f} B transformer parameters, built on the "
          f"card in {time.perf_counter() - t0:.2f} s", flush=True)
    encode = build_text_encoder(config, pipeline)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    images = infer.generate(pipeline, encode, ["a flower"], config, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    want = [c * FLUX_STEPS for c in flux_per_forward_counts(fcfg)]
    u8 = images_to_uint8(images.float().cpu().numpy())
    with tempfile.TemporaryDirectory() as out_dir:
        path = f"{out_dir}/node0_rank0_00000_0.png"
        Image.fromarray(u8[0]).save(path)
        img = np.asarray(Image.open(path))
    print(f"infer.generate Flux.1-dev full width 512^2 {FLUX_STEPS} steps guidance 3.5: "
          f"{wall:.2f} s (first call); PNG {img.shape}, pixel range {img.min()}..{img.max()}; "
          f"launches {counts} (LN, RMS, joint, BSHD; expected {want})", flush=True)
    if not torch.isfinite(images).all() or img.shape != (512, 512, 3) or img.min() == img.max():
        raise AssertionError(f"bad Flux image: shape {img.shape}, range "
                             f"{img.min()}..{img.max()}, finite "
                             f"{bool(torch.isfinite(images).all())}")
    if counts != want:
        raise AssertionError(f"Flux launch counts {counts}, expected {want}")

    vfn = pipeline.velocity_fn()
    for prompts in (["a flower"], ["a flower", "a red bicycle", "a city at night",
                                   "a bowl of fruit"]):
        n = len(prompts)
        infer.generate(pipeline, encode, prompts, config, seed=SEED)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = infer.generate(pipeline, encode, prompts, config, seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if images.shape != (n, 3, 512, 512) or not torch.isfinite(images).all():
            raise AssertionError(f"bad Flux images: {tuple(images.shape)}")
        emb, pooled = (torch.from_numpy(a).cuda() for a in encode(prompts))
        x = pipeline.prepare_latents(torch.Generator(device="cuda").manual_seed(SEED), n)
        t = torch.full((n,), 500.0, device="cuda")
        with torch.inference_mode():
            fwd_ms = _median_ms(lambda: vfn(x, t, emb, pooled), iters=5, warmup=1)
            kernel_ms, groups = _profile_forward(lambda: vfn(x, t, emb, pooled))
        tflops = flux_forward_flops(fcfg, 1024, 512, n) / (fwd_ms * 1e-3) / 1e12
        print(f"generate Flux.1-dev {n} prompt(s): {dt:.3f} s, {dt / n:.3f} s/image "
              f"({FLUX_STEPS} steps + VAE decode); one forward {fwd_ms:.2f} ms = "
              f"{tflops:.1f} TFLOP/s achieved (flux_forward_flops); device kernel time "
              f"{kernel_ms:.2f} ms per forward = {100 * kernel_ms / fwd_ms:.1f}% busy",
              flush=True)
        for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"  {grp}: {ms:.2f} ms, {calls:.0f} launches per forward", flush=True)
    # the Flux SDE sweep (cli.flux_sde_demo), plain and --kontext, on the warm
    # pipeline: the demo's inputs (4 text states) drawn from the seed
    from adv_grpo_torch.cli import flux_sde_demo

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    lat = randn(1, fcfg.in_channels // 4, 64, 64)
    txt = randn(1, flux_sde_demo.TEXT_TOKENS, fcfg.joint_attention_dim)
    pooled, cond = randn(1, fcfg.pooled_projection_dim), randn(*lat.shape)
    guidance = float(config.sample.guidance_scale)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = flux_sde_demo.sweep(pipeline.transformer, lat, txt, pooled, DEMO_LEVELS,
                                  DEMO_STEPS, guidance, out_dir)
        res += flux_sde_demo.sweep(pipeline.transformer, lat, txt, pooled, DEMO_LEVELS[-1:],
                                   DEMO_STEPS, guidance, out_dir, cond=cond)
        torch.cuda.synchronize()
        _check_demo("cli.flux_sde_demo (Flux.1-dev full width, 512^2; the last level with "
                    "--kontext)", res, DEMO_LEVELS + DEMO_LEVELS[-1:], time.perf_counter() - t0,
                    (256, 256, 3))
    # the conditioning latent must reach the model: at the same level, seed
    # and noise, the --kontext rollout ends elsewhere than the plain one
    plain, kontext = res[len(DEMO_LEVELS) - 1][1], res[-1][1]
    rel = _rel_l2(kontext.final_latents, plain.final_latents)
    print(f"  --kontext at noise {DEMO_LEVELS[-1]}: final latents relative L2 {rel:.3e} from the "
          f"plain rollout's (must differ)", flush=True)
    if torch.equal(kontext.final_latents, plain.final_latents):
        raise AssertionError("the --kontext sweep's final latents equal the plain sweep's: the "
                             "conditioning latent did not reach the model")
    print(f"Flux phase peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return counts


def expected_flux_train_counts(config, fcfg, epochs=EPOCHS):
    """Launches of the 6 Flux kernels in ``epochs`` epochs of the
    FLUX_TRAIN_OVERRIDES run, from the config: rollout forwards (one per step
    of each sampling batch), replay forwards and their blocks' recompute (one
    per microstep), then the backwards (one per microstep: every joint and
    BSHD attention, all of which a LoRA factor reaches)."""
    s, t = config.sample, config.train
    micro = (epochs * max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
             * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    fwd = epochs * int(s.num_batches_per_epoch) * int(s.num_steps) + micro
    return ([f * fwd + r * micro
             for f, r in zip(flux_per_forward_counts(fcfg), flux_per_recompute_counts(fcfg))]
            + [fcfg.num_double_layers * micro, fcfg.num_single_layers * micro]), micro // epochs


def run_flux_training(kernels, smi, resolution=512, epochs=EPOCHS, overrides=(),
                      remat_ab=False):
    """Phase: ``GRPOTrainer`` on a full-width Flux.1-dev pipeline (random
    weights from the seed, LoRA rank and alpha of ``flux_smoke``, remat from
    ``tpu.remat``) for ``epochs`` epochs of ``flux_smoke`` with
    FLUX_TRAIN_OVERRIDES at ``resolution``^2 and ``overrides``: launch
    counts exactly as derived, finite metrics, every LoRA factor and its EMA
    moved; each epoch's ``time/*`` phases, peak device memory, one traced
    microstep's kernel groups and busy share, and with ``remat_ab`` the
    microstep with remat off and on. An out-of-memory error prints the peak
    it reached, then fails the phase. Returns the kernels' launch counts."""
    import numpy as np
    import torch

    from adv_grpo_torch.cli.common import apply_overrides, build_text_encoder, resolve_config
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.models.flux import FluxConfig
    from adv_grpo_torch.models.lora import lora_params
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.rollout.flux import flux_schedule
    from adv_grpo_torch.train.driver import GRPOTrainer
    from adv_grpo_torch.train.flux_pipeline import FluxPipeline

    config = apply_overrides(resolve_config("flux_smoke"),
                             FLUX_TRAIN_OVERRIDES + [f"resolution={resolution}", *overrides])
    latent_hw = int(config.resolution) // 8
    s_img = (latent_hw // 2) ** 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fcfg = FluxConfig.dev(lora_rank=int(config.train.lora_rank),
                          lora_alpha=float(config.train.lora_alpha),
                          remat=bool(config.tpu.remat))
    pipeline = FluxPipeline.random_init(
        torch.Generator(device="cuda").manual_seed(SEED), fcfg, VAEConfig.flux(), "cuda",
        latent_hw=latent_hw, text_seq_len=512, guidance=float(config.sample.guidance_scale))
    start = {k: p.detach().clone() for k, p in lora_params(pipeline.transformer).items()}
    encode = build_text_encoder(config, pipeline)
    what = (f"GRPOTrainer flux_smoke full-width Flux.1-dev {resolution}^2 ({s_img} image + 512 "
            f"text tokens), remat {fcfg.remat}, {config.sample.num_steps}-step rollouts of 4 "
            f"images, {epochs} epoch(s)")
    with tempfile.TemporaryDirectory() as save_dir:
        config.save_dir = save_dir
        trainer = GRPOTrainer(config, pipeline, TextPromptDataset(str(config.dataset), "train"),
                              encode, multi_score(dict(config.reward_fn)), latent_hw=latent_hw)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            trainer.run(max_epochs=epochs)
        except torch.OutOfMemoryError as e:
            print(f"{what}: out of device memory after {time.perf_counter() - t0:.2f} s, peak "
                  f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"({str(e).splitlines()[0]}); {smi}", flush=True)
            raise
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    want, micro = expected_flux_train_counts(config, fcfg, epochs)
    print(f"{what}: {wall:.2f} s wall; peak device memory {peak / 2**30:.2f} GiB; launches "
          f"{counts} (LN, RMS, joint, BSHD, joint backward, BSHD backward; expected {want}); "
          f"{smi}", flush=True)
    nb = int(config.sample.num_batches_per_epoch)
    for r in records:
        rollout = r["time/rollout"] * nb
        reward = r["time/reward_wait"]
        phases = {k: round(v, 4) for k, v in r.items() if k.startswith("time/")}
        print(f"  epoch {r['epoch']}: rollout+decode {rollout:.3f} s, reward {reward:.3f} s "
              f"(not overlapped with a rollout), train {r['time/train']:.3f} s = "
              f"{r['time/train'] / micro:.3f} s per microstep ({micro} microsteps); reward "
              f"{r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}, "
              f"clipfrac {r['clipfrac']:.3f}; time/* (s a call) {phases}", flush=True)
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"epoch {r['epoch']}: non-finite {bad}")
    if len(records) != epochs or trainer.state.global_step == 0:
        raise AssertionError(f"{len(records)} epochs logged, global step "
                             f"{trainer.state.global_step}")
    lora, ema = trainer.state.lora, trainer.state.ema
    unchanged = {k for k, p in lora.items() if torch.equal(p, start[k])}
    ema_unchanged = {k for k, e in ema.items() if torch.equal(e, start[k])}
    finite = all(bool(torch.isfinite(p).all()) for p in lora.values())
    print(f"  LoRA: {len(lora) - len(unchanged)} of {len(lora)} tensors changed, finite "
          f"{finite}; EMA: {len(ema) - len(ema_unchanged)} changed; optimizer steps "
          f"{trainer.state.global_step}", flush=True)
    if not finite or unchanged or ema_unchanged:
        raise AssertionError(f"LoRA finite={finite}, unchanged {sorted(unchanged)}, EMA "
                             f"unchanged {sorted(ema_unchanged)}")
    if counts != want:
        raise AssertionError(f"Flux training launch counts {counts}, expected {want}")

    # one minibatch of one row and T window steps through the trainer's epoch
    # (T microsteps: replay forward, backward, optimizer), traced
    T = int(config.sample.train_num_steps)
    sig, ts = flux_schedule(int(config.sample.num_steps), s_img)
    dev = torch.device("cuda")
    emb, pooled = (torch.from_numpy(a).to(dev) for a in encode(["a flower"]))
    mb = dict(latents=torch.randn((1, 1, T + 1, s_img, fcfg.in_channels),
                                  generator=torch.Generator(device=dev).manual_seed(SEED),
                                  device=dev),
              log_probs=torch.zeros(1, 1, T, device=dev),
              timesteps=torch.from_numpy(ts[:T]).to(dev)[None, None],
              sigmas=torch.from_numpy(sig[:T]).to(dev)[None, None],
              sigmas_prev=torch.from_numpy(sig[1:T + 1]).to(dev)[None, None],
              advantages=torch.ones(1, 1, device=dev), embeds=emb[None], pooled=pooled[None])
    neg_e, neg_p = trainer._neg(1)

    def epoch():
        trainer.train_epoch_fn(trainer.state, mb, neg_e, neg_p)

    step_ms = _median_ms(epoch, iters=3, warmup=1) / T
    kernel_ms, groups = _profile_forward(epoch, reps=1)
    print(f"  one microstep (B=1, {s_img + 512} tokens, remat {fcfg.remat}): {step_ms:.1f} ms "
          f"(CUDA events); device kernel time {kernel_ms / T:.1f} ms = "
          f"{100 * kernel_ms / T / step_ms:.1f}% busy; {smi}", flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms / T:.2f} ms, {calls / T:.0f} launches per microstep", flush=True)
    if remat_ab:
        _remat_on_off(f"Flux.1-dev {resolution}^2 microstep (B=1)", pipeline.transformer,
                      epoch, T, smi)
    del trainer, pipeline
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the Flux.1-dev kernels at the 1024^2 training shapes: 4,096 image + 512
# text tokens, 24 heads of 128 (the joint forward #2 and backward #4 of the
# double blocks; the BSHD forward #8 and backward #9 of the single blocks
# over the 4,608-token row)
FLUX_1024 = (1, 4096, 512, 24, 128)


def check_flux_1024_kernels(smi):
    """Phase: #2 and #4 at d = 128 and #8 and #9 at the Flux.1-dev 1024^2
    shapes (FLUX_1024) against their plain twins (forwards 2e-2 absolute,
    output and lse; backwards 2e-2 relative L2 per cotangent) and timed:
    median ms beside SDPA's (forward, and backward through a retained graph)
    on the same inputs, and the bound."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops import joint_attention as ja
    from adv_grpo_torch.ops.attention import bwd_row_stats

    b, s_img, s_txt, heads, d = FLUX_1024
    dim, s, sm_scale = heads * d, s_img + s_txt, d ** -0.5
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def report(name, err, bound_err, ms, lib_ms, least, plain_ms=None):
        print(f"kernel {name} at Flux.1-dev 1024^2: max err {err:.3e} (bound {bound_err}); "
              f"median {ms:.4f} ms vs SDPA {lib_ms:.4f} ms"
              + ("" if plain_ms is None else f" vs plain {plain_ms:.4f} ms")
              + f"; bound {least[0]:.4f} ms ({least[1]}); {smi}", flush=True)
        if not err <= bound_err:
            raise AssertionError(f"{name} at 1024^2: error {err}")

    # 8 and 9: the single blocks' BSHD attention over the whole row
    q, k, v, do = (randn(b, s, dim) for _ in range(4))
    o, lse = attention.mha_bshd_fwd(q, k, v, heads, sm_scale, None, want_lse=True)
    ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(),
                                                num_heads=heads, return_lse=True)
    err = max((o.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    del ref, ref_lse
    q4, k4, v4 = (attention.to_bhsd(t, heads) for t in (q, k, v))
    report("mha_bshd (#8)", err, 2e-2,
           _median_ms(lambda: attention.mha_bshd(q, k, v, num_heads=heads)),
           _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
           _attn_bound((q, k, v, o), b, heads, s, s, d))
    di = bwd_row_stats(o, do, heads)
    got = attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads)
    twin = attention.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, di,
                                        num_heads=heads)
    err = max(_rel_l2(x.float(), y.float()) for x, y in zip(got, twin))
    del twin
    report("mha_bshd_bwd (#9), relative L2", err, 2e-2,
           _median_ms(lambda: attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads)),
           _sdpa_bwd_ms(q, k, v, do, heads),
           _attn_bound((q, k, v, do, lse, di) + tuple(got), b, heads, s, s, d, products=5))
    del q, k, v, do, o, lse, di, got, q4, k4, v4

    # 2 and 4: the double blocks' joint attention, d = 128, no RMS
    streams = [randn(b, s_img, dim) for _ in range(3)] + [randn(b, s_txt, dim)
                                                          for _ in range(3)]
    dos = [randn(b, s_img, dim), randn(b, s_txt, dim)]
    oi, ot, lse_i, lse_t = ja.joint_attention_fwd(*streams, None, heads, 1e-6, sm_scale, True)
    ref = ja.joint_mha_reference(*(t.float() for t in streams), num_heads=heads,
                                 return_lse=True)
    err = max((a.float() - r).abs().max().item() for a, r in zip((oi, ot, lse_i, lse_t), ref))
    del ref
    cat = [torch.cat([a, c], dim=1) for a, c in zip(streams[:3], streams[3:])]
    cat4 = [attention.to_bhsd(t, heads) for t in cat]
    report("joint_mha d=128 (#2)", err, 2e-2,
           _median_ms(lambda: ja.joint_mha(*streams, num_heads=heads)),
           _median_ms(lambda: F.scaled_dot_product_attention(*cat4)),
           _attn_bound(streams + [oi, ot], b, heads, s, s, d))
    lse, di = [lse_i, lse_t], [bwd_row_stats(oi, dos[0], heads), bwd_row_stats(ot, dos[1], heads)]
    got = ja.joint_attention_bwd(*streams, *dos, *lse, *di, num_heads=heads)
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    twin = ja.attention_bwd_reference(f32(streams[0::3]), f32(streams[1::3]),
                                      f32(streams[2::3]), f32(dos), lse, di, num_heads=heads)
    err = max(_rel_l2(x.float(), y.float())
              for x, y in zip(got, [a for st in twin for a in st]))
    del twin
    report("joint_attention_bwd d=128 (#4), relative L2", err, 2e-2,
           _median_ms(lambda: ja.joint_attention_bwd(*streams, *dos, *lse, *di,
                                                     num_heads=heads)),
           _sdpa_bwd_ms(*cat, torch.cat(dos, dim=1), heads),
           _attn_bound(tuple(streams) + tuple(dos) + tuple(lse) + tuple(di) + tuple(got), b,
                       heads, s, s, d, products=5))
    del streams, dos, cat, cat4, got
    gc.collect()
    torch.cuda.empty_cache()


def run_flux_1024_slice(kernels, smi, overrides=()):
    """Phase: Flux.1-dev GRPO at its published 1024^2 (4,096 image + 512
    text tokens a row), full width and depth from random weights, one epoch
    of ``flux_smoke`` with FLUX_TRAIN_OVERRIDES and ``tpu.remat=True``
    (``overrides`` such as ``tpu.remat=False`` for a run by hand) and its
    microstep with remat off and on, after its attention kernels at those
    shapes (``check_flux_1024_kernels``).
    ``python3 chip_smoke.py --flux-1024 [--set key=value ...]`` runs it
    alone."""
    t0 = time.perf_counter()
    check_flux_1024_kernels(smi)
    run_flux_training(kernels, smi, resolution=1024, epochs=1,
                      overrides=["tpu.remat=True", *overrides], remat_ab=True)
    print(f"Flux.1-dev 1024^2 phase: {time.perf_counter() - t0:.1f} s; {smi}", flush=True)


def wan_per_forward_counts(wcfg):
    """Kernel launches of one WanTransformer forward: (modulated LN, RMS, LN,
    BSHD attention). Per block: 2 modulated LNs (attention and FFN), 4 RMS
    qk-norms (self and cross), 1 LN (the cross-attention input), 2
    attentions; the output head: 1 modulated LN."""
    n = wcfg.num_layers
    return 2 * n + 1, 4 * n, n, 2 * n


def wan_per_recompute_counts(wcfg):
    """Launches of the blocks' recompute in one WAN backward under remat
    (every block's forward kernels again): a forward's but the output
    head's modulated LN; none without remat."""
    if not wcfg.remat:
        return 0, 0, 0, 0
    mod_ln, rms, ln, bshd = wan_per_forward_counts(wcfg)
    return mod_ln - 1, rms, ln, bshd


def blocked_bshd_reference(q, k, v, heads, rows=PLAIN_ROWS):
    """#8's plain version (``mha_bshd_reference``) a block of ``rows`` query
    rows at a time, each the plain softmax over all keys: (o, lse (B, H,
    S_q)) as the whole call gives them, for a sequence whose (B, H, S_q,
    S_kv) fp32 scores do not fit on the card."""
    import torch

    from adv_grpo_torch.ops.attention import mha_bshd_reference

    parts = [mha_bshd_reference(q[:, i:i + rows], k, v, num_heads=heads, return_lse=True)
             for i in range(0, q.shape[1], rows)]
    return torch.cat([o for o, _ in parts], 1), torch.cat([lse for _, lse in parts], 2)


def blocked_bshd_bwd_reference(q, k, v, do, lse, di, heads, rows=PLAIN_ROWS):
    """#9's plain twin (``bshd_bwd_reference``) a block of ``rows`` query rows
    at a time: dq block by block, dk and dv the fp32 sums of the blocks'."""
    import torch

    from adv_grpo_torch.ops.attention import bshd_bwd_reference

    dq, dk, dv = [], 0.0, 0.0
    for i in range(0, q.shape[1], rows):
        a, b, c = bshd_bwd_reference(q[:, i:i + rows], k, v, do[:, i:i + rows],
                                     lse[:, :, i:i + rows], di[:, :, i:i + rows],
                                     num_heads=heads)
        dq.append(a)
        dk, dv = dk + b.float(), dv + c.float()
    return torch.cat(dq, 1), dk, dv


def check_wan_kernels(s=8100, tag=""):
    """Phase: the kernels of the WAN path against their plain versions at
    the Wan2.1-T2V-1.3B shapes (``s`` video tokens: 8,100 of 33 frames at
    480^2, or 32,760 of 81 frames at 480x832 with ``tag`` "_81f" on the
    names; 512 text tokens, 12 heads of 128, width 1536), with median times
    beside the plain versions' (the attention's a block of PLAIN_ROWS query
    rows at a time) and one PyTorch call's. Bounds: 1 bf16 ulp of the fp32
    result for the norms; for the attention forward the output's max abs
    error and relative L2 apart (WAN_BSHD_OUT_BOUND, per kind) and 5e-3 on
    the lse; 2e-2 relative L2 per cotangent for its backward; at 8,100
    tokens #8's error no larger than the pre-scaled-q order's."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import attention, fused_norms
    from adv_grpo_torch.ops.attention import bwd_row_stats

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    heads, d, s_txt = 12, 128, WAN_TEXT
    dim = heads * d

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    results = []
    # 6: the no-affine LN (B = 1 timed, the main shape; B = 2 the training
    # rollout's)
    worst, max_err = 0.0, 0.0
    for b in (2, 1):
        x = randn(b, s, dim, scale=2.0) + randn(b, 1, dim)
        ref = fused_norms.ln_reference(x.float(), 1e-6, torch.float32)
        err = (fused_norms.layer_norm(x).float() - ref).abs()
        worst = max(worst, (err / _bf16_ulp(ref)).max().item())
        max_err = max(max_err, err.max().item())
        del ref, err
    least = _bound(_nbytes(x, x), 8.0 * x.numel(), FP32_FLOPS)
    ms, kernel_ms, host_ms = _three_ms(lambda: fused_norms.layer_norm(x), least[0])
    plain_ms = _median_ms(lambda: fused_norms.ln_reference(x, 1e-6, torch.bfloat16))
    lib = _three_ms(lambda: F.layer_norm(x, (dim,), eps=1e-6), least[0])
    lib_ms = lib[0]
    print(f"kernel layer_norm: max_abs_err {max_err:.3e}, max err {worst:.2f} bf16 ulp (bound 1 "
          f"ulp of the fp32 result) at (1|2,{s},1536); (1,{s},1536) median {ms:.4f} ms (device "
          f"kernel {_ms(kernel_ms)}, host {host_ms:.4f} ms a call) vs plain {plain_ms:.4f} ms vs "
          f"F.layer_norm {lib_ms:.4f} ms (device kernel {_ms(lib[1])}, host {lib[2]:.4f}); bound "
          f"{least[0]:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"layer_norm off by {worst} ulp")
    results.append(_entry("layer_norm" + tag, "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:54", max_err, ms, plain_ms, least,
                          lib_ms))

    # 1 at the WAN shape: the modulation rows as the blocks make them (a
    # table row plus a chunk of the time projection, contiguous)
    mods = randn(1, 6 * dim, scale=0.5)
    sc, sh = mods[:, dim:2 * dim] + 0.01, mods[:, :dim] + 0.01
    ref = fused_norms.lnmod_reference(x.float(), sc.float(), sh.float(), 1e-6, torch.float32)
    err = (fused_norms.modulated_layer_norm(x, sc, sh).float() - ref).abs()
    worst, max_err = (err / _bf16_ulp(ref)).max().item(), err.max().item()
    del ref, err
    least = _bound(_nbytes(x, sc, sh, x), 8.0 * x.numel(), FP32_FLOPS)
    ms, kernel_ms, host_ms = _three_ms(lambda: fused_norms.modulated_layer_norm(x, sc, sh),
                                       least[0])
    plain_ms = _median_ms(lambda: fused_norms.lnmod_reference(x, sc, sh, 1e-6, torch.bfloat16))
    # one item, so one affine LayerNorm computes the same function
    w_mod, b_mod = 1.0 + sc[0], sh[0]
    lib = _three_ms(lambda: F.layer_norm(x, (dim,), w_mod, b_mod, 1e-6), least[0])
    lib_ms = lib[0]
    print(f"kernel modulated_layer_norm at WAN's (1,{s},1536): max err {worst:.2f} bf16 ulp "
          f"(bound 1); median {ms:.4f} ms (device kernel {_ms(kernel_ms)}, host {host_ms:.4f} ms "
          f"a call) vs plain {plain_ms:.4f} ms vs F.layer_norm with weight 1+scale, bias shift "
          f"{lib_ms:.4f} ms (device kernel {_ms(lib[1])}, host {lib[2]:.4f})", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"modulated_layer_norm at the WAN shape off by {worst} ulp")
    results.append(_entry("modulated_layer_norm_wan" + tag, "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:252", max_err, ms, plain_ms, least,
                          lib_ms))

    # 7: RMS across all 12 heads (one head of the 1536-wide row), q read in
    # place as a column slice of the fused q/k/v projection
    qkv = randn(1, s, 3 * dim) + 0.3
    q = qkv[..., :dim]
    w = (1.0 + 0.1 * torch.randn(dim, generator=g, device=dev)).float()
    ref = fused_norms.rms_reference(q.float(), w, 1, 1e-6, torch.float32)
    err = (fused_norms.rms_norm_heads(q, w, num_heads=1).float() - ref).abs()
    worst, max_err = (err / _bf16_ulp(ref)).max().item(), err.max().item()
    del ref, err
    ms = _median_ms(lambda: fused_norms.rms_norm_heads(q, w, num_heads=1))
    plain_ms = _median_ms(lambda: fused_norms.rms_reference(q, w, 1, 1e-6, torch.bfloat16))
    wb = w.to(torch.bfloat16)
    lib_ms = _median_ms(lambda: F.rms_norm(q, (dim,), wb, 1e-6))
    print(f"kernel rms_norm_heads at WAN's one 1536-wide head, (1,{s},1536) strided: max err "
          f"{worst:.2f} bf16 ulp (bound 1); median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"F.rms_norm {lib_ms:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"rms_norm_heads at the WAN row off by {worst} ulp")
    results.append(_entry("rms_norm_heads_wan" + tag, "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:139", max_err, ms, plain_ms,
                          _bound(_nbytes(q, w, q), 4.0 * q.numel(), FP32_FLOPS), lib_ms))
    del qkv, q

    # 8 and 9: self (s x s) and cross (s x 512) attention; the plain versions
    # timed over fewer calls at 32,760 tokens (0.36 and 0.75 s a call)
    sm_scale = d ** -0.5
    reps = ((dict(iters=2, warmup=1), dict(iters=1, warmup=1)) if tag
            else (dict(iters=5), dict(iters=3, warmup=1)))
    for kind, skv in (("self", s), ("cross", s_txt)):
        q, do = randn(1, s, dim), randn(1, s, dim)
        k, v = randn(1, skv, dim), randn(1, skv, dim)
        o, lse = attention.mha_bshd_fwd(q, k, v, heads, sm_scale, None, want_lse=True)
        ref, ref_lse = blocked_bshd_reference(q.float(), k.float(), v.float(), heads)
        o_err, o_rel = (o.float() - ref).abs().max().item(), _rel_l2(o, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        err = max(o_err, lse_err)
        if not tag:  # the pre-scaled-q order's errors were recorded at 8,100 tokens
            old = _prescaled_q_err(q, k, v, heads, ref, ref_lse) if kind == "self" else None
            print(f"  #8 score scaling at WAN {kind}: max abs err {err:.3e} (output and lse) "
                  f"against the pre-scaled-q order's recorded "
                  f"{PRESCALED_Q_MHA_BSHD_ERR[kind]:.2e} (q rounded to bf16"
                  + ("" if old is None else f"; on the same inputs: {old:.3e}") + ")",
                  flush=True)
            if not err <= PRESCALED_Q_MHA_BSHD_ERR[kind]:
                raise AssertionError(f"mha_bshd WAN {kind} error {err} grew past the "
                                     f"pre-scaled-q order's {PRESCALED_Q_MHA_BSHD_ERR[kind]}")
        del ref, ref_lse
        ms = _median_ms(lambda: attention.mha_bshd(q, k, v, num_heads=heads))
        plain_ms = _median_ms(lambda: blocked_bshd_reference(q, k, v, heads), **reps[0])
        q4, k4, v4 = (attention.to_bhsd(t, heads) for t in (q, k, v))
        lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        least = _attn_bound((q, k, v, o), 1, heads, s, skv, d)
        o_bound = WAN_BSHD_OUT_BOUND[kind]
        print(f"kernel mha_bshd WAN {kind} {s} x {skv}, 12x128: output max abs err {o_err:.3e} "
              f"(bound {o_bound[0]:.0e}), relative L2 {o_rel:.3e} (bound {o_bound[1]:.0e}); "
              f"lse max abs err {lse_err:.3e} (bound 5e-3); median {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms vs SDPA {lib_ms:.4f} ms; bound {least[0]:.4f} ms", flush=True)
        if not (o_err <= o_bound[0] and o_rel <= o_bound[1] and lse_err <= 5e-3):
            raise AssertionError(f"mha_bshd WAN {kind}: output max abs {o_err}, relative L2 "
                                 f"{o_rel}; lse {lse_err}")
        results.append(_entry(f"mha_bshd_wan_{kind}{tag}", FWD_SM90_SOURCE,
                              "adv_grpo_tpu/ops/attention.py:346", err, ms, plain_ms, least,
                              lib_ms))

        di = bwd_row_stats(o, do, heads)
        got = attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads)
        twin = blocked_bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                          di, heads)
        max_abs = _check_rel_l2(f"mha_bshd_bwd WAN {kind} kernel vs its plain twin (dq, dk, dv)",
                                got, twin)
        del twin
        ms = _median_ms(lambda: attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads))
        plain_ms = _median_ms(lambda: blocked_bshd_bwd_reference(q, k, v, do, lse, di, heads),
                              **reps[1])
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*leaves)
        lib_ms = _grad_ms((out,), leaves, (attention.to_bhsd(do, heads),))
        del out, leaves
        least = _attn_bound((q, k, v, do, lse, di) + tuple(got), 1, heads, s, skv, d, products=5)
        print(f"kernel mha_bshd_bwd WAN {kind} {s} x {skv}: median {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms vs SDPA backward {lib_ms:.4f} ms; bound {least[0]:.4f} ms",
              flush=True)
        results.append(_entry(f"mha_bshd_bwd_wan_{kind}{tag}", BWD_SM90_SOURCE,
                              "adv_grpo_tpu/ops/attention.py:395", max_abs, ms, plain_ms, least,
                              lib_ms))
        del q, k, v, do, o, lse, di, got, q4, k4, v4
    torch.cuda.empty_cache()
    return results


def _prescaled_q_err(q, k, v, heads, ref, ref_lse):
    """Max abs error (output and lse) against ``ref`` / ``ref_lse`` of the
    forward kernel in the pre-scaled-q order: q x sm_scale*log2(e) rounded
    to bf16 before QK^T. The joint entry points keep that order, and
    ``mha_rms`` without RMS weights is the same kernel on the same strides."""
    from adv_grpo_torch.ops import joint_attention

    d = q.shape[-1] // heads
    o, lse = joint_attention.mha_rms_fwd(q, k, v, None, heads, 1e-6, d ** -0.5, True)
    return max((o.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())


def check_wan_model():
    """Phase: a 2-layer Wan2.1-T2V-1.3B at full width on the card (bf16,
    kernels) against the same weights on the CPU (fp32, plain versions): a
    3 x 10 x 14 latent grid (3 x 5 x 7 = 105 tokens, a ragged tile), 77 text
    tokens, non-zero LoRA B. Bound: relative L2 5e-2, bf16 rounding through
    2 blocks."""
    import torch

    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.wan import WanConfig, WanTransformer

    kw = dict(num_layers=2, lora_rank=32, lora_alpha=64.0)
    g = torch.Generator().manual_seed(SEED)
    cpu = init_params_(WanTransformer(WanConfig.t2v_1_3b(dtype=torch.float32, **kw),
                                      device="cpu"), g)
    for name, p in cpu.named_parameters():
        if name.endswith("lora_b"):  # non-zero adapters, so LoRA is exercised
            p.data.normal_(0.0, 0.02, generator=g)
    gpu = WanTransformer(WanConfig.t2v_1_3b(**kw), device="meta").to_empty(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    lat = torch.randn(2, 16, 3, 10, 14, generator=g)
    t = torch.tensor([999.0, 500.0])
    ctx = torch.randn(2, 77, 4096, generator=g) * 0.2
    with torch.inference_mode():
        ref = cpu(lat, t, ctx)
        out = gpu(lat.cuda(), t.cuda(), ctx.cuda()).float().cpu()
    rel = _rel_l2(out, ref)
    print(f"model check: 2-layer full-width Wan2.1-T2V-1.3B, card bf16 vs CPU fp32 relative L2 "
          f"error {rel:.3e} (bound 5e-2)", flush=True)
    if not (torch.isfinite(out).all() and rel <= 5e-2):
        raise AssertionError(f"card WAN disagrees with the CPU reference: {rel}")
    return cpu, gpu, (lat, t, ctx), g


def _wan_pipeline(config, frames=WAN_FRAMES):
    """A full-width Wan2.1-T2V-1.3B pipeline with the preset's LoRA rank and
    alpha, random weights from the seed, at ``frames`` frames of 480^2 and
    512 text tokens."""
    import torch

    from adv_grpo_torch.models.wan import WanConfig
    from adv_grpo_torch.models.wan_vae import WanVAEConfig
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    vcfg = WanVAEConfig.wan()
    wcfg = WanConfig.t2v_1_3b(lora_rank=int(config.train.lora_rank),
                              lora_alpha=float(config.train.lora_alpha),
                              remat=bool(config.tpu.remat))
    return WanPipeline.random_init(
        torch.Generator(device="cuda").manual_seed(SEED), wcfg, vcfg, "cuda",
        latent_hw=WAN_RES // vcfg.spatial_factor, latent_frames=vcfg.latent_frames(frames),
        text_seq_len=WAN_TEXT)


# the prefix / image / rewards phase (run_prefix_image_slice). The shared
# prefix at pickscore_cotrain_sd3_fast's shapes: 10 steps, CFG 4.5, one prompt
# slot x mini 8, window starts PREFIX_RTS, noise level 0. Bounds stated
# before the first run: the shared-prefix rollout against the plain
# same_latent one of the same initial latents, relative L2 of the final and
# window latents (bf16 MMDiT at CFG batch 2 in the prefix against 16, so
# cuBLAS may pick other algorithms; 10 steps of rounding, no chaos at noise
# 0); the fp32 VAE encoders on the card (TF32 off) against the CPU, relative
# L2 (two fp32 conv stacks summing in other orders); the fp32 CLIP-L scorers
# against the CPU, absolute per score scaled by max(1, |score|) (a resized
# pixel at a uint8 rounding tie may land one level apart)
PREFIX_RTS = (0, 2, 5)
PREFIX_REL_L2 = 3e-2
ENCODE_REL_L2 = 1e-4
SCORER_TOL = 1e-3
SCORER_CPU_IMAGES = 4
IMAGE_START_IDX = 20


def ocr_stand_in(img_u8):
    """The OCR engine of the prefix / image phase: a stand-in for PaddleOCR
    (not on the machine), passed to ``cli.train.main`` explicitly. It
    "reads" a word chosen by the image's mean brightness, so the OCR reward
    takes several values."""
    import numpy as np

    words = ("", "Spring", "Collection 2024", "Step Goal", "Forever Yours", "open")
    return words[int(np.asarray(img_u8, np.float64).mean()) % len(words)]


def _rel_l2_t(got, ref):
    import torch

    return float(torch.linalg.vector_norm((got - ref).float())
                 / torch.linalg.vector_norm(ref.float()).clamp_min(1e-30))


def run_prefix_image_slice(kernels, smi):
    """Phase: the group-shared prefix, the image-to-image entry, the Flux
    encoder and the rewards of ``pickscore_sd3_fast`` at full width (random
    weights from the seed + 13). (1) ``make_shared_prefix_sample_fn`` against
    ``make_sample_fn(same_latent=True)`` on one full-width SD3.5-M pipeline at
    pickscore_cotrain_sd3_fast's shapes (512^2, 10 steps, CFG 4.5, 1 slot x
    mini 8) and noise level 0 at window starts PREFIX_RTS: final and window
    latents within PREFIX_REL_L2 relative L2 (max abs printed), launches of
    #1-#3 per rollout against ``per_forward_counts`` x 10, each sampler's
    seconds (median of 3 after one warm-up); then one G epoch of
    ``pickscore_cotrain_sd3_fast`` with ``sample.same_latent=True`` (the
    discriminator off, the window drawn per batch). (2) ``cli.infer.main
    --image`` (an image the phase writes) at 512^2, 40 steps, ``--start_idx``
    IMAGE_START_IDX: a PNG, s/image, launches of #1-#3 for the 20 steps run;
    the SD3 VAE encode of that image on the card against the CPU in fp32.
    (3) ``FluxPipeline.encode_image`` on the Flux VAE at 512^2 against the
    CPU, its ms. (4) ``CLIPScorer.score`` (CLIP-L) and
    ``AestheticScorer.score`` (CLIP-L vision and the repository's LAION head)
    on 16 images at 512^2: ms, and SCORER_CPU_IMAGES of them against the CPU;
    then one epoch of ``pickscore_sd3_fast`` (CLIP-H PickScore and OCR with
    ``ocr_stand_in`` passed in) at COTRAIN_ARGV's cuts: launches of #1-#5 as
    derived, finite rewards, peak device memory."""
    import copy
    import gc

    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import common, infer, train
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vae import AutoencoderKL, VAEConfig
    from adv_grpo_torch.rewards.scorers import AestheticScorer, CLIPScorer
    from adv_grpo_torch.rollout.sampler import SamplerConfig
    from adv_grpo_torch.train.flux_pipeline import FluxPipeline
    from adv_grpo_torch.train.grpo_trainer import make_sample_fn, make_shared_prefix_sample_fn
    from adv_grpo_torch.train.pipeline import _build

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def synced(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ── (1) the group-shared prefix ──
    config = common.apply_overrides(common.resolve_config("pickscore_cotrain_sd3_fast"),
                                    ["pretrained.model=", f"seed={SEED + 13}"])
    s = config.sample
    mini = int(s.mini_num_image_per_prompt)
    pipeline = common.build_pipeline(config)
    encode = common.build_text_encoder(config, pipeline)
    mcfg, hw = pipeline.mmdit_cfg, int(config.resolution) // 8
    emb, pooled = (torch.from_numpy(np.repeat(np.asarray(a), mini, axis=0)).to(dev)
                   for a in encode(["a shop sign that says \"open\""]))
    neg_e, neg_p = (torch.from_numpy(np.asarray(a)).to(dev).expand(mini, *a.shape[1:])
                    for a in encode([""]))
    cfg = SamplerConfig(num_steps=int(s.num_steps), train_num_steps=int(s.train_num_steps),
                        guidance_scale=float(s.guidance_scale), noise_level=0.0)
    samplers = {"plain": make_sample_fn(pipeline, cfg, hw, same_latent=True, group_size=mini),
                "shared": make_shared_prefix_sample_fn(pipeline, cfg, hw, group_size=mini)}
    per_fwd = per_forward_counts(mcfg)
    want_counts = [c * cfg.num_steps for c in per_fwd]
    print(f"shared prefix, SD3.5-M full width 512^2, {cfg.num_steps} steps, CFG "
          f"{cfg.guidance_scale}, 1 slot x mini {mini} (CFG batch {2 * mini}), noise level 0: "
          f"the preset's random_timestep={s.random_timestep} leaves the prefix empty, so "
          f"window starts {list(PREFIX_RTS)} are run; {smi}", flush=True)
    secs = {}
    for name, fn in samplers.items():  # one warm-up each
        synced(fn, emb, pooled, neg_e, neg_p, torch.Generator(device=dev).manual_seed(SEED),
               0 if name == "shared" else torch.zeros(mini, dtype=torch.long))
    for rt in PREFIX_RTS:
        outs = {}
        for name, fn in samplers.items():
            arg = rt if name == "shared" else torch.full((mini,), rt, dtype=torch.long)
            times = []
            for rep in range(3):
                _zero_counts(kernels[:3])
                out, dt = synced(fn, emb, pooled, neg_e, neg_p,
                                 torch.Generator(device=dev).manual_seed(SEED), arg)
                times.append(dt)
                if rep == 0:
                    outs[name] = out[0], [k.launches for k in kernels[:3]]
            secs[name, rt] = sorted(times)[1]
        (p_out, p_counts), (s_out, s_counts) = outs["plain"], outs["shared"]
        errs = {k: _rel_l2_t(getattr(s_out, k), getattr(p_out, k))
                for k in ("final_latents", "latents")}
        max_abs = float((s_out.final_latents - p_out.final_latents).abs().max())
        work = (rt * 2 + (cfg.num_steps - rt) * 2 * mini) / (cfg.num_steps * 2 * mini)
        print(f"  rt {rt}: shared {secs['shared', rt]:.3f} s, plain {secs['plain', rt]:.3f} s "
              f"(rollout + decode of {mini} images, median of 3; MMDiT samples forwarded "
              f"{100 * work:.0f}% of the plain rollout's); final latents relative L2 "
              f"{errs['final_latents']:.3e}, max abs {max_abs:.3e}, window latents relative L2 "
              f"{errs['latents']:.3e} (bound {PREFIX_REL_L2}); launches shared {s_counts}, "
              f"plain {p_counts} (derived {want_counts} = {list(per_fwd)} x {cfg.num_steps})",
              flush=True)
        if (max(errs.values()) > PREFIX_REL_L2 or s_counts != want_counts
                or p_counts != want_counts
                or not bool(torch.isfinite(s_out.final_latents).all())):
            raise AssertionError(f"shared prefix at rt {rt}: {errs}, launches {s_counts} / "
                                 f"{p_counts}, expected {want_counts}")
    del samplers, pipeline, encode, outs, p_out, s_out
    free()

    # one G epoch of the preset with the shared prefix (the discriminator off,
    # so the epoch takes the G branch; the window drawn per sampling batch)
    argv = list(COTRAIN_ARGV)
    argv[argv.index("--max_epochs") + 1] = "1"
    argv += ["--set", "sample.same_latent=True", "--set", "train_d=False",
             "--set", "sample.random_timestep=None"]
    starts, build = [], train.build_trainer

    def recording_build(*args, **kwargs):
        trainer = build(*args, **kwargs)
        fn = trainer.sample_fn

        def sample(*a):
            starts.append(a[-1])
            return fn(*a)

        trainer.sample_fn = sample
        return trainer

    with tempfile.TemporaryDirectory() as work:
        _zero_counts(kernels)
        train.build_trainer = recording_build
        try:
            trainer, wall = synced(train.main, argv + ["--set", f"save_dir={work}"])
        finally:
            train.build_trainer = build
        counts = [k.launches for k in kernels]
        with open(os.path.join(work, "metrics.jsonl")) as f:
            (r,) = [json.loads(line) for line in f]
    want, _ = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg, 1)
    bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
    print(f"  cli.train pickscore_cotrain_sd3_fast, sample.same_latent=True, train_d=False: 1 G "
          f"epoch in {wall:.2f} s wall (builds included), shared prefix "
          f"{trainer.shared_prefix}, window starts {starts} (one per sampling batch, int); "
          f"reward {r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}; "
          f"launches {counts} (expected {want})", flush=True)
    if (not trainer.shared_prefix or counts != want or bad
            or not all(type(rt) is int for rt in starts)):
        raise AssertionError(f"shared-prefix epoch: launches {counts} (expected {want}), "
                             f"non-finite {bad}, starts {starts}")
    del trainer
    free()

    # ── (2) the image-to-image entry ──
    with tempfile.TemporaryDirectory() as work:
        rng = np.random.default_rng(SEED + 13)
        src = os.path.join(work, "external.png")
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).resize(
            (768, 640), Image.BICUBIC).save(src)
        held, generate = {}, infer.generate

        def held_generate(pipeline, *args, **kwargs):
            out, dt = synced(generate, pipeline, *args, **kwargs)
            held.update(s=dt, pipeline=pipeline, image=kwargs.get("image"))
            return out

        _zero_counts(kernels[:3])
        infer.generate = held_generate
        try:
            paths, wall = synced(infer.main, INFER_ARGV + [
                "--image", src, "--start_idx", str(IMAGE_START_IDX), "--out_dir", work])
        finally:
            infer.generate = generate
        counts = [k.launches for k in kernels[:3]]
        png = np.asarray(Image.open(paths[0]))
    want = [c * (STEPS - IMAGE_START_IDX) for c in per_forward_counts(MMDiTConfig.sd35_medium())]
    print(f"cli.infer --image (a {768}x{640} PNG resized to 512^2) eval_sd3_fast full width, "
          f"{STEPS} steps from --start_idx {IMAGE_START_IDX}: {held['s']:.3f} s/image "
          f"(generate: encode, {STEPS - IMAGE_START_IDX} CFG steps, decode), {wall:.2f} s wall "
          f"(pipeline build included); PNG {png.shape}, range {png.min()}..{png.max()}; "
          f"launches {counts} (expected {want}); {smi}", flush=True)
    if png.shape != (512, 512, 3) or png.min() == png.max() or counts != want:
        raise AssertionError(f"infer --image: PNG {png.shape}, launches {counts} vs {want}")
    vae = held["pipeline"].vae
    image = torch.from_numpy(held["image"]).to(dev)
    with torch.no_grad():
        enc = held["pipeline"].encode_image(image)
        enc_ms = _median_ms(lambda: held["pipeline"].encode_image(image), iters=5, warmup=1)
        cpu_vae = copy.deepcopy(vae).cpu()
        cpu = cpu_vae.encode(image.cpu())
    err = _rel_l2_t(enc.cpu(), cpu)
    print(f"  SD3 VAE encode (the posterior's mode) of that 512^2 image: {enc_ms:.2f} ms on the "
          f"card; against the CPU in fp32: relative L2 {err:.3e} (bound {ENCODE_REL_L2})",
          flush=True)
    if err > ENCODE_REL_L2:
        raise AssertionError(f"SD3 VAE encode relative L2 {err:.3e}")
    del held, vae, cpu_vae, enc, cpu
    free()

    # ── (3) the Flux VAE encoder (the Kontext conditioning entry) ──
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    fvcfg = VAEConfig.flux()
    flux = FluxPipeline(None, fvcfg, None, init_params_(_build(AutoencoderKL, fvcfg, dev), gen),
                        dev)
    with torch.no_grad():
        got = flux.encode_image(image)
        ms = _median_ms(lambda: flux.encode_image(image), iters=5, warmup=1)
        cpu = FluxPipeline(None, fvcfg, None, copy.deepcopy(flux.vae).cpu(),
                           torch.device("cpu")).encode_image(image.cpu())
    err = _rel_l2_t(got.cpu(), cpu)
    print(f"FluxPipeline.encode_image (Flux VAE, random weights) at 512^2: packed "
          f"{tuple(got.shape)} in {ms:.2f} ms on the card; against the CPU in fp32: relative "
          f"L2 {err:.3e} (bound {ENCODE_REL_L2}); the Kontext rollout has no model call in the "
          f"JAX package, its parity is held on the CPU", flush=True)
    if err > ENCODE_REL_L2 or tuple(got.shape) != (1, 1024, 64):
        raise AssertionError(f"Flux encode: {tuple(got.shape)}, relative L2 {err:.3e}")
    del flux, got, cpu
    free()

    # ── (4) the rewards ──
    torch.cuda.reset_peak_memory_stats()
    images = torch.from_numpy(np.random.default_rng(SEED + 14).uniform(
        -1, 1, (16, 3, 512, 512)).astype(np.float32)).to(dev)
    ids = np.full((16, 77), 3, np.int32)
    clip = CLIPScorer.random_init(torch.Generator(device=dev).manual_seed(SEED + 15), dev)
    aesthetic = AestheticScorer.random_init(torch.Generator(device=dev).manual_seed(SEED + 16),
                                            dev)
    head_sd = convert.aesthetic_state_dict_from_pth(torch.load(
        os.path.join("adv_grpo_tpu", "data", "assets", "sac+logos+ava1-l14-linearMSE.pth"),
        map_location="cpu", weights_only=True))
    aesthetic.head.load_state_dict(head_sd)
    n = SCORER_CPU_IMAGES
    for name, scorer, call in (("CLIPScorer.score (CLIP-L, random)", clip,
                                lambda sc, im, i: sc.score(im, i)),
                               ("AestheticScorer.score (CLIP-L vision random, the LAION head "
                                "from the repository's .pth)", aesthetic,
                                lambda sc, im, i: sc.score(im))):
        got = call(scorer, images, ids)
        ms = _median_ms(lambda: call(scorer, images, ids), iters=3, warmup=1)
        cpu_scorer = copy.copy(scorer)
        cpu_scorer.device = torch.device("cpu")
        if isinstance(scorer, CLIPScorer):
            cpu_scorer.clip = copy.deepcopy(scorer.clip).cpu()
        else:
            cpu_scorer.vision = copy.deepcopy(scorer.vision).cpu()
            cpu_scorer.head = copy.deepcopy(scorer.head).cpu()
        ref = call(cpu_scorer, images[:n].cpu(), ids[:n])
        err = float(((got[:n].cpu() - ref).abs() / ref.abs().clamp_min(1.0)).max())
        print(f"{name}: 16 images at 512^2 in {ms:.1f} ms on the card; scores "
              f"{got.min().item():.4f}..{got.max().item():.4f}; {n} of them against the CPU in "
              f"fp32: max error {err:.3e} (bound {SCORER_TOL}, relative above 1); {smi}",
              flush=True)
        if err > SCORER_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: error {err:.3e}")
        del cpu_scorer
    del clip, aesthetic, images
    free()

    # one epoch of pickscore_sd3_fast (PickScore + OCR) at COTRAIN_ARGV's cuts
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join("dataset", "ocr", "test.txt")) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        for split in ("train", "test"):  # dataset/ocr holds only its test split
            with open(os.path.join(work, f"{split}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        argv = ["--config", "pickscore_sd3_fast", "--set", "smoke_test=False",
                "--set", "pretrained.model=", "--set", f"dataset={work}",
                "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
                "--set", "train.gradient_accumulation_steps=1", "--set", "wandb_init=False",
                "--set", f"save_dir={os.path.join(work, 'run')}", "--max_epochs", "1",
                "--device", "cuda"]
        read = []

        def engine(img):
            read.append(ocr_stand_in(img))
            return read[-1]

        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        trainer, wall = synced(train.main, argv, ocr_engine=engine)
        counts = [k.launches for k in kernels]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "run", "metrics.jsonl")) as f:
            (r,) = [json.loads(line) for line in f]
    want, _ = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg, 1)
    keys = ("reward_avg", "reward_pickscore", "reward_ocr", "loss", "approx_kl")
    print(f"cli.train pickscore_sd3_fast full width (SD3.5-M 512^2, CLIP-H/14 fp32 random), "
          f"{trainer.config.sample.num_steps}-step rollouts, 2 batches of 16 images, 1 epoch: "
          f"{wall:.2f} s wall (builds included); OCR engine chip_smoke.ocr_stand_in (a stand-in "
          f"for PaddleOCR, passed to cli.train.main explicitly) read {len(read)} images "
          f"({len(set(read))} distinct texts); " + ", ".join(f"{k} {r[k]:.5f}" for k in keys)
          + f"; launches {counts} (expected {want}); peak device memory {peak / 2**30:.2f} GiB; "
          f"phase {time.perf_counter() - phase_t0:.1f} s; {smi}", flush=True)
    if (counts != want or len(read) != 32 or trainer.reward_ctx.ocr.engine is not engine
            or not all(np.isfinite(r[k]) for k in keys)):
        raise AssertionError(f"pickscore_sd3_fast epoch: launches {counts} vs {want}, "
                             f"{len(read)} OCR reads, {r}")
    del trainer
    free()


REF_PROMPTS, REF_VARIATIONS = 4, 2
EVAL_PROMPTS, EVAL_BATCH = 20, 16
FT_EPOCHS, FT_BATCH = 2, 4


def _stub_gradio(captured):
    """A ``gradio`` module that records the app's ``Interface`` (its ``fn``
    and inputs) and launches nothing."""
    import types

    gr = types.ModuleType("gradio")

    class Interface:
        def __init__(self, fn=None, inputs=None, outputs=None, title=None):
            captured.update(fn=fn, inputs=inputs)

        def launch(self, server_port=None):
            captured["launched"] = server_port

    gr.Interface = Interface
    for name in ("Textbox", "Dropdown", "Slider", "Number", "Image"):
        setattr(gr, name, lambda *a, __n=name, **k: types.SimpleNamespace(kind=__n, kwargs=k))
    return gr


def run_eval_tooling_slice(kernels, smi):
    """Phase: the evaluation and preparation tools at full width (random
    weights from the seed). (1) ``cli.generate_refs`` at ``eval_sd3_fast``
    (512^2, 40 steps, CFG 4.5) for the first REF_PROMPTS prompts of
    ``dataset/pickscore/test.txt`` x REF_VARIATIONS: launches of #1-#3
    exactly per_forward_counts x 40 per prompt, s per prompt; a second run
    writes and samples nothing. (2) ``cli.validate_refs`` passes on that
    set and exits 1 on a copy with one file cut in half. (3) ``cli.eval`` at
    ``eval_sd3_fast`` over the first EVAL_PROMPTS test prompts, ``--batch``
    EVAL_BATCH (CFG batch 32; two batches, the second 4 prompts and 12
    padding rows), ``--rewards``: PickScore CLIP-H and DINOv2-B/14's
    ``image_similarity`` against the set of (1) (``json_path`` /
    ``test_reference_image_path``), 20 PNGs, the merged JSON, finite means
    with counts of 20, launches as derived; s per image over the full batch,
    s per batch, peak memory. (4) ``cli.finetune_pickscore`` on full-width
    CLIP-H (fp32), FT_EPOCHS epochs of batch FT_BATCH over 8 pairs (the
    refs of (1) good, the eval images of (3) bad, a JSON the phase writes):
    finite losses, the tree moved, the ``.msgpack`` read back bitwise (write
    / read s, bytes), ms per step; then ``--tune_layer 1`` for one epoch:
    every tensor outside the last vision layer bitwise its start. (5) one
    epoch of ``cli.train`` at COTRAIN_ARGV with ``weight_path`` that
    ``.msgpack``: the live scorer bitwise the file as built, the frozen
    'pickscore' score of a fixed batch bitwise a fresh build's, launches of
    #1-#5 as derived; s, peak memory. (6) one epoch of ``dpo_sd3_fast``
    (beta 100) at COTRAIN_ARGV's cuts, OCR through ``ocr_stand_in``, a train
    split written from ``dataset/ocr``: launches with each microbatch's
    LoRA-off replay forward, ``kl_loss`` finite and non-zero; s. (7)
    ``cli.app``'s ``generate`` through a stub ``gradio``, for a local
    adapter (the epoch's LoRA with random B factors) and for the base
    model: two different 512^2 images, launches of #1-#3 as derived."""
    import copy
    import gc
    import shutil
    import sys as _sys

    import numpy as np
    import torch

    from adv_grpo_torch.cli import common, finetune_pickscore, generate_refs, infer
    from adv_grpo_torch.cli import app as app_cli
    from adv_grpo_torch.cli import eval as eval_cli
    from adv_grpo_torch.cli import train, validate_refs
    from adv_grpo_torch.models import convert, peft_lora
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.utils import msgpack_io

    phase_t0 = time.perf_counter()
    towers = CLIPTextConfig.clip_h_text(), ViTConfig.clip_h()
    per_fwd = per_forward_counts(MMDiTConfig.sd35_medium())
    sd3 = ["--set", "pretrained.model=", "--device", "cuda"]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def timed_sampler(times):
        sample = infer.sample_images

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sample(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return sample, call

    with open(os.path.join("dataset", "pickscore", "test.txt")) as f:
        test_prompts = [ln.strip() for ln in f if ln.strip()]
    work = tempfile.mkdtemp()
    try:
        # ── (1) generate_refs ──
        refs = os.path.join(work, "refs")
        with open(os.path.join(work, "prompts.txt"), "w") as f:
            f.write("\n".join(test_prompts[:REF_PROMPTS]) + "\n")
        argv = ["--config", "eval_sd3_fast", "--text_file", os.path.join(work, "prompts.txt"),
                "--output_dir", refs, "--num_variations", str(REF_VARIATIONS)] + sd3
        times = []
        sample, infer.sample_images = timed_sampler(times)
        try:
            _zero_counts(kernels[:3])
            t0 = time.perf_counter()
            json_path = generate_refs.main(argv)
            wall = time.perf_counter() - t0
            counts = [k.launches for k in kernels[:3]]
            mtimes = {n: os.stat(os.path.join(refs, n)).st_mtime_ns for n in os.listdir(refs)
                      if n.endswith(".png")}
            n_before = len(times)
            _zero_counts(kernels[:3])
            generate_refs.main(argv)
            again = [k.launches for k in kernels[:3]]
        finally:
            infer.sample_images = sample
        mtimes_after = {n: os.stat(os.path.join(refs, n)).st_mtime_ns for n in os.listdir(refs)
                        if n.endswith(".png")}
        want = [c * STEPS * REF_PROMPTS for c in per_fwd]
        print(f"cli.generate_refs eval_sd3_fast full width (SD3.5-M 512^2, {STEPS} steps, CFG "
              f"4.5, batch {REF_VARIATIONS} a prompt = CFG batch {2 * REF_VARIATIONS}), "
              f"{REF_PROMPTS} prompts of dataset/pickscore/test.txt: "
              f"{[round(t, 3) for t in times]} s per prompt (rollout + decode), {wall:.2f} s "
              f"wall (pipeline build included); launches {counts} (expected {want}); the "
              f"second run {len(times) - n_before} rollouts, launches {again}, "
              f"{sum(mtimes[n] != mtimes_after.get(n) for n in mtimes)} PNGs rewritten; {smi}",
              flush=True)
        if (counts != want or len(mtimes) != REF_PROMPTS * REF_VARIATIONS
                or len(times) != n_before or any(again) or mtimes_after != mtimes):
            raise AssertionError(f"generate_refs: launches {counts} vs {want}, "
                                 f"{len(mtimes)} PNGs, resume {again}")
        free()

        # ── (2) validate_refs ──
        broken = os.path.join(work, "refs_broken")
        shutil.copytree(refs, broken)
        victim = os.path.join(broken, sorted(mtimes)[0])
        with open(victim, "rb") as f:
            data = f.read()
        with open(victim, "wb") as f:
            f.write(data[: len(data) // 2])
        vargv = ["--num_variations", str(REF_VARIATIONS), "--decode_all",
                 "--text_file", os.path.join(work, "prompts.txt")]
        rc_good = validate_refs.main(["--image_dir", refs] + vargv)
        rc_bad = validate_refs.main(["--image_dir", broken] + vargv)
        print(f"cli.validate_refs: the set of (1) exits {rc_good}; a copy with "
              f"{os.path.basename(victim)} cut to {len(data) // 2} of {len(data)} bytes exits "
              f"{rc_bad}", flush=True)
        if rc_good != 0 or rc_bad == 0:
            raise AssertionError(f"validate_refs: {rc_good} / {rc_bad}")

        # ── (3) eval ──
        out_dir = os.path.join(work, "eval")
        times = []
        sample, infer.sample_images = timed_sampler(times)
        try:
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(kernels[:3])
            t0 = time.perf_counter()
            summary = eval_cli.main([
                "--config", "eval_sd3_fast", "--out_dir", out_dir, "--limit",
                str(EVAL_PROMPTS), "--batch", str(EVAL_BATCH), "--rewards",
                "--set", f"json_path={json_path}", "--set",
                f"test_reference_image_path={refs}"] + sd3)
            wall = time.perf_counter() - t0
            counts = [k.launches for k in kernels[:3]]
            peak = torch.cuda.max_memory_allocated()
        finally:
            infer.sample_images = sample
        n_batches = -(-EVAL_PROMPTS // EVAL_BATCH)
        want = [c * STEPS * n_batches for c in per_fwd]
        pngs = sorted(n for n in os.listdir(out_dir) if n.endswith(".png"))
        with open(os.path.join(out_dir, "prompt2img.json")) as f:
            merged = json.load(f)
        means, rcounts = summary["reward_means"], summary["reward_counts"]
        print(f"cli.eval eval_sd3_fast full width, {EVAL_PROMPTS} prompts, --batch {EVAL_BATCH} "
              f"(CFG batch {2 * EVAL_BATCH}; {n_batches} batches, the last "
              f"{EVAL_PROMPTS - (n_batches - 1) * EVAL_BATCH} prompts + padding), --rewards "
              f"(PickScore CLIP-H/14 fp32 and DINOv2-B/14 image_similarity against the set of "
              f"(1), random weights): {times[0] / EVAL_BATCH:.3f} s per image over the full "
              f"batch; s per batch (rollout + decode) {[round(t, 3) for t in times]}; "
              f"{wall:.2f} s wall (builds and scoring included); {len(pngs)} PNGs, "
              f"prompt2img.json {len(merged)} prompts; means "
              + ", ".join(f"{k} {v:.5f}" for k, v in sorted(means.items()))
              + f"; counts {rcounts}; launches {counts} (expected {want}); peak device "
              f"memory {peak / 2**30:.2f} GiB; {smi}", flush=True)
        if (counts != want or len(pngs) != EVAL_PROMPTS or len(merged) != EVAL_PROMPTS
                or set(rcounts) != {"avg", "pickscore", "image_similarity"}
                or set(rcounts.values()) != {EVAL_PROMPTS}
                or not all(np.isfinite(v) for v in means.values())):
            raise AssertionError(f"eval: launches {counts} vs {want}, {len(pngs)} PNGs, "
                                 f"{summary}")
        free()

        # ── (4) finetune_pickscore ──
        good, bad = os.path.join(work, "good"), os.path.join(work, "bad")
        os.makedirs(good), os.makedirs(bad)
        with open(json_path) as f:
            ref_map = json.load(f)
        pairs = {}
        for i, prompt in enumerate(test_prompts[:REF_PROMPTS]):
            for v, ref in enumerate(ref_map[prompt]):
                name = f"pair_{i}_{v}.png"
                shutil.copy(os.path.join(refs, ref), os.path.join(good, name))
                shutil.copy(os.path.join(out_dir, merged[prompt][0]), os.path.join(bad, name))
                pairs[prompt if v == 0 else f"{prompt} (variation {v})"] = name
        with open(os.path.join(work, "pairs.json"), "w") as f:
            json.dump(pairs, f)
        held = {}
        build = finetune_pickscore.build_scorer

        def held_build(*args, **kwargs):
            scorer = build(*args, **kwargs)
            held.setdefault("start", {k: v.to("cpu", copy=True)
                                      for k, v in scorer.clip.state_dict().items()})
            held["scorer"] = scorer
            return scorer

        ft_argv = ["--json_file", os.path.join(work, "pairs.json"), "--good_dir", good,
                   "--bad_dir", bad, "--batch", str(FT_BATCH), "--device", "cuda"]
        finetune_pickscore.build_scorer = held_build
        try:
            torch.cuda.reset_peak_memory_stats()
            ft = finetune_pickscore.main(ft_argv + ["--out", os.path.join(work, "ft"),
                                                    "--epochs", str(FT_EPOCHS)])
            ft_peak = torch.cuda.max_memory_allocated()
            final = {k: v.to("cpu", copy=True)
                     for k, v in held.pop("scorer").clip.state_dict().items()}
            free()
            t0 = time.perf_counter()
            tree = msgpack_io.load(ft["params_path"])
            read = convert.clip_dual_state_dict_from_jax(tree, *towers)
            read_s = time.perf_counter() - t0
            del tree
            tune = finetune_pickscore.main(ft_argv + ["--out", os.path.join(work, "ft_tune"),
                                                      "--epochs", "1", "--tune_layer", "1"])
            held.pop("scorer")
            tuned = convert.clip_dual_state_dict_from_jax(
                msgpack_io.load(tune["params_path"]), *towers)
        finally:
            finetune_pickscore.build_scorer = build
        start = held["start"]
        last = f"vision_model.layers.{towers[1].num_layers - 1}."
        not_bitwise = [k for k in final if not torch.equal(read[k], final[k])]
        moved = sum(not torch.equal(final[k], start[k]) for k in final)
        frozen_changed = [k for k in tuned if not k.startswith(last)
                          and not torch.equal(tuned[k], start[k])]
        tail_moved = sum(not torch.equal(tuned[k], start[k]) for k in tuned if k.startswith(last))
        losses = [h["train_loss"] for h in ft["history"][1:]]
        step_ms = [round(1e3 * t, 1) for t in ft["step_s"]]
        print(f"cli.finetune_pickscore, PickScore CLIP-H/14 fp32 random (986M parameters), "
              f"{len(pairs)} pairs (good: the refs of (1), bad: the eval images of (3)), "
              f"{FT_EPOCHS} epochs of batch {FT_BATCH}, AdamW lr 1e-6 wd 1e-4: ms per step "
              f"{step_ms}; train loss {[round(x, 5) for x in losses]}; pref_accuracy "
              f"{[h['pref_accuracy'] for h in ft['history']]}; {moved} of {len(final)} tensors "
              f"moved; .msgpack {ft['bytes']} bytes written in {ft['write_s']:.2f} s, read "
              f"and converted in {read_s:.2f} s, {len(not_bitwise)} tensors not bitwise; peak "
              f"device memory {ft_peak / 2**30:.2f} GiB; --tune_layer 1, one epoch: "
              f"{tail_moved} tensors of the last vision layer moved, {len(frozen_changed)} "
              f"others changed; {smi}", flush=True)
        if (not all(np.isfinite(losses)) or moved < len(final) // 2 or not_bitwise
                or frozen_changed or not tail_moved
                or ft["bytes"] != os.path.getsize(ft["params_path"])):
            raise AssertionError(f"finetune: losses {losses}, moved {moved}, not bitwise "
                                 f"{not_bitwise[:3]}, frozen changed {frozen_changed[:3]}")
        del start, final, tuned
        free()

        # ── (5) the co-train epoch from the .msgpack ──
        config = common.apply_overrides(common.resolve_config("pickscore_cotrain_sd3_fast"),
                                        ["smoke_test=False", "pretrained.model="])
        probe = np.random.default_rng(SEED + 1).uniform(-1, 1, (4, 3, 512, 512)).astype(
            np.float32)
        probe_prompts = ["a flower", "a red bicycle", "a city at night", "a bowl of fruit"]
        fresh_ctx = common.build_reward_context(config, {"pickscore"}, device="cuda")
        fresh = multi_score({"pickscore": 1.0}, fresh_ctx)(probe, probe_prompts)[0]["pickscore"]
        del fresh_ctx
        free()
        hold = {}

        def on_build(trainer):
            ctx = trainer.reward_ctx
            live = ctx.pickscore.clip.state_dict()
            hold["live_not_file"] = [k for k, v in read.items()
                                     if not torch.equal(live[k].cpu(), v)]
            hold["frozen"] = multi_score({"pickscore": 1.0}, ctx)(probe, probe_prompts)[0][
                "pickscore"]
            hold["copy"] = ctx.pickscore_frozen is not None

        argv = list(COTRAIN_ARGV)
        argv[argv.index("--max_epochs") + 1] = "1"
        argv += ["--set", f"weight_path={ft['params_path']}"]
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as run_work:
            counts, records, wall = _train_recorded(argv, run_work, kernels, hold, on_build)
        peak = torch.cuda.max_memory_allocated()
        trainer = hold["trainer"]
        branches = [bool(r["d_epoch"]) for r in records]
        want, _ = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg, 1,
                                        branches.count(False))
        print(f"cli.train pickscore_cotrain_sd3_fast (COTRAIN_ARGV, 1 epoch) with weight_path "
              f"the finetuned .msgpack: {wall:.2f} s wall (builds and the 3.9 GB read "
              f"included), branch {'D' if branches[0] else 'G'}; the live CLIP-H as built "
              f"differs from the file in {len(hold['live_not_file'])} tensors; the frozen "
              f"scorer copied aside {hold['copy']}; frozen 'pickscore' of the probe max change "
              f"against a fresh build {np.abs(hold['frozen'] - fresh).max():.3e}; launches "
              f"{counts} (expected {want}); peak device memory {peak / 2**30:.2f} GiB; {smi}",
              flush=True)
        if (hold["live_not_file"] or not np.array_equal(hold["frozen"], fresh)
                or not hold["copy"] or counts != want or len(records) != 1):
            raise AssertionError(f"warm start: live differs {hold['live_not_file'][:3]}, "
                                 f"launches {counts} vs {want}")
        rng = np.random.default_rng(SEED + 19)
        adapter = {k: (rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.02
                       if k.endswith("lora_b") else p.detach().float().cpu().numpy())
                   for k, p in trainer.state.lora.items()}
        rank, alpha = int(trainer.config.train.lora_rank), float(trainer.config.train.lora_alpha)
        del trainer, hold, read
        free()

        # ── (6) one dpo_sd3_fast epoch ──
        ds = os.path.join(work, "ocr")
        os.makedirs(ds)
        with open(os.path.join("dataset", "ocr", "test.txt")) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        for split in ("train", "test"):  # dataset/ocr holds only its test split
            with open(os.path.join(ds, f"{split}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        argv = ["--config", "dpo_sd3_fast", "--set", "smoke_test=False",
                "--set", "pretrained.model=", "--set", f"dataset={ds}",
                "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
                "--set", "train.gradient_accumulation_steps=1", "--set", "wandb_init=False",
                "--set", f"save_dir={os.path.join(work, 'dpo')}", "--max_epochs", "1",
                "--device", "cuda"]
        _zero_counts(kernels)
        t0 = time.perf_counter()
        trainer = train.main(argv, ocr_engine=ocr_stand_in)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        with open(os.path.join(work, "dpo", "metrics.jsonl")) as f:
            (r,) = [json.loads(line) for line in f]
        want, _ = expected_train_counts(trainer.config, trainer.pipeline.mmdit_cfg, 1)
        plain, _ = expected_train_counts(
            common.apply_overrides(copy.deepcopy(trainer.config), ["train.beta=0.0"]),
            trainer.pipeline.mmdit_cfg, 1)
        print(f"cli.train dpo_sd3_fast (beta {float(trainer.config.train.beta)}, algorithm "
              f"dpo) at COTRAIN_ARGV's cuts, OCR through chip_smoke.ocr_stand_in, 1 epoch: "
              f"{wall:.2f} s wall (builds included); reward {r['reward_avg']:.5f}, loss "
              f"{r['loss']:.4e}, kl_loss {r['kl_loss']:.4e}, approx_kl {r['approx_kl']:.3e}; "
              f"launches {counts} (expected {want}: the LoRA-off replay adds "
              f"{[a - b for a, b in zip(want, plain)]} to beta 0's {plain}); {smi}", flush=True)
        if (counts != want or not np.isfinite(r["kl_loss"]) or r["kl_loss"] == 0.0
                or not np.isfinite(r["loss"])):
            raise AssertionError(f"dpo epoch: launches {counts} vs {want}, {r}")
        del trainer
        free()

        # ── (7) the app ──
        adapter_dir = os.path.join(work, "adapter")
        peft_lora.export_peft_lora(adapter_dir, adapter, rank, alpha)
        del adapter
        captured = {}
        saved = _sys.modules.get("gradio")
        _sys.modules["gradio"] = _stub_gradio(captured)
        try:
            app_cli.main(["--config", "eval_sd3_fast", "--lora", adapter_dir] + sd3)
        finally:
            if saved is None:
                _sys.modules.pop("gradio", None)
            else:
                _sys.modules["gradio"] = saved
        images, secs = {}, {}
        _zero_counts(kernels[:3])
        for choice in ("local", "base (untuned)"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images[choice] = captured["fn"]('a shop sign that says "open"', choice, STEPS,
                                            4.5, SEED)
            secs[choice] = time.perf_counter() - t0
        counts = [k.launches for k in kernels[:3]]
        want = [c * STEPS * 2 for c in per_fwd]
        a, b = images["local"], images["base (untuned)"]
        print(f"cli.app generate (stub gradio) at eval_sd3_fast full width, {STEPS} steps, CFG "
              f"4.5, seed {SEED}: the local adapter {a.shape} in {secs['local']:.3f} s, the "
              f"base model {b.shape} in {secs['base (untuned)']:.3f} s; mean absolute "
              f"difference {np.abs(a.astype(np.int16) - b.astype(np.int16)).mean():.2f} uint8 "
              f"levels; launches {counts} (expected {want}); phase "
              f"{time.perf_counter() - phase_t0:.1f} s; {smi}", flush=True)
        if (a.shape != (512, 512, 3) or b.shape != a.shape or np.array_equal(a, b)
                or counts != want or captured.get("launched") != 7860):
            raise AssertionError(f"app: {a.shape} {b.shape}, launches {counts} vs {want}")
        del captured
        free()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the remaining rewards' phase: the GRPO epoch's rewards (COTRAIN_ARGV, one
# epoch): the preset's co-trained PickScore and every new reward that needs
# no reference images, the judges served by JudgeFixture; the two that
# need them score in the eval phase against the reference store (the
# adaptive gate scores the references under reward_fn with no references,
# in the JAX trainer too)
REMAINING_REWARD_FN = {"pickscore_cotrain": 1.0, "siglip_cotrain": 0.1, "pickscore_patch": 0.1,
                       "discriminator": 0.1, "imagereward": 0.1, "geneval": 0.1,
                       "unifiedreward": 0.1}
REMAINING_EVAL_REWARD_FN = {"siglip_image_similarity": 1.0, "constractive_external": 1.0}
BERT_VOCAB = 30522  # bert-base-uncased's; ImageReward adds [DEC] and [ENC]


def _bert_words():
    """Word pieces for a BERT vocabulary: the lower-cased words of the
    dataset's prompts, each as a whole word and as a ``##`` continuation,
    and every character of them, alone and as ``##``."""
    import re

    from adv_grpo_torch.data.datasets import TextPromptDataset

    words = []
    for prompt in TextPromptDataset("dataset/pickscore_small").prompts:
        words += re.findall(r"\w+|[^\w\s]", prompt.lower())
    chars = sorted({c for w in words for c in w})
    return list(dict.fromkeys(words + chars + ["##" + c for c in chars]
                              + ["##" + w for w in words]))


def run_remaining_rewards_slice(kernels, smi):
    """Phase: the last rewards at full width (random weights from the seed).
    (1) Files in the published layouts and widths under TMPDIR, timed: a
    ``SIGLIP_DIR`` (SigLIP so400m/14 at 384^2, HF ``SiglipVisionModel``
    names, fp32 safetensors), an ``IMAGEREWARD_PT`` (BLIP ViT-L/16 at 224^2
    and the 12-layer med-BERT, ImageReward's names, fp32 ``torch.save``)
    with a ``BERT_TOKENIZER_DIR`` (BERT_VOCAB word pieces and [DEC] /
    [ENC]), a ``STYLEGAN_D_PATH`` flax ``.msgpack`` of the 512^2 D; the
    judges at a loopback ``JudgeFixture``. (2) One epoch of ``cli.train``
    at COTRAIN_ARGV with REMAINING_REWARD_FN (the scorers read from those
    files; ``unifiedreward`` over sglang's protocol) and one ``eval_phase``
    on 4 prompts with REMAINING_EVAL_REWARD_FN against the reference store:
    the launches of #1-#5 exactly as derived, finite rewards, the
    fixture's requests in its formats (GenEval's pickles of 512^2 JPEGs,
    the sglang JSON with a PNG data URL and the rubric); s, peak memory.
    (3) The epoch's last 16 decoded 512^2 images through every new reward:
    ``siglip_image_similarity`` (against themselves: 1 within 1e-5),
    ``siglip_cotrain``, ``pickscore_patch``, ``constractive_external`` (one
    batch per gate branch), ``discriminator``, ``imagereward``, ``geneval``,
    ``deqa`` and ``unifiedreward`` over the pickle protocol: finite, shape
    (16,), ms per batch of 16; the loaded scorers bitwise as the drawn
    ones; peak memory."""
    import gc
    import pickle
    import shutil
    from io import BytesIO

    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import common
    from adv_grpo_torch.data.tokenizers import BertTokenizer
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.blip import BlipTextConfig, ImageRewardModel, blip_vit_l16
    from adv_grpo_torch.models.siglip import SigLIPVisionConfig, SigLIPVisionTower
    from adv_grpo_torch.models.stylegan_d import (
        StyleGANDConfig, StyleGANDiscriminator, StyleGANScorer)
    from adv_grpo_torch.rewards import vlm
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.rewards.scorers import (
        SigLIPScorer, contrastive_external_reward, random_init_)
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.utils import msgpack_io, safetensors_io
    from adv_grpo_torch.utils.images import images_to_uint8

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.mkdtemp()
    env_keys = ("SIGLIP_DIR", "IMAGEREWARD_PT", "BERT_TOKENIZER_DIR", "STYLEGAN_D_PATH",
                "GENEVAL_URL", "DEQA_URL", "UNIFIEDREWARD_URL")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    judge = JudgeFixture()
    try:
        judge.__enter__()
        # (1) the files, drawn from the seed on the card
        generator = torch.Generator(device="cuda").manual_seed(SEED + 20)
        scfg, tcfg, vcfg = SigLIPVisionConfig.so400m(), BlipTextConfig.med_base(), blip_vit_l16()
        dcfg = StyleGANDConfig(image_size=512)
        tower = random_init_(SigLIPVisionTower(scfg, device="meta").to_empty(device="cuda"),
                             generator)
        ir_model = random_init_(ImageRewardModel(tcfg, vcfg, device="meta").to_empty(
            device="cuda"), generator).eval()
        disc = random_init_(StyleGANDiscriminator(dcfg, device="meta").to_empty(device="cuda"),
                            generator)
        n_params = {name: sum(p.numel() for p in m.parameters())
                    for name, m in (("SigLIP", tower), ("ImageReward", ir_model), ("D", disc))}
        paths = {"SIGLIP_DIR": os.path.join(work, "siglip"),
                 "IMAGEREWARD_PT": os.path.join(work, "ImageReward.pt"),
                 "BERT_TOKENIZER_DIR": os.path.join(work, "bert"),
                 "STYLEGAN_D_PATH": os.path.join(work, "d.msgpack")}
        write_s, sizes = {}, {}
        t0 = time.perf_counter()
        os.makedirs(paths["SIGLIP_DIR"])
        safetensors_io.save_file({k: v.cpu() for k, v in hf_siglip_state_dict(
            tower.state_dict()).items()}, os.path.join(paths["SIGLIP_DIR"], "model.safetensors"))
        write_s["SIGLIP_DIR"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in imagereward_pt_state_dict(
            ir_model.state_dict()).items()}, paths["IMAGEREWARD_PT"])
        write_s["IMAGEREWARD_PT"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vocab = write_bert_tokenizer(paths["BERT_TOKENIZER_DIR"], _bert_words(), BERT_VOCAB)
        write_s["BERT_TOKENIZER_DIR"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        msgpack_io.save(paths["STYLEGAN_D_PATH"],
                        convert.stylegan_state_dict_to_jax(disc.state_dict(), dcfg))
        write_s["STYLEGAN_D_PATH"] = time.perf_counter() - t0
        for k, path in paths.items():
            sizes[k] = _dir_bytes(path) if os.path.isdir(path) else os.path.getsize(path)
        if vocab != tcfg.vocab_size:
            raise AssertionError(f"BERT vocabulary {vocab}, ImageReward's text tower "
                                 f"{tcfg.vocab_size}")
        # each file read back onto the card through the port's loaders, timed
        load_s, loaded = {}, {}
        t0 = time.perf_counter()
        loaded["SIGLIP_DIR"] = SigLIPScorer.from_state_dict(convert.siglip_state_dict_from_hf(
            convert.load_torch_state_dict(paths["SIGLIP_DIR"]), scfg), "cuda", scfg).vision
        torch.cuda.synchronize()
        load_s["SIGLIP_DIR"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded["IMAGEREWARD_PT"] = vlm.load_imagereward(paths["IMAGEREWARD_PT"], "cuda")
        torch.cuda.synchronize()
        load_s["IMAGEREWARD_PT"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        BertTokenizer(paths["BERT_TOKENIZER_DIR"])
        load_s["BERT_TOKENIZER_DIR"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded["STYLEGAN_D_PATH"] = StyleGANScorer.from_state_dict(
            convert.stylegan_state_dict_from_jax(msgpack_io.load(paths["STYLEGAN_D_PATH"]), dcfg),
            "cuda", dcfg).model
        torch.cuda.synchronize()
        load_s["STYLEGAN_D_PATH"] = time.perf_counter() - t0
        differ = {k: _bitwise_differ(m.state_dict(), src.state_dict()) for (k, m), src in zip(
            loaded.items(), (tower, ir_model, disc))}
        print(f"remaining rewards' files (parameters {n_params}): "
              + ", ".join(f"{k} {sizes[k] / 1e9:.3f} GB written in {write_s[k]:.2f} s, read "
                          f"onto the card in {load_s[k]:.2f} s" for k in paths)
              + f"; tensors that differ from the drawn ones {differ}; {smi}", flush=True)
        if any(differ.values()):
            raise AssertionError(f"loaded from the files: {differ}")
        del loaded
        os.environ.update(paths, GENEVAL_URL=judge.url + "/geneval",
                          DEQA_URL=judge.url + "/deqa", UNIFIEDREWARD_URL=judge.url + "/v1")

        # (2) one GRPO epoch with the new rewards, then the eval phase
        hold = {}
        argv = COTRAIN_ARGV + ["--max_epochs", "1",
                               "--set", f"reward_fn={REMAINING_REWARD_FN!r}",
                               "--set", f"eval_reward_fn={REMAINING_EVAL_REWARD_FN!r}"]
        ep_dir = os.path.join(work, "epoch")
        os.makedirs(ep_dir)
        t0 = time.perf_counter()
        counts, records, wall = _train_recorded(argv, ep_dir, kernels, hold)
        trainer, samples = hold["trainer"], hold["samples"]
        config, mcfg, ctx = trainer.config, trainer.pipeline.mmdit_cfg, trainer.reward_ctx
        r = records[0]
        branch = "D" if r["d_epoch"] else "G"
        want, _ = expected_train_counts(config, mcfg, 1, 0 if r["d_epoch"] else 1)
        keys = [f"reward_{k}" for k in REMAINING_REWARD_FN] + ["reward_avg",
                                                              "reference_reward_avg"]
        print(f"cli.train pickscore_cotrain_sd3_fast full width with {sorted(REMAINING_REWARD_FN)}"
              f" (SigLIP, ImageReward and the D from the files), 1 epoch ({branch}): {wall:.2f} s "
              f"wall (builds included), sampling {[round(t, 2) for t in hold['sample']]} s, "
              f"update {round((hold['d'] + hold['g'])[0], 2)} s; "
              + ", ".join(f"{k} {r[k]:.5g}" for k in keys) + f"; launches {counts}", flush=True)
        if len(records) != 1 or not all(np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"remaining rewards' epoch: {records}")
        if counts != want:
            raise AssertionError(f"remaining rewards' epoch launch counts {counts}, expected "
                                 f"{want}")
        prompts4 = TextPromptDataset("dataset/pickscore_small").prompts[:4]  # each has a PNG
        _zero_counts(kernels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, metrics = trainer.eval_phase(prompts4)
        eval_s = time.perf_counter() - t1
        eval_counts = [k.launches for k in kernels]
        want_eval = [c * int(config.sample.eval_num_steps) for c in per_forward_counts(mcfg)]
        print(f"  eval_phase, 4 prompts x {config.sample.eval_num_steps} steps: {eval_s:.2f} s; "
              + ", ".join(f"eval_reward_{k} {metrics['eval_reward_' + k]:.6f}"
                          for k in REMAINING_EVAL_REWARD_FN) + f"; launches {eval_counts}",
              flush=True)
        if (eval_counts != want_eval + [0, 0]
                or not all(np.isfinite(metrics["eval_reward_" + k])
                           for k in REMAINING_EVAL_REWARD_FN)):
            raise AssertionError(f"eval phase: {metrics}, launches {eval_counts}")
        epoch_s, epoch_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        # the requests the fixture received, in its formats
        got = {}
        for path, head, body in judge.requests:
            got.setdefault(path, []).append((head, body))
        nb, per = trainer.num_batches, len(samples["last_prompts"])
        calls = 2 * nb  # each sampling batch: its images, then the references for the gate
        n_img = nb * (samples["last_images"].shape[0] + per)
        if (len(got.get("/geneval", [])) != calls
                or len(got.get("/v1/chat/completions", [])) != n_img or set(got) - {
                    "/geneval", "/v1/chat/completions"}):
            raise AssertionError(f"fixture requests {({k: len(v) for k, v in got.items()})}, "
                                 f"expected {calls} GenEval and {n_img} sglang")
        # the generated images, and the reference images at config.resolution
        res = {samples["last_images"].shape[-1], int(config.resolution)}
        for _, body in got["/geneval"]:
            req = pickle.loads(body)
            shapes = {Image.open(BytesIO(j)).size for j in req["images"]}
            if len(shapes) != 1 or shapes.pop() not in {(r, r) for r in res} or req["only_strict"] is not True or len(
                    req["meta_datas"]) != len(req["images"]):
                raise AssertionError(f"GenEval request {shapes} {req['only_strict']}")
        for head, body in got["/v1/chat/completions"]:
            req = json.loads(body)
            content = req["messages"][0]["content"]
            if (head.get("Authorization") != "Bearer flowgrpo"
                    or not content[0]["image_url"]["url"].startswith("data:image;base64,")
                    or "Final Score:" not in content[1]["text"]):
                raise AssertionError(f"sglang request {head} {str(req)[:300]}")
        print(f"  the judges' fixture got {len(got['/geneval'])} GenEval pickles of {sorted(res)}^2 JPEGs "
              f"and {len(got['/v1/chat/completions'])} sglang requests; epoch + eval "
              f"{epoch_s:.2f} s, peak device memory {epoch_peak / 2**30:.2f} GiB", flush=True)

        # (3) the epoch's last 16 decoded images through every new reward
        images, prompts = samples["last_images"], samples["last_prompts"]  # a prompt per image
        n = len(images)
        drawn = SigLIPScorer(tower, ctx.siglip.image_size)
        g6 = torch.Generator(device="cuda").manual_seed(int(config.seed) + 6)
        drawn_head = drawn.init_head(g6)
        diff = [k for k, v in tower.state_dict().items()
                if not torch.equal(v, ctx.siglip.vision.state_dict()[k])]
        diff += [k for k, v in drawn_head.state_dict().items()
                 if not torch.equal(v, ctx.siglip_head_params.state_dict()[k])]
        diff += [k for k, v in disc.state_dict().items()
                 if not torch.equal(v, ctx.stylegan.model.state_dict()[k])]
        if diff:
            raise AssertionError(f"loaded scorers differ from the drawn ones: {diff[:5]}")
        drawn_ir = vlm.ImageRewardScorer(score_fn=vlm.imagereward_score_fn(
            ir_model, BertTokenizer(paths["BERT_TOKENIZER_DIR"])))
        u8 = images_to_uint8(images)
        os.environ["UNIFIEDREWARD_URL"] = judge.url + "/unifiedreward"
        pickle_ctx = common.build_reward_context(config, {"geneval", "deqa", "unifiedreward"},
                                                 device="cuda")
        ps, ids_fn = ctx.pickscore, ctx.tokenize
        one = [prompts[0]] * n
        order = np.argsort(ps.score(images, ids_fn(one)).cpu().numpy())
        gates = {"closed": (images[np.r_[order[:-1], order[:1]]], images[order[-1:]]),
                 "open": (images, images)}
        results, score_ms = {}, {}

        def timed(name, fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = np.asarray(fn(), np.float64)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            score_ms[name], results[name] = sorted(times)[len(times) // 2], out
            if out.shape != (n,) or not np.isfinite(out).all():
                raise AssertionError(f"{name}: shape {out.shape}, finite "
                                     f"{np.isfinite(out).all()}")

        def reward(names, c=ctx, **kw):
            return lambda: multi_score({names: 1.0}, c)(images, prompts, **kw)[0][names]

        timed("siglip_image_similarity", reward("siglip_image_similarity", ref_images=images))
        timed("siglip_cotrain", reward("siglip_cotrain"))
        timed("pickscore_patch", reward("pickscore_patch"))
        timed("constractive_external", reward("constractive_external", ref_images=images))
        timed("discriminator", reward("discriminator"))
        timed("imagereward", reward("imagereward"))
        timed("geneval", reward("geneval", pickle_ctx, metadata=[{}] * n))
        timed("deqa", reward("deqa", pickle_ctx))
        timed("unifiedreward (pickle)", reward("unifiedreward", pickle_ctx))
        sim = results["siglip_image_similarity"]
        branches = {}
        for gate, (batch, refs) in gates.items():
            out, aux = contrastive_external_reward(ps, batch, refs, ids_fn(one), ctx.pickscore_params)
            branches[gate] = not torch.equal(out, aux["raw_scores"])
            if out.shape != (n,) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"constractive_external {gate}: {out}")
        bitwise = {
            "siglip_image_similarity": np.array_equal(sim, drawn.similarity_to_refs(
                images, images).cpu().numpy()),
            "siglip_cotrain": np.array_equal(results["siglip_cotrain"], drawn.cotrain_score(
                drawn_head, images).cpu().numpy()),
            "discriminator": np.array_equal(results["discriminator"], ctx.stylegan.score(
                images).cpu().numpy()) and np.array_equal(
                results["discriminator"], type(ctx.stylegan)(disc).score(images).cpu().numpy()),
            "imagereward": np.array_equal(results["imagereward"], drawn_ir(u8, prompts))}
        peak = torch.cuda.max_memory_allocated()
        print(f"  {n} decoded {images.shape[-1]}^2 images, ms per batch of {n} ({smi}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in score_ms.items())
              + f"; siglip_image_similarity against themselves max |1 - s| "
              f"{np.abs(sim - 1).max():.2e}; constractive_external corrected on the gate's "
              f"branches {branches}; loaded scorers bitwise the drawn ones {bitwise}; "
              f"peak device memory {peak / 2**30:.2f} GiB; phase "
              f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
        if np.abs(sim - 1).max() > 1e-5 or branches != {"closed": False, "open": True}:
            raise AssertionError(f"siglip similarity {sim}, gate branches {branches}")
        if not all(bitwise.values()):
            raise AssertionError(f"loaded scorers against the drawn ones: {bitwise}")
        del trainer, samples, ctx, hold, tower, ir_model, disc, drawn, drawn_ir, pickle_ctx
    finally:
        judge.__exit__(None, None, None)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _zero_counts(kernels):
    """Set the kernels' launch counts to 0, the BSHD wrappers' count of
    their S_q != S_kv launches too."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "cross_launches"):
            k.cross_launches = 0


def run_wan_sampling(kernels):
    """Phase: the demo's rollout + decode (``cli.wan_sde_demo.sample_video``)
    on a full-width Wan2.1-T2V-1.3B pipeline: 50 steps, one video; then the
    per-forward time and kernel groups, and a short KL run. Returns the
    kernels' launch counts of the 50-step run and the BSHD forward's
    cross-attention (S_q != S_kv) share of its count."""
    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli.common import build_text_encoder, resolve_config
    from adv_grpo_torch.cli.wan_sde_demo import sample_video
    from adv_grpo_torch.rollout.wan import WanSamplerConfig
    from adv_grpo_torch.utils.flops import wan_forward_flops
    from adv_grpo_torch.utils.images import images_to_uint8

    config = resolve_config("wan_smoke")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = _wan_pipeline(config)
    wcfg = pipeline.wan_cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipeline.transformer.parameters())
    print(f"Wan2.1-T2V-1.3B pipeline: {n_params / 1e9:.3f} B transformer parameters (LoRA "
          f"r={wcfg.lora_rank} included), built on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    text = torch.from_numpy(build_text_encoder(config, pipeline)(["a cat on a skateboard"])[0])
    text = text.cuda()
    dev = torch.device("cuda")
    latents = pipeline.prepare_latents(torch.Generator(device=dev).manual_seed(SEED), 1)
    s_vid = int(np.prod(latents.shape[2:])) // int(np.prod(wcfg.patch_size))

    _zero_counts(kernels)
    t0 = time.perf_counter()
    out, video = sample_video(pipeline, latents, text, WanSamplerConfig(num_steps=WAN_STEPS),
                              torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, cross = [k.launches for k in kernels], kernels[3].cross_launches
    want = [c * WAN_STEPS for c in wan_per_forward_counts(wcfg)]
    frames = video[0].float().cpu().numpy()
    u8 = images_to_uint8(np.concatenate(list(frames[::8]), axis=-1)[None])[0]
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "wan_sde_kl0.png")
        Image.fromarray(u8).save(path)
        img = np.asarray(Image.open(path))
    print(f"WAN demo path, full-width Wan2.1-T2V-1.3B, {WAN_FRAMES} frames of {WAN_RES}^2 "
          f"({s_vid} video + {WAN_TEXT} text tokens), {WAN_STEPS} steps: {wall:.2f} s per video "
          f"(first call, VAE decode included); video {tuple(video.shape)}, strip PNG "
          f"{img.shape} range {img.min()}..{img.max()}; mean log-prob "
          f"{out.log_probs.mean().item():.4f}; launches {counts} (modulated LN, RMS, LN, BSHD; "
          f"expected {want}), {cross} of the BSHD ones cross-attention", flush=True)
    if (tuple(video.shape) != (1, WAN_FRAMES, 3, WAN_RES, WAN_RES)
            or not torch.isfinite(video).all() or not torch.isfinite(out.log_probs).all()
            or img.min() == img.max()):
        raise AssertionError(f"bad WAN video: {tuple(video.shape)}, finite "
                             f"{bool(torch.isfinite(video).all())}, range {img.min()}..{img.max()}")
    if counts != want or cross != want[3] // 2:
        raise AssertionError(f"WAN launch counts {counts} ({cross} cross), expected {want}")

    vfn = pipeline.velocity_fn()
    t = torch.full((1,), 500.0, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        pipeline.decode(out.final_latents)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        fwd_ms = _median_ms(lambda: vfn(latents, t, text), iters=5, warmup=1)
        kernel_ms, groups = _profile_forward(lambda: vfn(latents, t, text))
    tflops = wan_forward_flops(wcfg, s_vid, WAN_TEXT, 1) / (fwd_ms * 1e-3) / 1e12
    print(f"  warm: VAE decode {decode_s:.3f} s; one forward "
          f"{fwd_ms:.2f} ms = {tflops:.1f} "
          f"TFLOP/s achieved (wan_forward_flops); device kernel time {kernel_ms:.2f} ms per "
          f"forward = {100 * kernel_ms / fwd_ms:.1f}% busy; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms:.2f} ms, {calls:.0f} launches per forward", flush=True)

    # the per-step KL against the adapter-free policy: non-zero LoRA B, so
    # the two policies differ; two forwards per step
    with torch.no_grad():
        for name, p in pipeline.transformer.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=torch.Generator(device=dev).manual_seed(SEED))
    kl_steps = 3
    _zero_counts(kernels)
    kl_out, _ = sample_video(pipeline, latents, text,
                             WanSamplerConfig(num_steps=kl_steps, kl_reward=0.1),
                             torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    kl_counts = [k.launches for k in kernels]
    kl_want = [c * 2 * kl_steps for c in wan_per_forward_counts(wcfg)]
    kl = kl_out.kl.float().cpu()
    print(f"  KL run ({kl_steps} steps, kl_reward 0.1, LoRA B ~ N(0, 0.02)): per-step KL "
          f"{kl.numpy().round(8).tolist()}; launches {kl_counts} (expected {kl_want})",
          flush=True)
    if not (torch.isfinite(kl).all() and (kl > 0).all()):
        raise AssertionError(f"WAN KL not finite and positive: {kl}")
    if kl_counts != kl_want:
        raise AssertionError(f"WAN KL launch counts {kl_counts}, expected {kl_want}")
    del pipeline, out, video, kl_out
    torch.cuda.empty_cache()
    return counts, cross


def expected_wan_train_counts(config, wcfg, epochs=EPOCHS):
    """Launches of the 4 WAN forward kernels and the BSHD backward in
    ``epochs`` epochs of the WAN_TRAIN_OVERRIDES run, from the config:
    rollout forwards (one per step of each sampling batch; no KL forward: the
    trainer's pipeline carries no kl_reward) and replay forwards (one per
    microstep, two with a KL loss, the LoRA-off one under no_grad), the
    recompute of the blocks of the one a backward takes, then the backwards
    (one per microstep: both attentions of every block, all of which a LoRA
    factor reaches)."""
    s, t = config.sample, config.train
    micro = (epochs * max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
             * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    replay = micro * (2 if float(t.beta) > 0 else 1)
    fwd = epochs * int(s.num_batches_per_epoch) * int(s.num_steps) + replay
    return ([f * fwd + r * micro
             for f, r in zip(wan_per_forward_counts(wcfg), wan_per_recompute_counts(wcfg))]
            + [2 * wcfg.num_layers * micro]), micro // epochs


def _wan_train_epochs(kernels, smi, config, pipeline, frames, epochs):
    """``GRPOTrainer`` on ``pipeline`` (full width, random weights from the
    seed) for ``epochs`` epochs of ``config`` (wan_smoke with overrides, at
    ``frames`` frames of its resolution^2), the launch counts set to 0
    before and read after: finite metrics, every LoRA factor and its EMA
    moved, the counts as ``expected_wan_train_counts`` derives them; prints
    the peak memory and each epoch's ``time/*`` phases. Returns (trainer,
    text encoder, counts, the BSHD forward's and backward's cross-attention
    (S_q != S_kv) shares of theirs)."""
    import numpy as np
    import torch

    from adv_grpo_torch.cli.common import build_text_encoder
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.models.lora import lora_params
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.train.driver import GRPOTrainer

    wcfg = pipeline.wan_cfg
    res = int(config.resolution)
    start = {k: p.detach().clone() for k, p in lora_params(pipeline.transformer).items()}
    encode = build_text_encoder(config, pipeline)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as save_dir:
        config.save_dir = save_dir
        trainer = GRPOTrainer(config, pipeline, TextPromptDataset(str(config.dataset), "train"),
                              encode, multi_score(dict(config.reward_fn)), latent_hw=res // 8)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        trainer.run(max_epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        cross = [k.cross_launches for k in kernels[3:]]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    want, micro = expected_wan_train_counts(config, wcfg, epochs)
    print(f"GRPOTrainer wan_smoke full-width Wan2.1-T2V-1.3B, {frames} frames of {res}^2 "
          f"({trainer._s_img} video tokens), {config.sample.num_steps}-step rollouts of "
          f"{config.sample.mini_num_image_per_prompt} videos, {epochs} epochs: "
          f"{wall:.2f} s wall; peak device memory {peak / 2**30:.2f} GiB; launches {counts} "
          f"(modulated LN, RMS, LN, BSHD, BSHD backward; expected {want}), {cross} of the BSHD "
          f"ones cross-attention; {smi}", flush=True)
    nb = int(config.sample.num_batches_per_epoch)
    for r in records:
        rollout = r["time/rollout"] * nb
        reward = r["time/reward_wait"]
        print(f"  epoch {r['epoch']}: rollout+decode {rollout:.3f} s, reward {reward:.3f} s "
              f"(not overlapped with a rollout), train {r['time/train']:.3f} s = "
              f"{r['time/train'] / micro:.3f} s per microstep ({micro} microsteps); reward "
              f"{r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}, "
              f"clipfrac {r['clipfrac']:.3f}; "
              + ", ".join(f"{k} {v:.3f}" for k, v in r.items() if k.startswith("time/")),
              flush=True)
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"epoch {r['epoch']}: non-finite {bad}")
    if len(records) != epochs or trainer.state.global_step == 0:
        raise AssertionError(f"{len(records)} epochs logged, global step "
                             f"{trainer.state.global_step}")
    lora, ema = trainer.state.lora, trainer.state.ema
    unchanged = {k for k, p in lora.items() if torch.equal(p, start[k])}
    ema_unchanged = {k for k, e in ema.items() if torch.equal(e, start[k])}
    finite = all(bool(torch.isfinite(p).all()) for p in lora.values())
    print(f"  LoRA: {len(lora) - len(unchanged)} of {len(lora)} tensors changed, finite "
          f"{finite}; EMA: {len(ema) - len(ema_unchanged)} changed; optimizer steps "
          f"{trainer.state.global_step}", flush=True)
    if not finite or unchanged or ema_unchanged:
        raise AssertionError(f"LoRA finite={finite}, unchanged {sorted(unchanged)[:4]}, EMA "
                             f"unchanged {sorted(ema_unchanged)[:4]}")
    if counts != want or cross != [want[3] // 2, want[4] // 2]:
        raise AssertionError(f"WAN training launch counts {counts} ({cross} cross), expected "
                             f"{want}")
    return trainer, encode, counts, cross


def _wan_minibatch(trainer, encode, config, grid):
    """One minibatch of one row and T window steps at the latent grid
    ``grid`` (F, H, W) for ``trainer.train_epoch_fn`` (T microsteps: replay
    forward, backward, optimizer), its latents drawn from the seed; returns
    the call."""
    import torch

    from adv_grpo_torch.rollout.wan import wan_schedule

    T = int(config.sample.train_num_steps)
    sig, ts = wan_schedule(int(config.sample.num_steps))
    dev = torch.device("cuda")
    emb, pooled = (torch.from_numpy(a).to(dev) for a in encode(["a flower"]))
    shape = (1, 1, T + 1, trainer.pipeline.wan_cfg.in_channels) + tuple(grid)
    mb = dict(latents=torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                                  device=dev),
              log_probs=torch.zeros(1, 1, T, device=dev),
              timesteps=torch.from_numpy(ts[:T]).to(dev)[None, None],
              sigmas=torch.from_numpy(sig[:T]).to(dev)[None, None],
              sigmas_prev=torch.from_numpy(sig[1:T + 1]).to(dev)[None, None],
              advantages=torch.ones(1, 1, device=dev), embeds=emb[None], pooled=pooled[None])
    neg_e, neg_p = trainer._neg(1)

    def epoch():
        trainer.train_epoch_fn(trainer.state, mb, neg_e, neg_p)

    return epoch


def run_wan_training(kernels, smi, remat_ab=False):
    """Phase: ``GRPOTrainer`` on a full-width Wan2.1-T2V-1.3B pipeline
    (random weights from the seed, LoRA rank and alpha of ``wan_smoke``) for
    WAN_EPOCHS epochs of ``wan_smoke`` with WAN_TRAIN_OVERRIDES
    (``_wan_train_epochs``), then one traced minibatch; returns the kernels'
    launch counts and the BSHD forward's and backward's cross-attention
    (S_q != S_kv) shares of theirs. With ``remat_ab`` also the microstep
    with remat off and on (``_remat_on_off``)."""
    import torch

    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    config = apply_overrides(resolve_config("wan_smoke"), WAN_TRAIN_OVERRIDES)
    torch.cuda.empty_cache()
    pipeline = _wan_pipeline(config)
    trainer, encode, counts, cross = _wan_train_epochs(kernels, smi, config, pipeline,
                                                       WAN_FRAMES, WAN_EPOCHS)
    # one minibatch of one row and T window steps through the trainer's epoch,
    # traced
    T = int(config.sample.train_num_steps)
    hw = int(config.resolution) // 8
    epoch = _wan_minibatch(trainer, encode, config, (pipeline.latent_frames, hw, hw))
    step_ms = _median_ms(epoch, iters=3, warmup=1) / T
    kernel_ms, groups = _profile_forward(epoch, reps=1)
    print(f"  one microstep (B=1, {trainer._s_img} video tokens): "
          f"{step_ms:.1f} ms (CUDA events); device kernel time {kernel_ms / T:.1f} ms = "
          f"{100 * kernel_ms / T / step_ms:.1f}% busy", flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms / T:.2f} ms, {calls / T:.0f} launches per microstep", flush=True)
    if remat_ab:
        _remat_on_off(f"Wan2.1 {WAN_FRAMES} x {WAN_RES}^2 microstep (B=1)",
                      pipeline.transformer, epoch, T, smi)
    del trainer, pipeline
    torch.cuda.empty_cache()
    return counts, cross


def _timed(fn):
    """(seconds, peak GiB above the memory held before, result) of ``fn()``
    under ``inference_mode``, synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30, out)


def _wan_decode(vae, latents, chunk=None):
    """``vae.decode`` of normalised (1, 16, T, h, w) ``latents`` in chunks of
    ``chunk`` latent frames (by default ``chunk_frames``'), unclipped."""
    mu, std = vae._stats(latents.device)
    return vae.decoder(vae.post_quant_conv(latents * std + mu), chunk=chunk)


def _wan_81_rollout(pipeline, config, kernels, smi):
    """Phase (a): the demo's rollout + decode (``cli.wan_sde_demo.sample_video``)
    at the published 81 frames of 480x832 (latents (1, 16) + WAN_81_GRID
    drawn from the seed: 32,760 video + 512 text tokens), WAN_81_STEPS
    steps; the video (1, 81, 3, 480, 832) finite, the launch counts exactly
    ``wan_per_forward_counts`` x steps (half of the BSHD ones cross), the
    decode timed and its peak memory taken where ``sample_video`` calls it.
    Then the decode at 81 frames of 480^2, and at 33 frames of 480^2
    (``chunk_frames`` must take one chunk there: the whole-sequence decode)
    and, beside it, in two chunks (relative L2 1e-5 from the whole):
    seconds, chunks and peak memory each. Returns the launch counts
    and the BSHD forward's cross-attention share."""
    import numpy as np
    import torch

    from adv_grpo_torch.cli.common import build_text_encoder
    from adv_grpo_torch.cli.wan_sde_demo import sample_video
    from adv_grpo_torch.rollout.wan import WanSamplerConfig
    from adv_grpo_torch.utils.flops import wan_forward_flops

    dev = torch.device("cuda")
    wcfg, vae = pipeline.wan_cfg, pipeline.vae
    g = torch.Generator(device=dev).manual_seed(SEED + 81)
    latents = torch.randn((1, wcfg.in_channels) + WAN_81_GRID, generator=g, device=dev)
    text = torch.from_numpy(build_text_encoder(config, pipeline)(["a cat on a skateboard"])[0])
    s_vid = int(np.prod(WAN_81_GRID)) // int(np.prod(wcfg.patch_size))
    frames = vae.cfg.temporal_factor * (WAN_81_GRID[0] - 1) + 1
    hw = tuple(vae.cfg.spatial_factor * n for n in WAN_81_GRID[1:])

    decoded, pipeline_decode = [], pipeline.decode  # timed where sample_video calls it

    def decode(lat):
        rollout_gib = torch.cuda.max_memory_allocated() / 2**30
        secs, gib, video = _timed(lambda: pipeline_decode(lat))
        decoded.append((secs, gib, rollout_gib))
        return video

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    pipeline.decode = decode
    t0 = time.perf_counter()
    try:
        out, video = sample_video(pipeline, latents, text.to(dev),
                                  WanSamplerConfig(num_steps=WAN_81_STEPS),
                                  torch.Generator(device=dev).manual_seed(SEED + 82))
        torch.cuda.synchronize()
    finally:
        del pipeline.decode
    wall = time.perf_counter() - t0
    counts, cross = [k.launches for k in kernels], kernels[3].cross_launches
    (decode_s, decode_gib, peak), = decoded
    want = [c * WAN_81_STEPS for c in wan_per_forward_counts(wcfg)]
    finite = bool(torch.isfinite(video).all()) and bool(torch.isfinite(out.log_probs).all())
    spread = (video.amax() - video.amin()).item()
    shape = tuple(video.shape)
    del video
    step_ms = (wall - decode_s) * 1e3 / WAN_81_STEPS
    tflops = wan_forward_flops(wcfg, s_vid, WAN_TEXT, 1) / (step_ms * 1e-3) / 1e12
    print(f"WAN 81 frames: demo path at the published {frames} frames of {hw[0]}x{hw[1]} "
          f"(latents {tuple(latents.shape)}: {s_vid} video + {WAN_TEXT} text tokens), "
          f"{WAN_81_STEPS} steps (cut from 50): {wall:.2f} s (first call, decode included), "
          f"{step_ms:.1f} ms a step = {tflops:.1f} TFLOP/s achieved (wan_forward_flops); video "
          f"{shape}, finite {finite}, range spread {spread:.3f}; the rollout's peak device "
          f"memory {peak:.2f} GiB; launches {counts} (modulated LN, RMS, LN, BSHD; expected "
          f"{want}), "
          f"{cross} of the BSHD ones cross-attention; {smi}", flush=True)
    if shape != (1, frames, 3) + hw or not finite or not spread > 0:
        raise AssertionError(f"bad 81-frame WAN video: {shape}, finite {finite}, spread {spread}")
    if counts != want or cross != want[3] // 2:
        raise AssertionError(f"WAN 81-frame launch counts {counts} ({cross} cross), expected "
                             f"{want}")

    dec = vae.decoder
    lat = torch.randn((1, 16, WAN_81_GRID[0], 60, 60), generator=g, device=dev)
    square_s, square_gib, vid = _timed(lambda: _wan_decode(vae, lat))
    finite = bool(torch.isfinite(vid).all())
    del vid
    for name, shp, secs, gib in (("81 frames of 480x832", out.final_latents.shape, decode_s,
                                  decode_gib),
                                 ("81 frames of 480^2", lat.shape, square_s, square_gib)):
        chunk = dec.chunk_frames(shp)
        print(f"  VAE decode, {name} (latent frames {shp[2]} in {-(-shp[2] // chunk)} chunks "
              f"of {chunk}): {secs:.3f} s, peak {gib:.2f} GiB above the memory held before",
              flush=True)
    if not finite:
        raise AssertionError("the WAN decode of 81 frames of 480^2 is not finite")
    # 33 frames decode in one chunk, which is the whole-sequence decode; the
    # same latents forced into two chunks beside it
    lat = torch.randn((1, 16, 9, 60, 60), generator=g, device=dev)
    T, chunk = lat.shape[2], dec.chunk_frames(lat.shape)
    if chunk != T:
        raise AssertionError(f"the 33-frame decode takes chunks of {chunk}, not the whole {T}")
    whole, whole_gib, a = _timed(lambda: _wan_decode(vae, lat))
    two, _, b = _timed(lambda: _wan_decode(vae, lat, chunk=-(-T // 2)))
    rel = _rel_l2(b, a)
    print(f"  VAE decode, 33 frames of 480^2: {whole:.3f} s in one chunk of {T} (the "
          f"whole-sequence decode), peak {whole_gib:.2f} GiB above; in two chunks {two:.3f} s "
          f"({two / whole:.2f}x), relative L2 {rel:.2e} from the whole (bound 1e-5); {smi}",
          flush=True)
    if not rel <= 1e-5:
        raise AssertionError(f"the 33-frame decode in two chunks: relative L2 {rel} from the "
                             f"whole")
    del out, a, b, lat
    torch.cuda.empty_cache()
    return counts, cross


def _wan_81_microsteps(trainer, encode, config, kernels, smi):
    """Phase (c): one row of T window steps at the published grid (latents
    (1, 1, T + 1, 16) + WAN_81_GRID) through ``trainer.train_epoch_fn``, with
    remat off, then on (after one warm-up call at this grid): per setting
    one timed call, its launch counts (set to 0 before it; the forwards, the
    blocks' recompute under remat and the backwards exactly as derived), ms
    per microstep (CUDA events) and peak memory, then one traced call:
    device kernel time by group and busy share. Returns the counts with
    remat off."""
    import dataclasses

    import torch

    model = trainer.pipeline.transformer
    base = model.cfg
    T = int(config.sample.train_num_steps)
    replay = 2 if float(config.train.beta) > 0 else 1
    epoch = _wan_minibatch(trainer, encode, config, WAN_81_GRID)
    tokens = WAN_81_GRID[0] * (WAN_81_GRID[1] // 2) * (WAN_81_GRID[2] // 2)
    counted = {}
    epoch()  # warm-up: the first call at this grid
    try:
        for remat in (False, True):
            model.cfg = dataclasses.replace(base, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(kernels)
            ms = _median_ms(epoch, iters=1, warmup=0) / T
            counts = counted[remat] = [k.launches for k in kernels]
            cross = [k.cross_launches for k in kernels[3:]]
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = ([f * replay * T + r * T for f, r in zip(
                wan_per_forward_counts(model.cfg), wan_per_recompute_counts(model.cfg))]
                + [2 * model.cfg.num_layers * T])
            t0 = time.perf_counter()
            kernel_ms, groups = _profile_forward(epoch, reps=1, warm=True)
            traced_s = time.perf_counter() - t0
            print(f"WAN 81 frames: one GRPO microstep at the published grid (B=1, {tokens} "
                  f"video + {WAN_TEXT} text tokens), remat {'on' if remat else 'off'}: "
                  f"{ms:.1f} ms (CUDA events); device kernel time {kernel_ms / T:.1f} ms = "
                  f"{100 * kernel_ms / T / ms:.1f}% busy; peak device memory {peak:.2f} GiB; "
                  f"launches of {T} microsteps {counts} (expected {want}), {cross} cross; the "
                  f"traced call {traced_s:.1f} s; {smi}", flush=True)
            for grp, (calls, gms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
                print(f"    {grp}: {gms / T:.2f} ms, {calls / T:.0f} launches per microstep",
                      flush=True)
            if counts != want or cross != [want[3] // 2, want[4] // 2]:
                raise AssertionError(f"81-frame microstep launch counts {counts} ({cross} "
                                     f"cross), expected {want}")
    finally:
        model.cfg = base
    return counted[False]


def run_wan_81_slice(kernels, smi):
    """Phase: Wan2.1-T2V-1.3B at its published 81 frames, full width and
    depth (30 layers, 12 x 128 heads, random weights from the seed, 512
    text tokens): (b) #6, #1, #7, #8 and #9 at 32,760 video tokens against
    their plain versions (``check_wan_kernels``); (a) the rollout and decode
    at 480x832 (``_wan_81_rollout``); (d) one ``GRPOTrainer`` epoch of
    ``wan_smoke`` at 81 frames of 480^2 (WAN_81_TRAIN_OVERRIDES); (c) the
    GRPO microstep at the published grid with remat off and on
    (``_wan_81_microsteps``).
    ``kernels``: the four WAN forward wrappers and the BSHD backward.
    Returns the kernels-line entries of (b), their launches from (a) and
    (c). ``python3 chip_smoke.py --wan-81`` runs it alone."""
    import torch

    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    marks = [("start", time.perf_counter())]
    s_vid = WAN_81_GRID[0] * (WAN_81_GRID[1] // 2) * (WAN_81_GRID[2] // 2)
    results = check_wan_kernels(s=s_vid, tag="_81f")
    marks.append(("kernel checks", time.perf_counter()))
    config = apply_overrides(resolve_config("wan_smoke"), WAN_81_TRAIN_OVERRIDES)
    torch.cuda.empty_cache()
    pipeline = _wan_pipeline(config, frames=WAN_81_FRAMES)
    marks.append(("pipeline build", time.perf_counter()))
    counts, cross = _wan_81_rollout(pipeline, config, kernels[:4], smi)
    marks.append(("rollout and decodes", time.perf_counter()))
    launches = dict(zip(("modulated_layer_norm_wan_81f", "rms_norm_heads_wan_81f",
                         "layer_norm_81f"), counts))
    launches.update(mha_bshd_wan_self_81f=counts[3] - cross, mha_bshd_wan_cross_81f=cross)
    trainer, encode, _, _ = _wan_train_epochs(kernels, smi, config, pipeline, WAN_81_FRAMES, 1)
    marks.append(("trainer epoch", time.perf_counter()))
    counts = _wan_81_microsteps(trainer, encode, config, kernels, smi)
    marks.append(("microsteps", time.perf_counter()))
    launches.update(mha_bshd_bwd_wan_self_81f=counts[4] // 2,
                    mha_bshd_bwd_wan_cross_81f=counts[4] // 2)
    for r in results:
        r["launches"] = launches[r["name"]]
    del trainer, pipeline
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Wan2.1 81-frame phase: {marks[-1][1] - marks[0][1]:.1f} s ("
          + ", ".join(f"{name} {t - t_prev:.1f}" for (name, t), (_, t_prev)
                      in zip(marks[1:], marks)) + f"); {smi}", flush=True)
    return results


def wan_decode_probe(smi, frames, h, w):
    """``--wan-decode F H W``: the full-width WAN VAE (random weights from the
    seed, fp32, TF32 off) decodes latents of F video frames of H x W in one
    chunk, the whole-sequence decode: its seconds and peak memory, or the
    error it raises."""
    import torch

    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.wan_vae import WanVAEConfig, WanVideoVAE

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WanVAEConfig.wan()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    vae = init_params_(WanVideoVAE(cfg, device=dev), g)
    lat = torch.randn((1, cfg.z_dim, cfg.latent_frames(frames), h // 8, w // 8), generator=g,
                      device=dev)
    print(f"whole-sequence decode of {frames} frames of {h}x{w} ({smi}): latents "
          f"{tuple(lat.shape)}, "
          f"chunk_frames would take {vae.decoder.chunk_frames(lat.shape)}", flush=True)
    secs, gib, video = _timed(lambda: _wan_decode(vae, lat, chunk=lat.shape[2]))
    print(f"  whole-sequence decode: {secs:.3f} s, peak {gib:.2f} GiB, video "
          f"{tuple(video.shape)}, finite {bool(torch.isfinite(video).all())}", flush=True)


def _sets(overrides):
    """``--set`` arguments of a CLI for each override."""
    return [a for o in overrides for a in ("--set", o)]


def _loaded_differ(state, written, init, rounded=False):
    """(the names whose loaded tensor is not bitwise what was written, the
    LoRA factors that are not bitwise ``init``'s, the names in neither):
    with ``rounded``, fp32 tensors as the loader rounds them to bf16 first."""
    import torch

    def want(v):
        return v.to(torch.bfloat16) if rounded and v.dtype == torch.float32 else v

    differ = [k for k, v in written.items()
              if k not in state or not torch.equal(state[k].float(), want(v).float())]
    lora = [k for k, v in init.items()
            if k not in state or not torch.equal(state[k], v.to(state[k].device))]
    return differ, lora, sorted(set(state) - set(written) - set(init))


def _check_epoch(what, trainer, run_dir, kernels, want, start, jax_path, smi):
    """Print and check one epoch of ``cli.train`` from a directory: the
    launches against ``want``, finite metrics, every LoRA factor and its EMA
    moved from the loaded adapter ``start`` (port names, read through
    ``jax_path``)."""
    import numpy as np
    import torch

    counts = [k.launches for k in kernels]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    r = records[0]
    nb = int(trainer.config.sample.num_batches_per_epoch)
    start = {jax_path(k): v.cuda() for k, v in start.items()}
    lora, ema = trainer.state.lora, trainer.state.ema
    unchanged = {k for k, v in lora.items() if torch.equal(v, start[k])}
    ema_unchanged = {k for k, v in ema.items() if torch.equal(v, start[k])}
    bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
    print(f"  {what}: launches {counts} (expected {want}); rollout+decode "
          f"{r['time/rollout'] * nb:.3f} s, reward "
          f"{r['time/reward_wait']:.3f} s, train "
          f"{r['time/train']:.3f} s; reward {r['reward_avg']:.5f}, loss {r['loss']:.3e}, "
          f"approx_kl {r['approx_kl']:.3e}; LoRA {len(lora) - len(unchanged)} of {len(lora)} "
          f"tensors moved from the loaded adapter, EMA {len(ema) - len(ema_unchanged)}; {smi}",
          flush=True)
    if counts != want or len(records) != 1 or bad or unchanged or ema_unchanged:
        raise AssertionError(f"{what}: launches {counts} (expected {want}), {len(records)} "
                             f"records, non-finite {bad}, unchanged {sorted(unchanged)[:4]}, "
                             f"EMA unchanged {sorted(ema_unchanged)[:4]}")


def run_family_loader_slice(smi):
    """Phase: Flux.1-dev and Wan2.1-T2V-1.3B start from files. Writes, from
    the seed + 11, a Flux.1-dev diffusers directory (``transformer/`` bf16 in
    FAMILY_FLUX_SHARDS shards with their index, depth cut on disk to
    FAMILY_FLUX_DEPTH; ``vae/`` fp32) and a Wan2.1-T2V-1.3B one
    (``transformer/`` fp32 at full depth; ``vae/`` AutoencoderKLWan fp32,
    encoder included), in diffusers names (``hf_flux_state_dict``,
    ``hf_wan_state_dict``, ``hf_wan_vae_state_dict``) and published
    config.json keys. Loads each: every tensor bitwise as written (WAN's
    fp32 weights as rounded to bf16), LoRA A bitwise the numpy draws
    (``flux_lora_init``, ``wan_lora_init``), B zero. Then from the files:
    ``cli.infer`` on ``flux_smoke`` with ``FLUX_DIR`` at 512^2, FLUX_STEPS
    steps (launches of #1, #7, #2, #8 per ``flux_per_forward_counts``); one
    ``flux_smoke`` epoch at FLUX_TRAIN_OVERRIDES (adding #4, #9); the WAN
    VAE encoder on the card against the CPU in fp32 (WAN_ENCODE_REL_L2), and
    one encode of WAN_FRAMES frames of WAN_RES^2 timed with its peak memory;
    the demo path from ``WAN_DIR`` (WAN_STEPS steps, #1, #6, #7, #8 per
    ``wan_per_forward_counts``); one ``wan_smoke`` epoch at
    WAN_TRAIN_OVERRIDES (#9). A RANDOM-INIT warning is an error. Prints
    bytes and write / load seconds per directory, s/image, s/video, the
    epochs' seconds, peak device memory and host RSS."""
    import dataclasses
    import gc
    import resource
    import warnings

    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import common, infer, train
    from adv_grpo_torch.cli.wan_sde_demo import sample_video
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.flux import FluxConfig, FluxTransformer, flux_jax_lora_path
    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.vae import AutoencoderKL, VAEConfig
    from adv_grpo_torch.models.wan import WanConfig, WanTransformer, wan_jax_lora_path
    from adv_grpo_torch.models.wan_vae import WanVAEConfig, WanVideoVAE
    from adv_grpo_torch.ops import attention, fused_norms, joint_attention
    from adv_grpo_torch.rollout.wan import WanSamplerConfig
    from adv_grpo_torch.train.pipeline import _build

    flux_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                    joint_attention.joint_mha, attention.mha_bshd,
                    joint_attention.joint_attention_bwd, attention.mha_bshd_bwd)
    wan_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                   fused_norms.layer_norm, attention.mha_bshd, attention.mha_bshd_bwd)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def drawn(cls, cfg):
        module = init_params_(_build(cls, cfg, dev), gen)
        return {k: v.detach() for k, v in module.state_dict().items()}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    free()
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    env = {k: os.environ.get(k) for k in ("FLUX_DIR", "WAN_DIR")}
    epochs = {}
    with tempfile.TemporaryDirectory() as work, warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOM-INIT")
        # ── Flux.1-dev ──
        root = os.path.join(work, "flux")
        flux_dir = os.path.join(root, "transformer")
        preset = common.resolve_config("flux_smoke")
        rank, alpha = int(preset.train.lora_rank), float(preset.train.lora_alpha)
        n2, n1 = FAMILY_FLUX_DEPTH
        fcfg, fvcfg = FluxConfig.dev(num_double_layers=n2, num_single_layers=n1), VAEConfig.flux()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flux_sd, fvae_sd = hf_flux_state_dict(drawn(FluxTransformer, fcfg)), drawn(AutoencoderKL,
                                                                                 fvcfg)
        write_flux_dirs(root, flux_sd, fvae_sd, fcfg, fvcfg, shards=FAMILY_FLUX_SHARDS)
        write_s = time.perf_counter() - t0
        shards = [f for f in os.listdir(flux_dir) if f.endswith(".safetensors")]
        index = os.path.join(flux_dir, "diffusion_pytorch_model.safetensors.index.json")
        print(f"wrote a Flux.1-dev diffusers directory in {write_s:.2f} s: transformer "
              f"{_dir_bytes(flux_dir):,} B ({sum(v.numel() for v in flux_sd.values()):,} bf16 "
              f"values, depth cut on disk to {n2} of 19 double and {n1} of 38 single blocks, "
              f"{len(shards)} shards and their index), vae {_dir_bytes(os.path.join(root, 'vae')):,}"
              f" B (fp32); {smi}", flush=True)
        if len(shards) != FAMILY_FLUX_SHARDS or not os.path.exists(index):
            raise AssertionError(f"Flux shards {shards}, index {os.path.exists(index)}")
        (cfg, model), load_s = timed(convert.load_flux_transformer, flux_dir, lora_rank=rank,
                                     lora_alpha=alpha, device=dev)
        differ, lora_differ, extra = _loaded_differ(model.state_dict(), flux_sd,
                                                    convert.flux_lora_init(cfg))
        (vcfg, vae), vae_s = timed(convert.load_vae, os.path.join(root, "vae"), base=fvcfg,
                                    device=dev)
        vae_differ, _, vae_extra = _loaded_differ(vae.state_dict(), fvae_sd, {})
        print(f"load_flux_transformer(lora_rank={rank}) on the card in {load_s:.2f} s: "
              f"{len(flux_sd)} tensors bitwise the file's ({len(differ)} differ), "
              f"{len(convert.flux_lora_init(cfg))} LoRA factors bitwise the numpy "
              f"draws / zero ({len(lora_differ)} differ); load_vae (Flux) in {vae_s:.2f} s: "
              f"{len(fvae_sd)} tensors bitwise ({len(vae_differ)} differ), scaling "
              f"{vcfg.scaling_factor}, shift {vcfg.shift_factor}", flush=True)
        if (differ or lora_differ or extra or vae_differ or vae_extra
                or cfg != dataclasses.replace(fcfg, lora_rank=rank, lora_alpha=alpha)
                or vcfg != fvcfg):
            raise AssertionError(f"Flux load: {differ[:4]} {lora_differ[:4]} {extra[:4]} "
                                 f"{vae_differ[:4]}; {cfg}; {vcfg}")
        del model, vae, flux_sd, fvae_sd
        free()

        os.environ["FLUX_DIR"] = flux_dir
        held, generate = {}, infer.generate

        def held_generate(pipeline, *args, **kwargs):
            out, s = timed(generate, pipeline, *args, **kwargs)
            held.update(s=s, call=(pipeline,) + args, kwargs=kwargs)
            return out

        _zero_counts(flux_kernels)
        infer.generate = held_generate
        try:
            paths = infer.main(["--config", "flux_smoke", "--prompts", "a flower", "--out_dir",
                                os.path.join(work, "flux_infer"), "--device", "cuda"]
                               + _sets(["resolution=512", f"sample.eval_num_steps={FLUX_STEPS}"]))
        finally:
            infer.generate = generate
        counts = [k.launches for k in flux_kernels[:4]]
        want = [c * FLUX_STEPS for c in flux_per_forward_counts(fcfg)]
        img = np.asarray(Image.open(paths[0]))
        images, warm = timed(generate, *held["call"], **held["kwargs"])
        print(f"cli.infer flux_smoke from FLUX_DIR, 512^2 {FLUX_STEPS} steps guidance "
              f"{held['call'][0].guidance}: {held['s']:.3f} s/image (the pipeline's first "
              f"generate), {warm:.3f} s/image warm; PNG {img.shape}, pixel range "
              f"{img.min()}..{img.max()}; launches {counts} (LN, RMS, joint, BSHD; expected "
              f"{want}); {smi}", flush=True)
        if (counts != want or img.shape != (512, 512, 3) or img.min() == img.max()
                or not torch.isfinite(images).all()):
            raise AssertionError(f"Flux infer from files: launches {counts}, PNG {img.shape} "
                                 f"{img.min()}..{img.max()}")
        del held, images
        free()

        _zero_counts(flux_kernels)
        run_dir = os.path.join(work, "flux_run")
        trainer, epochs["flux_smoke"] = timed(train.main, [
            "--config", "flux_smoke", "--max_epochs", "1", "--device", "cuda", "--set",
            f"save_dir={run_dir}"] + _sets(FLUX_TRAIN_OVERRIDES))
        print(f"cli.train flux_smoke from FLUX_DIR, 1 epoch (FLUX_TRAIN_OVERRIDES): "
              f"{epochs['flux_smoke']:.2f} s wall (build included)", flush=True)
        want, _ = expected_flux_train_counts(trainer.config, trainer.pipeline.flux_cfg, epochs=1)
        _check_epoch("flux_smoke from files", trainer, run_dir, flux_kernels, want,
                     convert.flux_lora_init(trainer.pipeline.flux_cfg), flux_jax_lora_path, smi)
        del trainer
        free()

        # ── Wan2.1-T2V-1.3B ──
        root = os.path.join(work, "wan")
        wan_dir = os.path.join(root, "transformer")
        preset = common.resolve_config("wan_smoke")
        rank, alpha = int(preset.train.lora_rank), float(preset.train.lora_alpha)
        wcfg = WanConfig.t2v_1_3b(dtype=torch.float32)
        wvcfg = WanVAEConfig.wan(latents_mean=WAN_LATENTS_MEAN, latents_std=WAN_LATENTS_STD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wan_sd = hf_wan_state_dict(drawn(WanTransformer, wcfg))
        wvae_sd = hf_wan_vae_state_dict(drawn(WanVideoVAE, wvcfg))
        write_wan_dirs(root, wan_sd, wvae_sd, wcfg, wvcfg)
        write_s = time.perf_counter() - t0
        print(f"wrote a Wan2.1-T2V-1.3B diffusers directory in {write_s:.2f} s: transformer "
              f"{_dir_bytes(wan_dir):,} B ({sum(v.numel() for v in wan_sd.values()):,} fp32 "
              f"values, {wcfg.num_layers} layers, one file), vae "
              f"{_dir_bytes(os.path.join(root, 'vae')):,} B (fp32, encoder and decoder); {smi}",
              flush=True)
        (cfg, model), load_s = timed(convert.load_wan_transformer, wan_dir, lora_rank=rank,
                                     lora_alpha=alpha, device=dev)
        differ, lora_differ, extra = _loaded_differ(model.state_dict(), wan_sd,
                                                    convert.wan_lora_init(cfg), rounded=True)
        moved = sum(not torch.equal(v.to(torch.bfloat16).float(), v) for v in wan_sd.values())
        (vcfg, vae), vae_s = timed(convert.load_wan_vae, os.path.join(root, "vae"), device=dev)
        vae_differ, _, vae_extra = _loaded_differ(vae.state_dict(), wvae_sd, {})
        print(f"load_wan_transformer(lora_rank={rank}) on the card in {load_s:.2f} s: "
              f"{len(wan_sd)} tensors bitwise the file's rounded to bf16 ({moved} changed by the "
              f"rounding; {len(differ)} differ), {len(convert.wan_lora_init(cfg))} LoRA factors "
              f"bitwise the numpy draws / zero ({len(lora_differ)} differ); load_wan_vae in "
              f"{vae_s:.2f} s: {len(wvae_sd)} tensors bitwise ({len(vae_differ)} differ), "
              f"latent statistics as written {vcfg == wvcfg}", flush=True)
        if (differ or lora_differ or extra or vae_differ or vae_extra or not moved
                or cfg != WanConfig.t2v_1_3b(lora_rank=rank, lora_alpha=alpha)
                or vcfg != wvcfg):
            raise AssertionError(f"WAN load: {differ[:4]} {lora_differ[:4]} {extra[:4]} "
                                 f"{vae_differ[:4]}; {cfg}; {vcfg}")
        del model, wan_sd, wvae_sd
        free()

        # the encoder on the card against the CPU, in fp32 (TF32 off, as the
        # pipelines set it), then one encode at the sampled size
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cpu_vae = _build(WanVideoVAE, vcfg, torch.device("cpu"))
        cpu_vae.load_state_dict(vae.state_dict())
        clip = torch.rand((1, 3, 5, 64, 64), generator=torch.Generator().manual_seed(SEED + 12))
        with torch.inference_mode():
            ref = cpu_vae.encode_raw(clip * 2 - 1)
            got = vae.encode_raw((clip * 2 - 1).to(dev))
        errs = {name: (_rel_l2(g.cpu(), r), (g.cpu() - r).abs().max().item())
                for name, g, r in zip(("mean", "logvar"), got, ref)}
        del cpu_vae
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        video = torch.rand((1, 3, WAN_FRAMES, WAN_RES, WAN_RES), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 12)) * 2 - 1
        with torch.inference_mode():
            (mean, logvar), enc_s = timed(vae.encode_raw, video)
        enc_peak = torch.cuda.max_memory_allocated()
        print(f"WAN VAE encoder from the file, full width fp32, card against CPU on a 5-frame "
              f"64^2 clip: relative L2 / max abs mean {errs['mean'][0]:.3e} / "
              f"{errs['mean'][1]:.3e}, logvar {errs['logvar'][0]:.3e} / {errs['logvar'][1]:.3e}"
              f" (bound {WAN_ENCODE_REL_L2:g}); one encode of {WAN_FRAMES} frames of "
              f"{WAN_RES}^2 -> {tuple(mean.shape)} in {enc_s:.3f} s (first call), peak device "
              f"memory {enc_peak / 2**30:.2f} GiB; {smi}", flush=True)
        if (max(e[0] for e in errs.values()) > WAN_ENCODE_REL_L2
                or tuple(mean.shape) != (1, 16, vcfg.latent_frames(WAN_FRAMES), WAN_RES // 8,
                                         WAN_RES // 8)
                or not (torch.isfinite(mean).all() and torch.isfinite(logvar).all())):
            raise AssertionError(f"WAN encoder: {errs}, {tuple(mean.shape)}")
        del vae, video, mean, logvar, got
        free()
        torch.cuda.reset_peak_memory_stats()

        os.environ["WAN_DIR"] = wan_dir
        config = common.apply_overrides(common.resolve_config("wan_smoke"),
                                        [f"resolution={WAN_RES}", f"sample.num_frames={WAN_FRAMES}"])
        pipeline, build_s = timed(common.build_pipeline, config, device="cuda", frames=WAN_FRAMES)
        text = torch.from_numpy(common.build_text_encoder(config, pipeline)(
            ["a cat on a skateboard"])[0]).to(dev)
        latents = pipeline.prepare_latents(torch.Generator(device=dev).manual_seed(SEED), 1)
        _zero_counts(wan_kernels[:4])
        (out, video), wall = timed(sample_video, pipeline, latents, text,
                                   WanSamplerConfig(num_steps=WAN_STEPS),
                                   torch.Generator(device=dev).manual_seed(SEED + 1))
        counts, cross = [k.launches for k in wan_kernels[:4]], wan_kernels[3].cross_launches
        want = [c * WAN_STEPS for c in wan_per_forward_counts(pipeline.wan_cfg)]
        print(f"WAN demo path from WAN_DIR (build_pipeline in {build_s:.2f} s), {WAN_FRAMES} "
              f"frames of {WAN_RES}^2 ({tuple(latents.shape)} latents, {text.shape[1]} text "
              f"tokens), {WAN_STEPS} steps: {wall:.2f} s/video (first call, VAE decode "
              f"included); video {tuple(video.shape)}; launches {counts} (modulated LN, RMS, LN, "
              f"BSHD; expected {want}), {cross} of the BSHD ones cross-attention; {smi}",
              flush=True)
        if (counts != want or cross != want[3] // 2
                or tuple(video.shape) != (1, WAN_FRAMES, 3, WAN_RES, WAN_RES)
                or text.shape[1] != WAN_TEXT or not torch.isfinite(video).all()
                or not torch.isfinite(out.log_probs).all()):
            raise AssertionError(f"WAN from files: launches {counts} ({cross} cross), video "
                                 f"{tuple(video.shape)}, text {tuple(text.shape)}")
        del pipeline, out, video, latents, text
        free()

        _zero_counts(wan_kernels)
        run_dir = os.path.join(work, "wan_run")
        trainer, epochs["wan_smoke"] = timed(train.main, [
            "--config", "wan_smoke", "--max_epochs", "1", "--device", "cuda", "--set",
            f"save_dir={run_dir}"] + _sets(WAN_TRAIN_OVERRIDES))
        cross = [k.cross_launches for k in wan_kernels[3:]]
        want, _ = expected_wan_train_counts(trainer.config, trainer.pipeline.wan_cfg, epochs=1)
        print(f"cli.train wan_smoke from WAN_DIR, 1 epoch (WAN_TRAIN_OVERRIDES): "
              f"{epochs['wan_smoke']:.2f} s wall (build included); {cross} of the BSHD launches "
              f"cross-attention", flush=True)
        _check_epoch("wan_smoke from files", trainer, run_dir, wan_kernels, want,
                     convert.wan_lora_init(trainer.pipeline.wan_cfg), wan_jax_lora_path, smi)
        if cross != [want[3] // 2, want[4] // 2]:
            raise AssertionError(f"WAN epoch from files: cross-attention launches {cross}")
        del trainer
        free()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    peak = max(peak_before, torch.cuda.max_memory_allocated())
    print(f"family loader phase: {time.perf_counter() - phase_t0:.1f} s of wall time (the epochs "
          f"from the files {({k: round(v, 2) for k, v in epochs.items()})} s); peak device "
          f"memory {peak / 2**30:.2f} GiB, the process's peak host RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB; {smi}",
          flush=True)


def _bwd_fp64(q, k, v, o, lse, do, sm_scale):
    """(dq, dk, dv) of #11's math in fp64 from the same inputs, lse and o,
    one (batch item, head) at a time."""
    import torch

    outs = [torch.empty(t.shape, dtype=torch.float64, device=t.device) for t in (q, k, v)]
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            qf, kf, vf, dof = (t[b, h].double() for t in (q, k, v, do))
            p = torch.exp(qf @ kf.T * sm_scale - lse[b, h].double()[:, None])
            di = (o[b, h].double() * dof).sum(-1, keepdim=True)
            ds = p * (dof @ vf.T - di) * sm_scale
            outs[0][b, h], outs[1][b, h], outs[2][b, h] = ds @ kf, ds.T @ qf, p.T @ dof
            del p, ds
    return outs


def check_mha_kernels():
    """Phase: kernels #10 (``mha_fwd_bf16``) and #11 (``mha_bwd_bf16``) of
    ``mha`` on (B, H, S, D) against their plain versions at MHA_SHAPES: the
    output within MHA_O_REL_L2 relative L2 and the lse within MHA_LSE_ABS
    absolute of fp32 ``attention_reference``, dq, dk, dv within 2e-2
    relative L2 of
    ``flash_bwd_reference`` on the same o and lse; at the WAN shape #11's
    fidelity against fp64 (FIDELITY_FACTOR), with #9's order (bf16 p and t)
    beside it. Median times beside the plain versions' and SDPA's on the
    same function (the keys before kv_len)."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    results = []
    for name, b, h, sq, skv, d, kv_len in MHA_SHAPES:
        q, do = randn(b, h, sq, d), randn(b, h, sq, d)
        k, v = randn(b, h, skv, d), randn(b, h, skv, d)
        kv, sm = skv if kv_len is None else kv_len, d ** -0.5
        shape = f"({b},{h},{sq}x{skv},{d}) kv_len={kv_len}"
        o, lse = attention.mha_fwd(q, k, v, sm, kv_len, want_lse=True)
        ref, ref_lse = attention.attention_reference(q.float(), k.float(), v.float(), sm_scale=sm,
                                                     kv_len=kv_len, return_lse=True)
        err = _check_attn_out(f"mha (#10) {shape} vs fp32", o, ref, lse, ref_lse)
        del ref, ref_lse
        ms = _median_ms(lambda: attention.mha(q, k, v, kv_len=kv_len))
        plain_ms = _median_ms(lambda: attention.attention_reference(q, k, v, sm_scale=sm,
                                                                    kv_len=kv_len), iters=5)
        k_on, v_on = k[:, :, :kv], v[:, :, :kv]  # the keys the mask leaves
        lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(q, k_on, v_on))
        least = _attn_bound((q, k, v, o), b, h, sq, kv, d)
        print(f"kernel mha (#10) {shape}: max abs err {err:.3e} (output and lse); median "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA {lib_ms:.4f} ms; bound "
              f"{least[0]:.4f} ms ({least[1]})", flush=True)
        results.append(_entry(f"mha_{name}", FWD_SM90_SOURCE,
                              "adv_grpo_tpu/ops/attention.py:104", err, ms, plain_ms, least,
                              lib_ms))

        got = attention.mha_bwd(q, k, v, o, lse, do, sm_scale=sm, kv_len=kv_len)
        twin = attention.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                             do.float(), sm_scale=sm, kv_len=kv_len)
        max_abs = _check_rel_l2(f"mha_bwd (#11) {shape} kernel vs flash_bwd_reference "
                                "(dq, dk, dv)", got, twin)
        if name == "wan":  # fidelity against fp64
            exact = _bwd_fp64(q, k, v, o, lse, do, sm)
            di = (o.float() * do.float()).sum(-1)
            nine = attention.flash_bwd_reference(q, k, v, o, lse, do, sm_scale=sm, di=di,
                                                 round_to=torch.bfloat16)
            rows = {"#11 kernel": got, "fp32 twin in bf16": [t.to(torch.bfloat16) for t in twin],
                    "#9's order (bf16 p, t)": nine}
            errs = {k_: [_rel_l2(a, e) for a, e in zip(v_, exact)] for k_, v_ in rows.items()}
            for k_, e in errs.items():
                print(f"  fidelity at WAN: {k_} vs fp64, relative L2 (dq, dk, dv) "
                      f"{', '.join(f'{x:.3e}' for x in e)}", flush=True)
            ratios = [a / t for a, t in zip(errs["#11 kernel"], errs["fp32 twin in bf16"])]
            print(f"  fidelity ratio kernel / twin-in-bf16 {', '.join(f'{r:.3f}' for r in ratios)} "
                  f"(bound {FIDELITY_FACTOR})", flush=True)
            if not all(r <= FIDELITY_FACTOR for r in ratios):
                raise AssertionError(f"mha_bwd fidelity ratios {ratios} above {FIDELITY_FACTOR}")
            del exact, nine, rows
        del twin
        ms = _median_ms(lambda: attention.mha_bwd(q, k, v, o, lse, do, sm_scale=sm,
                                                  kv_len=kv_len))
        plain_ms = _median_ms(lambda: attention.flash_bwd_reference(
            q, k, v, o, lse, do, sm_scale=sm, kv_len=kv_len), iters=3, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q, k_on, v_on)]
        out = F.scaled_dot_product_attention(*leaves)
        lib_ms = _grad_ms((out,), leaves, (do,))
        del out, leaves
        least = _attn_bound((q, k, v, o, lse, do) + tuple(got), b, h, sq, kv, d, products=5)
        print(f"kernel mha_bwd (#11) {shape}: median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
              f"SDPA backward {lib_ms:.4f} ms; bound {least[0]:.4f} ms ({least[1]})", flush=True)
        results.append(_entry(f"mha_bwd_{name}", BWD_SM90_SOURCE,
                              "adv_grpo_tpu/ops/attention.py:201", max_abs, ms, plain_ms, least,
                              lib_ms))
        del q, k, v, do, o, lse, got, k_on, v_on
    torch.cuda.empty_cache()
    return results


def init_group():
    """A one-rank NCCL process group through ``parallel.mesh`` on a free
    localhost port; returns its address."""
    import socket

    from adv_grpo_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    addr = f"tcp://127.0.0.1:{port}"
    mesh.init_distributed(device="cuda", init_method=addr, world_size=1, rank=0)
    return addr


def run_context_parallel():
    """Phase, under the one-rank NCCL group: ``context_parallel_attention``
    forward and backward at each of MHA_SHAPES (the gather and its
    reduce-scatter run as collectives; #10 exactly once per forward, #11
    once per backward, the S_q != S_kv ones counted apart), against the fp32
    plain attention and its autograd (the output within MHA_O_REL_L2, the
    gradients within 2e-2 relative L2); then
    ``ring_attention`` at the WAN shape against ``mha``, forward and
    gradients. Returns {row name: launches}."""
    import torch
    import torch.distributed as dist

    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops.ring_attention import context_parallel_attention, ring_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    print(f"process group: {dist.get_backend()}, world size {dist.get_world_size()}", flush=True)
    counts = {}
    for name, b, h, sq, skv, d, kv_len in MHA_SHAPES:
        leaves = [randn(b, h, sq, d).requires_grad_(), randn(b, h, skv, d).requires_grad_(),
                  randn(b, h, skv, d).requires_grad_()]
        do = randn(b, h, sq, d)
        for f in (attention.mha, attention.mha_bwd):
            f.launches = f.cross_launches = 0
        o = context_parallel_attention(*leaves, kv_len=kv_len)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        got = (attention.mha.launches, attention.mha_bwd.launches, attention.mha.cross_launches,
               attention.mha_bwd.cross_launches)
        want = (1, 1, int(sq != skv), int(sq != skv))
        counts[f"mha_{name}"], counts[f"mha_bwd_{name}"] = got[:2]
        f32 = [t.detach().float().requires_grad_() for t in leaves]
        ref = attention.attention_reference(*f32, sm_scale=d ** -0.5, kv_len=kv_len)
        ref_grads = torch.autograd.grad(ref, f32, do.float())
        print(f"context_parallel_attention ({b},{h},{sq}x{skv},{d}) kv_len={kv_len}: launches "
              f"#10/#11 {got[0]}/{got[1]}, S_q != S_kv {got[2]}/{got[3]} (expected {want})",
              flush=True)
        _check_attn_out("its output vs fp32", o, ref)
        _check_rel_l2("  its gradients vs fp32 autograd (dq, dk, dv)", grads, ref_grads)
        if got != want:
            raise AssertionError(f"context_parallel_attention {name}: launches {got}")
        del leaves, o, grads, f32, ref, ref_grads

    b, h, s, d = 1, 12, 8100, 128
    leaves = [randn(b, h, s, d).requires_grad_() for _ in range(3)]
    do = randn(b, h, s, d)
    t0 = time.perf_counter()
    o = ring_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    o_ref = attention.mha(*leaves)
    ref_grads = torch.autograd.grad(o_ref, leaves, do)
    print(f"ring_attention (1,12,8100,128), one rank: {wall:.3f} s forward + backward (plain "
          f"fp32)", flush=True)
    _check_attn_out("its output vs mha's", o, o_ref)
    _check_rel_l2("  its gradients vs mha's (dq, dk, dv)", grads, ref_grads)
    del leaves, o, grads, o_ref, ref_grads
    torch.cuda.empty_cache()
    return counts


def sd3_attention_ms(tree):
    """``--sd3-attention-ms TREE``: the ``adv_grpo_torch`` in the checkout at
    TREE times its joint forwards as the models call them (no lse): #2
    (``joint_mha``) and #3 (``mha_rms``) at SD3.5-M's CFG batch 2 and 8
    (1024 image + 154 text tokens, 24 heads of 64, qk-RMS) and #2 at
    Flux.1-dev's B = 1 and 4 (1024 + 512, 24 heads of 128, no RMS), the
    JOINT_CASES: median ms of 50 CUDA-event-timed calls after 5 warm-ups
    (the wrapper's host time included), device kernel ms (mean of 20 traced
    calls) and the wrapper's host ms per call; then the (output, lse) max
    abs error against fp32 of
    every JOINT_CASES and JOINT_EDGES case; and the attention forwards'
    registers when this process built the tree's kernels; one JSON line."""
    sys.path.insert(0, tree)
    import re

    from adv_grpo_torch.kernels import build
    from adv_grpo_torch.ops import joint_attention as ja

    out = {"module": ja.__file__}
    for case in JOINT_CASES:
        name, _, _, s_t, h, _, _ = case
        streams, w = joint_inputs(case)
        if s_t:
            fn = lambda: ja.joint_mha(*streams, num_heads=h, rms_weights=w)  # noqa: E731
        else:
            fn = lambda: ja.mha_rms(*streams[:3], num_heads=h,  # noqa: E731
                                    rms_weights=w and w[:2])
        out[f"{'joint_mha' if s_t else 'mha_rms'} {name}"] = (
            _median_ms(fn, iters=50, warmup=5), _profile_forward(fn, reps=20)[0], _host_ms(fn))
        del streams, w, fn
    out["errors"] = {case[0]: joint_errors(ja, case)[:2] for case in JOINT_CASES + JOINT_EDGES}
    # ptxas's registers per thread of the attention forwards, when this
    # process built the tree's kernels: {mangled kernel name: registers}
    registers, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "attn_fwd" in entry:
            registers[entry] = int(m.group(1))
    out["registers"] = registers
    print(json.dumps(out), flush=True)


def sd3_forward_ms(tree):
    """``--sd3-forward-ms TREE``: one MMDiT forward of ``eval_sd3_fast`` (random
    weights from the seed) of the ``adv_grpo_torch`` in the checkout at TREE,
    at CFG batch 2 and 8: median ms of 7 CUDA-event-timed forwards after 3
    warm-ups, device kernel ms (mean of 3 traced forwards) and the host's ms
    per forward; the kernel ms of its joint forwards (#2, #3) and the host
    ms spent in their wrappers (mean of 5 forwards, each synchronized, so no
    launch waits for the device); one JSON line."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import adv_grpo_torch
    from adv_grpo_torch.cli.common import (apply_overrides, build_pipeline,
                                           build_text_encoder, resolve_config)
    from adv_grpo_torch.models import mmdit

    spent = [0.0]

    def timed(f):  # the host time of every call of f
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return call

    mmdit.joint_mha, mmdit.mha_rms = timed(mmdit.joint_mha), timed(mmdit.mha_rms)

    config = apply_overrides(resolve_config("eval_sd3_fast"), ["pretrained.model=''"])
    pipeline = build_pipeline(config)
    encode = build_text_encoder(config, pipeline)
    vfn = pipeline.velocity_fn()
    out, joint, wrapper = {"module": adv_grpo_torch.__file__}, {}, {}
    for n in (2, 8):
        emb, pooled = (torch.from_numpy(np.asarray(a)).cuda()
                       for a in encode(["a flower"] * (n // 2) + [""] * (n // 2)))
        x = pipeline.prepare_latents(torch.Generator(device="cuda").manual_seed(SEED), n)
        t = torch.full((n,), 500.0, device="cuda")
        fn = lambda: vfn(x, t, emb, pooled)  # noqa: E731
        with torch.inference_mode():
            ms = _median_ms(fn, iters=7, warmup=3)
            kernel_ms, groups = _profile_forward(fn, reps=3)
            out[f"forward B{n}"] = (ms, kernel_ms, _host_ms(fn, calls=3))
            spent[0] = 0.0
            for _ in range(5):
                fn()
                torch.cuda.synchronize()
        joint[f"B{n}"] = groups.get("joint attention forward", (0, 0.0))[1]
        wrapper[f"B{n}"] = spent[0] * 1e3 / 5
    out["joint forward kernel ms"] = joint
    out["joint wrapper host ms"] = wrapper
    print(json.dumps(out), flush=True)


# ``--attention-bwd-ab``: #9 at Flux's (1,1536,3072), WAN self and WAN cross
# (name, B, S_q, S_kv, H, D), #11 at MHA_SHAPES, and the joint backward at
# the JOINT_CASES but Flux's B = 4: #4 at SD3.5-M's CFG batch 2 and 8 and
# Flux.1-dev's B = 1, #5 at (2, 1024) and (8, 1024)
BWD_AB_BSHD = (("flux", 1, 1536, 1536, 24, 128), ("wan_self", 1, 8100, 8100, 12, 128),
               ("wan_cross", 1, 8100, WAN_TEXT, 12, 128))
BWD_AB_JOINT = tuple(c for c in JOINT_CASES if c[0] != "flux_b4")
# ``--attention-fwd-ab``: #8 at Flux's single blocks (B = 1 and 4), WAN self
# and WAN cross, and #10 at MHA_SHAPES
FWD_AB_BSHD = (("flux", 1, 1536, 1536, 24, 128), ("flux_b4", 4, 1536, 1536, 24, 128),
               ("wan_self", 1, 8100, 8100, 12, 128), ("wan_cross", 1, 8100, WAN_TEXT, 12, 128))


def _joint_bwd_fp32(streams, do, w, heads):
    """The joint backward in fp32 from the bf16 inputs of one or two streams
    (q, k, v each; ``w`` None or their (wq, wk) weights, in the streams'
    order): the lse and di of the fp32 forward (contiguous (B, H, S) per
    stream) and the cotangents dyq, dyk (of the RMS-normalised q, k) and dv
    per stream, with no rounding but the inputs'; a reference that no tree's
    code computes."""
    import torch

    from adv_grpo_torch.ops.attention import from_bhsd, to_bhsd

    n = len(do)
    f = [to_bhsd(t, heads).float() for t in streams]
    sm_scale = f[0].shape[-1] ** -0.5
    ws = w or [None] * (2 * n)

    def rms(x, wx):
        return x if wx is None else x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * wx

    yq = torch.cat([rms(f[3 * i], ws[2 * i]) for i in range(n)], 2)
    yk = torch.cat([rms(f[3 * i + 1], ws[2 * i + 1]) for i in range(n)], 2)
    v = torch.cat([f[3 * i + 2] for i in range(n)], 2)
    dof = torch.cat([to_bhsd(c, heads).float() for c in do], 2)
    s = yq @ yk.transpose(-1, -2) * sm_scale
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    di = ((p @ v) * dof).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.transpose(-1, -2) - di)
    del s, p
    dyk, dyq = ds.transpose(-1, -2) @ yq * sm_scale, ds @ yk * sm_scale
    lens = [c.shape[1] for c in do]

    def split(a):
        return [from_bhsd(c) for c in a.split(lens, 2)]

    stats = [[c[..., 0].contiguous() for c in a.split(lens, 2)] for a in (lse, di)]
    return stats[0], stats[1], [g for trip in zip(split(dyq), split(dyk), split(dv)) for g in trip]


def _kernel_split(fn, reps=10):
    """{kernel name: device ms per call} of ``fn`` (torch.profiler over
    ``reps`` warm calls)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            m = re.search(r"\w+_kernel(<[^>(]*>)?", e.key)
            k = m[0] if m else e.key[:40]
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def attention_bwd_ms(tree):
    """``--attention-bwd-ms TREE``: the ``adv_grpo_torch`` in the checkout at
    TREE times its attention backward wrappers, #9 (``mha_bshd_bwd``) at
    BWD_AB_BSHD, #11 (``mha_bwd``) at MHA_SHAPES, and #4
    (``joint_attention_bwd``) and #5 (``mha_rms_bwd``) at BWD_AB_JOINT: median
    ms of 50 CUDA-event-timed calls after 5 warm-ups (the wrapper's host time
    and its scratch zeroing included) and device kernel ms per call (mean of
    10 traced calls, every kernel the call launches), and for #4 / #5 the
    wrapper's host ms per call and the largest relative L2 error of its
    cotangents against fp32 (:func:`_joint_bwd_fp32`, whose lse and di both
    trees are given: the inputs are the same) with the largest max abs, and
    its device ms by kernel (``split``); ptxas's registers and spill
    stores of the attention backwards when this process built the tree's
    kernels; one JSON line."""
    sys.path.insert(0, tree)
    import re

    import torch

    from adv_grpo_torch.kernels import build
    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops import joint_attention as ja

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out = {"module": attention.__file__}
    for name, b, sq, skv, h, d in BWD_AB_BSHD:
        q, do, k, v = randn(b, sq, h * d), randn(b, sq, h * d), randn(b, skv, h * d), randn(
            b, skv, h * d)
        o, lse = attention.mha_bshd_fwd(q, k, v, h, d ** -0.5, None, want_lse=True)
        di = attention.bwd_row_stats(o, do, h)
        fn = lambda: attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=h)  # noqa: E731
        out[f"#9 {name}"] = (_median_ms(fn, iters=50, warmup=5), _profile_forward(fn, reps=10)[0])
        del q, do, k, v, o, lse, di
    for name, b, h, sq, skv, d, kv_len in MHA_SHAPES:
        q, do, k, v = randn(b, h, sq, d), randn(b, h, sq, d), randn(b, h, skv, d), randn(
            b, h, skv, d)
        o, lse = attention.mha_fwd(q, k, v, d ** -0.5, kv_len, want_lse=True)
        fn = lambda: attention.mha_bwd(q, k, v, o, lse, do, sm_scale=d ** -0.5,  # noqa: E731
                                       kv_len=kv_len)
        out[f"#11 {name}"] = (_median_ms(fn, iters=50, warmup=5),
                              _profile_forward(fn, reps=10)[0])
        del q, do, k, v, o, lse
    errors, split = {}, {}
    for case in BWD_AB_JOINT:
        name, b, s_i, s_t, h, d, rms = case
        streams, w = joint_inputs(case)
        do = [randn(b, s, h * d) for s in (s_i, s_t) if s]
        if not s_t:
            streams, w = streams[:3], w and w[:2]
        lse, di, ref = _joint_bwd_fp32(streams, do, w, h)
        if s_t:
            fn = lambda: ja.joint_attention_bwd(  # noqa: E731
                *streams, *do, *lse, *di, num_heads=h, rms_weights=w)
        else:
            fn = lambda: ja.mha_rms_bwd(  # noqa: E731
                *streams, *do, *lse, *di, num_heads=h, rms_weights=w)
        got = fn()
        errors[name] = [max(_rel_l2(a, r) for a, r in zip(got, ref)),
                        max((a.float() - r).abs().max().item() for a, r in zip(got, ref))]
        split[name] = _kernel_split(fn)
        del ref, got
        out[f"#{4 if s_t else 5} {name}"] = (_median_ms(fn, iters=50, warmup=5),
                                             _profile_forward(fn, reps=10)[0], _host_ms(fn))
        del streams, do, lse, di, fn
    out["errors"], out["split"] = errors, split
    out["error_names"] = ["largest relative L2 against fp32", "largest max abs"]
    registers, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line) or re.search(r"(\d+) bytes spill stores", line)
        if m and entry and "attn_bwd" in entry:
            registers.setdefault(entry, []).append(int(m.group(1)))
    out["registers"] = {e: f"{r[0]} bytes of spill stores, {r[-1]}" for e, r in registers.items()}
    print(json.dumps(out), flush=True)


def attention_fwd_ms(tree):
    """``--attention-fwd-ms TREE``: the ``adv_grpo_torch`` in the checkout at
    TREE times its attention forwards as the models call them, #8
    (``mha_bshd``, no lse) at FWD_AB_BSHD on q, k, v read in place from a
    fused projection (self: one (B, S, 3*H*D) tensor; cross: q alone, k and v
    from one (B, S_kv, 2*H*D) tensor) and #10 (``mha``) at MHA_SHAPES: median
    ms of 50 CUDA-event-timed calls after 5 warm-ups (the wrapper's host time
    included) and device kernel ms per call (mean of 10 traced calls); one
    JSON line."""
    sys.path.insert(0, tree)
    import torch

    from adv_grpo_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out = {"module": attention.__file__}
    for name, b, sq, skv, h, d in FWD_AB_BSHD:
        hd = h * d
        if sq == skv:
            q, k, v = randn(b, sq, 3 * hd).split(hd, dim=-1)
        else:
            q, (k, v) = randn(b, sq, hd), randn(b, skv, 2 * hd).split(hd, dim=-1)
        fn = lambda: attention.mha_bshd(q, k, v, num_heads=h)  # noqa: E731
        out[f"#8 {name}"] = (_median_ms(fn, iters=50, warmup=5), _profile_forward(fn, reps=10)[0])
        del q, k, v
    for name, b, h, sq, skv, d, kv_len in MHA_SHAPES:
        q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
        fn = lambda: attention.mha(q, k, v, kv_len=kv_len)  # noqa: E731
        out[f"#10 {name}"] = (_median_ms(fn, iters=50, warmup=5),
                              _profile_forward(fn, reps=10)[0])
        del q, k, v
    print(json.dumps(out), flush=True)


def generic_ms(tree):
    """``--generic-ms TREE``: the ``adv_grpo_torch`` in the checkout at TREE
    runs the generic kernels at the full-width fp32 rows (KR_FULL), forward
    and backward through the wrappers as ``_kr_attn_full`` calls them: median
    ms of 20 CUDA-event-timed calls after 3 warm-ups, device kernel ms per
    call (mean of 10 traced calls, every kernel the call launches), the
    host's ms per call (20 enqueued back to back) and the device ms by
    kernel (``split``), and each direction's relative L2 error against the
    plain twin on the same inputs (each row's drawn from its own seed);
    ptxas's registers and spill stores of the generic kernels where this
    process built them. TF32 off for the twins. One JSON line."""
    sys.path.insert(0, tree)
    import re

    import torch

    from adv_grpo_torch.kernels import build
    from adv_grpo_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, errors, split = {"module": attention.__file__}, {}, {}
    for i, (name, mode, shape, d, rms) in enumerate(KR_FULL):
        g = torch.Generator(device="cuda").manual_seed(SEED + 230 + i)
        streams, pairs, h = _kr_inputs(mode, torch.float32, d, shape, g, rms)
        kv_len = shape[-1] if mode in ("bshd", "bhsd") else None
        ref, ref_lse = _kr_plain_fwd(mode, streams, pairs, h, d, kv_len)

        def fwd():
            return _kr_fwd(mode, streams, pairs, h, d, kv_len)

        def bwd():
            return _kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse, False)

        outs = fwd()[0]
        pairs_b = [(a, b) for gs, ws in zip(bwd(), _kr_bwd(mode, streams, pairs, h, d, kv_len,
                                                           ref, ref_lse, True))
                   for a, b in zip(gs, ws) if b.numel()]
        errors[f"{name} {mode}"] = [max(_rel_l2(o, r) for o, r in zip(outs, ref)),
                                    max(_rel_l2(a, b) for a, b in pairs_b)]
        del outs, pairs_b
        for direction, fn in (("forward", fwd), ("backward", bwd)):
            key = f"{name} {mode} {direction}"
            out[key] = (_median_ms(fn), _profile_forward(fn, reps=10)[0], _host_ms(fn, calls=20))
            split[key] = {k: round(v, 4) for k, v in _kernel_split(fn).items()}
        del streams, ref, ref_lse
        torch.cuda.empty_cache()
    out["errors"], out["split"] = errors, split
    out["error_names"] = ["forward relative L2 against the twin",
                          "backward relative L2 against the twin"]
    registers, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line) or re.search(r"(\d+) bytes spill stores", line)
        if m and entry and "attn_generic" in entry:
            registers.setdefault(entry, []).append(int(m.group(1)))
    out["registers"] = {e: f"{r[0]} bytes of spill stores, {r[-1]}" for e, r in registers.items()}
    print(json.dumps(out), flush=True)


# ``--norms-ab``: (name, kernel #, B, S, D). #1 at SD3.5-M's image and text
# streams at CFG batch 2, the image stream at batch 8, Flux.1-dev's image
# stream and WAN's video tokens, scale and shift strided chunks of one
# modulation row as the blocks make them; #6 at WAN's cross-attention input
# (B = 1 sampling, 2 training); #7 beside them, which the change must leave
# as it was: Flux's 24 heads of 128 and WAN's one 1536-wide head, q a column
# slice of the fused q/k/v projection
NORM_AB_CASES = (("sd3_img", 1, 2, 1024, 1536), ("sd3_txt", 1, 2, 154, 1536),
                 ("sd3_b8", 1, 8, 1024, 1536), ("flux", 1, 1, 1024, 3072),
                 ("wan", 1, 1, 8100, 1536), ("wan", 6, 1, 8100, 1536),
                 ("wan_b2", 6, 2, 8100, 1536), ("flux", 7, 1, 1536, 3072),
                 ("wan", 7, 1, 8100, 1536))


def norms_ms(tree):
    """``--norms-ms TREE``: the ``adv_grpo_torch`` in the checkout at TREE
    times its row norms as the models call them, at NORM_AB_CASES: each call
    and, where one PyTorch call computes the same function (#1 at one batch
    item: ``F.layer_norm`` with weight 1 + scale and bias shift; #6:
    ``F.layer_norm``; #7: ``F.rms_norm`` with the weight in bf16, whatever
    kernels it launches), that call (key ``lib ...``), each by :func:`_three_ms`;
    each case's largest error against fp32 on the same inputs (bf16 spacings,
    as chip_smoke.py's gates take them, and max abs); ptxas's registers and
    spill stores of the norm kernels when this process built the tree's
    kernels; one JSON line."""
    sys.path.insert(0, tree)
    import re

    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.kernels import build
    from adv_grpo_torch.ops import fused_norms as norms

    out, errors = {"module": norms.__file__}, {}
    for i, (name, k, b, s, d) in enumerate(NORM_AB_CASES):
        g = torch.Generator(device="cuda").manual_seed(SEED + 60 + i)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

        lib = None
        if k == 1:
            x = randn(b, s, d) + randn(b, 1, d)
            mods = randn(b, 6 * d, scale=0.5)
            sc, sh = mods[:, d:2 * d], mods[:, :d]
            call = lambda: norms.modulated_layer_norm(x, sc, sh)  # noqa: E731
            ref = norms.lnmod_reference(x.float(), sc.float(), sh.float(), 1e-6, torch.float32)
            nbytes = _nbytes(x, x, sc, sh)
            if b == 1:
                w_mod, b_mod = 1.0 + sc[0], sh[0]
                lib = lambda: F.layer_norm(x, (d,), w_mod, b_mod, 1e-6)  # noqa: E731
        elif k == 6:
            x = randn(b, s, d, scale=2.0) + randn(b, 1, d)
            call = lambda: norms.layer_norm(x)  # noqa: E731
            ref = norms.ln_reference(x.float(), 1e-6, torch.float32)
            nbytes = _nbytes(x, x)
            lib = lambda: F.layer_norm(x, (d,), eps=1e-6)  # noqa: E731
        else:
            heads = d // 128 if name == "flux" else 1
            x = (randn(b, s, 3 * d) + 0.3)[..., :d] if name == "wan" else randn(b, s, d) + 0.3
            w = (1.0 + 0.1 * torch.randn(d // heads, generator=g, device="cuda")).float()
            call = lambda: norms.rms_norm_heads(x, w, num_heads=heads)  # noqa: E731
            ref = norms.rms_reference(x.float(), w, heads, 1e-6, torch.float32)
            nbytes = _nbytes(x, x, w)
            x4, wb = x.view(b, s, heads, d // heads), w.to(torch.bfloat16)
            lib = lambda: F.rms_norm(x4, (d // heads,), wb, 1e-6)  # noqa: E731
        least = _bound(nbytes, 8.0 * x.numel(), FP32_FLOPS)[0]
        err = (call().float() - ref).abs()
        errors[f"#{k} {name}"] = [(err / _bf16_ulp(ref)).max().item(), err.max().item()]
        del err, ref
        key = f"#{k} {name} ({b},{s},{d})"
        out[key] = _three_ms(call, least)
        if lib is not None:
            out[f"lib {key}"] = _three_ms(lib, least, one_kernel=k != 7)
        del x, call, lib
    out["errors"] = errors
    out["error_names"] = ["largest bf16 spacings against fp32", "largest max abs"]
    registers, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line) or re.search(r"(\d+) bytes spill stores", line)
        if m and entry and ("layer_norm" in entry or "rms_heads" in entry):
            registers.setdefault(entry, []).append(int(m.group(1)))
    out["registers"] = {e: f"{r[0]} bytes of spill stores, {r[-1]}" for e, r in registers.items()}
    print(json.dumps(out), flush=True)


def attention_ab(mode, parent, pairs):
    """``--sd3-attention-ab`` / ``--attention-bwd-ab`` / ``--attention-fwd-ab``
    / ``--sd3-forward-ab`` / ``--norms-ab`` / ``--generic-ab PARENT PAIRS``:
    PAIRS alternating pairs of
    ``chip_smoke.py MODE TREE`` runs (MODE the matching ``-ms`` mode), each in
    its own process, of the checkout at PARENT and of this one (parent,
    change, change, parent, ...). Each run prints one JSON line {"module":
    ..., call: [ms, kernel ms(, host ms)], ..., and optionally dicts such as
    "registers": {kernel: registers}}. Prints every run, then each side's
    median and range per call, and parent / change per call."""
    import statistics

    here = os.path.dirname(os.path.abspath(__file__))

    def timed(r):  # the timed calls: lists of numbers (None: not measured)
        return [(k, v) for k, v in r.items() if isinstance(v, list)
                and all(x is None or isinstance(x, (int, float)) for x in v)]

    runs = {"parent": [], "change": []}
    for i in range(pairs):
        for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                                  parent if side == "parent" else here],
                                 capture_output=True, text=True, check=True).stdout
            r = json.loads(out.strip().splitlines()[-1])
            runs[side].append(r)
            for line in out.splitlines():
                if "trace discarded" in line:
                    print(f"pair {i} {side}: {line.strip()}", flush=True)
            print(f"pair {i} {side} ({r['module']}): " + ", ".join(
                f"{k} {_ms(v[0])} ms (kernels {_ms(v[1])}" + (f", host {_ms(v[2])})"
                                                             if len(v) > 2 else ")")
                for k, v in timed(r)), flush=True)
            for name, n in r.get("registers", {}).items():
                print(f"  ptxas: {name} {n} registers", flush=True)
            for key in ("joint forward kernel ms", "joint wrapper host ms", "split"):
                if key in r:
                    print(f"  {key} {r[key]}", flush=True)
    keys = [k for k, _ in timed(runs["change"][0])]
    medians = {}
    for side, rs in runs.items():
        for k in keys:
            for j, what in enumerate(("ms", "kernel ms", "host ms")[:len(rs[0][k])]):
                v = [r[k][j] for r in rs if r[k][j] is not None]
                if not v:
                    print(f"{side} {k} {what}: not measured", flush=True)
                    continue
                medians[side, k, what] = statistics.median(v)
                print(f"{side} {k} {what}: median {statistics.median(v):.4f}, range "
                      f"{min(v):.4f}..{max(v):.4f} over {len(v)} of {len(rs)} runs", flush=True)
    for k in keys:
        ratios = {w: medians["parent", k, w] / medians["change", k, w]
                  for w in ("ms", "kernel ms", "host ms")
                  if ("change", k, w) in medians and ("parent", k, w) in medians}
        print(f"{k}: parent / change " + ", ".join(
            f"{x:.3f}x by {'median ms' if w == 'ms' else w}" for w, x in ratios.items()),
            flush=True)
    # errors on the same inputs (each side's first run): by default (output,
    # lse) max abs against fp32, else as the run's "error_names" say
    names = runs["change"][0].get("error_names", ["output max abs", "lse max abs"])
    for case, errs in runs["change"][0].get("errors", {}).items():
        p_errs = runs["parent"][0]["errors"][case]
        print(f"{case} error, change / parent: " + "; ".join(
            f"{n} {c:.4e} / {p:.4e}" + (f" ({c / p:.3f}x)" if p else "")
            for n, c, p in zip(names, errs, p_errs)), flush=True)


# ── the kernels' whole range: fp32, every head width up to 128 ──────────────

GENERIC_FWD_SOURCE = "adv_grpo_torch/csrc/attention_generic_fwd.cu"
GENERIC_BWD_SOURCE = "adv_grpo_torch/csrc/attention_generic_bwd.cu"
NORMS_SOURCE = "adv_grpo_torch/csrc/fused_norms.cu"
# the generic kernels and the fp32 norms against their plain versions: fp32
# forward within KR_FWD_F32 relative L2 of the twin and backward within
# KR_BWD_F32 (only the sum order differs); bf16 within KR_BF16 relative L2
# of fp32 (the joint forward's bound) and, for the joint / single forward, within 1 bf16
# spacing of the twin at each row's largest output; the fp32 card-vs-CPU
# model within KR_MODEL_F32; the fp32 norms within KR_NORM_F32 of fp32
KR_FWD_F32, KR_BWD_F32, KR_BF16, KR_MODEL_F32, KR_NORM_F32 = 1e-5, 1e-4, 2e-2, 1e-4, 1e-6
KR_WIDTHS = (16, 32, 48, 64, 128)
# tile edges per mode (the generic kernels' 64-row q tile, 128-row forward
# and 64-row backward kv tiles): joint (B, S_img, S_txt, H), single (B, S,
# H), bshd (B, S_q, S_kv, H, kv_len), bhsd (B, H, S_q, S_kv, kv_len)
KR_EDGES = {"joint": ((2, 65, 37, 2), (1, 1, 129, 2)), "single": ((1, 63, 2), (2, 129, 1)),
            "bshd": ((1, 129, 64, 2, 63), (2, 1, 65, 1, None)),
            "bhsd": ((1, 2, 64, 129, 100), (1, 1, 129, 65, None))}
# the README's CPU commands on the card (the CI-sized presets, fp32 tiny models)
KR_SD3_TRAIN = ["--config", "smoke_sd3_fast", "--latent_hw", "8", "--set",
                "sample.train_batch_size=2", "--max_epochs", "2"]
KR_FLUX_INFER = ["--config", "flux_smoke", "--prompts", "a flower"]
KR_FLUX_TRAIN = ["--config", "flux_smoke", "--max_epochs", "2"]
KR_WAN_DEMO = ["--config", "wan_smoke"]
KR_WAN_TRAIN = ["--config", "wan_smoke", "--max_epochs", "2"]
# the context-parallel call at the ring test's head width (B, H, S, D)
KR_CP_SHAPE = (1, 16, 2048, 32)
# the full-width fp32 rows (name, mode, shape as KR_EDGES, d, fused qk-RMS):
# SD3.5-M's joint and single-stream attention with the qk-RMS, Flux.1-dev's
# joint at d = 128 without it (as Flux calls it), WAN's self-attention and
# the context-parallel call; SDPA computes the same function where there is
# no RMS
KR_FULL = (("sd3", "joint", (2, 1024, 154, 24), 64, True),
           ("sd3", "single", (2, 1024, 24), 64, True),
           ("flux", "joint", (1, 1024, 512, 24), 128, False),
           ("wan", "bshd", (1, 8100, 8100, 12, None), 128, False),
           ("cp", "bhsd", KR_CP_SHAPE[:3] + (KR_CP_SHAPE[2], None), KR_CP_SHAPE[3], False))
# the generic kernels' fp32 instances (3xTF32 on the tensor cores: the
# forward on wgmma, HGMMA in SASS; the backward on mma.sync m16n8k8, HMMA),
# at DMAX 32 / 64 / 128: {source: {kernel: instances}}
GENERIC_TF32_KERNELS = {GENERIC_FWD_SOURCE: {"attn_generic_fwd_tf32_kernel": 3},
                        GENERIC_BWD_SOURCE: {"attn_generic_dkv_tf32_kernel": 3,
                                             "attn_generic_dq_tf32_kernel": 3}}


def generic_counters():
    """The attention wrappers, each with its ``generic_launches`` counter."""
    from adv_grpo_torch.ops import attention, joint_attention

    return (joint_attention.joint_mha, joint_attention.mha_rms,
            joint_attention.joint_attention_bwd, joint_attention.mha_rms_bwd,
            attention.mha_bshd, attention.mha_bshd_bwd, attention.mha, attention.mha_bwd)


def check_no_generic(what):
    """Every phase before the kernel-range one runs bf16 at head width 64 or
    128, so it launches no generic kernel. Nothing resets the
    ``generic_launches`` counters before that phase, so one check at its
    start (``what``) covers every phase run before it."""
    n = {f.__name__: f.generic_launches for f in generic_counters()}
    if any(n.values()):
        raise AssertionError(f"generic attention launches up to {what}: {n}")


def _kr_zero():
    """Every attention counter (both routes) and the norms' at 0."""
    from adv_grpo_torch.ops import fused_norms

    _zero_counts(generic_counters() + (fused_norms.modulated_layer_norm,
                                       fused_norms.layer_norm, fused_norms.rms_norm_heads))
    for f in generic_counters():
        f.generic_launches = 0


def _kr_inputs(mode, dt, d, shape, g, rms=True):
    """Inputs of a generic case on the card: ``(q, k, v, do)`` per stream (a
    list), the RMS weight pairs (None for BSHD / BHSD, or joint / single
    without ``rms``), H."""
    import torch

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    if mode == "bhsd":
        b, h, sq, skv, _ = shape
        return [(randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d),
                 randn(b, h, sq, d))], None, h
    if mode == "bshd":
        b, sq, skv, h, _ = shape
        qkv = randn(b, sq, 3 * h * d)  # q a column slice of a fused projection
        return [(qkv[..., :h * d], randn(b, skv, h * d), randn(b, skv, h * d),
                 randn(b, sq, h * d))], None, h
    lens, h = (shape[1:3], shape[3]) if mode == "joint" else (shape[1:2], shape[2])
    b = shape[0]
    streams = [tuple(randn(b, s, h * d) for _ in range(4)) for s in lens]
    if not rms:  # Flux's call: q and k normalised before the kernel
        return streams, None, h
    pairs = [tuple((1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")).float()
                   for _ in range(2)) for _ in lens]
    return streams, pairs, h


def _kr_fwd(mode, streams, pairs, h, d, kv_len):
    """(outputs, lse per stream) of the wrapper's forward on the card."""
    from adv_grpo_torch.ops import attention, joint_attention as ja

    sm = d ** -0.5
    q, k, v = streams[0][:3]
    if mode == "bhsd":
        o, lse = attention.mha_fwd(q, k, v, sm, kv_len, True)
        return [o], [lse]
    if mode == "bshd":
        o, lse = attention.mha_bshd_fwd(q, k, v, h, sm, kv_len, True)
        return [o], [lse]
    if mode == "single":
        o, lse = ja.mha_rms_fwd(q, k, v, pairs and pairs[0], h, 1e-6, sm, True)
        return [o], [lse]
    (qi, ki, vi, _), (qt, kt, vt, _) = streams
    w = pairs and [*pairs[0], *pairs[1]]
    oi, ot, li, lt = ja.joint_attention_fwd(qi, ki, vi, qt, kt, vt, w, h, 1e-6, sm, True)
    return [oi, ot], [li, lt]


def _kr_plain_fwd(mode, streams, pairs, h, d, kv_len, dt=None):
    """The plain forward (fp32 unless ``dt``) on the same values: (outputs,
    contiguous lse per stream)."""
    from adv_grpo_torch.ops import attention, joint_attention as ja

    cast = [[t.float() if dt is None else t for t in s] for s in streams]
    sm = d ** -0.5
    q, k, v = cast[0][:3]
    if mode == "bhsd":
        o, lse = attention.attention_reference(q, k, v, sm_scale=sm, kv_len=kv_len,
                                               return_lse=True)
        return [o], [lse]
    if mode == "bshd":
        o, lse = attention.mha_bshd_reference(q, k, v, num_heads=h, kv_len=kv_len,
                                              return_lse=True)
        return [o], [lse]
    outs, lses = ja.joint_fwd_tiled_reference([s[0] for s in cast], [s[1] for s in cast],
                                              [s[2] for s in cast], num_heads=h,
                                              rms_weights=pairs)
    return outs, [x.contiguous() for x in lses]


def _kr_bwd(mode, streams, pairs, h, d, kv_len, outs, lses, twin):
    """(dq, dk, dv) per stream of the wrapper's backward on the card (or of
    its plain twin, ``twin``), from the plain forward's ``outs`` and
    ``lses``."""
    from adv_grpo_torch.ops import attention, joint_attention as ja

    sm = d ** -0.5
    if mode == "bhsd":
        q, k, v, do = streams[0]
        o = outs[0].to(q.dtype)
        fn = attention.flash_bwd_reference if twin else attention.mha_bwd
        return [fn(q, k, v, o, lses[0], do, sm_scale=sm, kv_len=kv_len)]
    dis = [attention.bwd_row_stats(o, s[3].float(), h) for o, s in zip(outs, streams)]
    if mode == "bshd":
        q, k, v, do = streams[0]
        fn = attention.bshd_bwd_reference if twin else attention.mha_bshd_bwd
        return [fn(q, k, v, do, lses[0], dis[0], num_heads=h, kv_len=kv_len)]
    if twin:
        return ja.attention_bwd_reference([s[0] for s in streams], [s[1] for s in streams],
                                          [s[2] for s in streams], [s[3] for s in streams],
                                          lses, dis, num_heads=h, rms_weights=pairs)
    if mode == "single":
        q, k, v, do = streams[0]
        return [ja.mha_rms_bwd(q, k, v, do, lses[0], dis[0], num_heads=h,
                               rms_weights=pairs and pairs[0])]
    (qi, ki, vi, doi), (qt, kt, vt, dot) = streams
    got = ja.joint_attention_bwd(qi, ki, vi, qt, kt, vt, doi, dot, *lses, *dis, num_heads=h,
                                 rms_weights=pairs and [*pairs[0], *pairs[1]])
    return [got[:3], got[3:]]


def _kr_counter(mode, direction):
    from adv_grpo_torch.ops import attention, joint_attention as ja

    return {("joint", "fwd"): ja.joint_mha, ("single", "fwd"): ja.mha_rms,
            ("joint", "bwd"): ja.joint_attention_bwd, ("single", "bwd"): ja.mha_rms_bwd,
            ("bshd", "fwd"): attention.mha_bshd, ("bshd", "bwd"): attention.mha_bshd_bwd,
            ("bhsd", "fwd"): attention.mha, ("bhsd", "bwd"): attention.mha_bwd}[mode, direction]


def _kr_case(mode, dt, d, shape, g, directions=("fwd", "bwd"), rms=True):
    """One generic case (joint / single with the fused qk-RMS unless not
    ``rms``), each direction that routes to the generic kernel:
    the forward against the plain version (fp32: the twin within KR_FWD_F32
    relative L2; bf16: fp32 within KR_BF16 and, joint / single, the twin
    within 1 bf16 spacing at each row's largest output) and the backward
    from the plain forward's lse against its twin (KR_BWD_F32 / KR_BF16),
    each one generic launch and no other. Returns {direction: max abs error
    against the twin}; raises on a bound or a count."""
    import torch

    from adv_grpo_torch.ops.attention import attention_route

    streams, pairs, h = _kr_inputs(mode, dt, d, shape, g, rms)
    kv_len = shape[-1] if mode in ("bshd", "bhsd") else None
    rms = pairs is not None
    f32 = dt == torch.float32
    errs = {}
    for direction in directions:
        if attention_route(torch.device("cuda"), dt, d, mode=mode, rms=rms,
                           direction=direction) != "generic":
            continue
        counter = _kr_counter(mode, direction)
        n0, s0 = counter.generic_launches, counter.launches
        if direction == "fwd":
            outs, lses = _kr_fwd(mode, streams, pairs, h, d, kv_len)
            ref, ref_lse = _kr_plain_fwd(mode, streams, pairs, h, d, kv_len)
            twin, twin_lse = (ref, ref_lse) if mode in ("bshd", "bhsd") else _kr_plain_fwd(
                mode, streams, pairs, h, d, kv_len, dt)
            rel = max(_rel_l2(o, r) for o, r in zip(outs, ref if not f32 else twin))
            # the lse against the twin's where the twin rounds the operands
            # (bf16 joint / single: within 1e-4, as #2 / #3 are held), else
            # against fp32 (5e-3 in bf16, the joint forward's bound)
            rounds = not f32 and mode in ("joint", "single")
            lse_err = max((a - b).abs().max().item()
                          for a, b in zip(lses, twin_lse if rounds else ref_lse))
            ulps = (0.0 if f32 or mode in ("bshd", "bhsd") else
                    max(_row_ulps(o, t, h) for o, t in zip(outs, twin) if o.numel()))
            err = max((o.float() - t.float()).abs().max().item() for o, t in zip(outs, twin))
            ok = rel <= (KR_FWD_F32 if f32 else KR_BF16) and ulps <= 1.0 and lse_err <= (
                1e-4 if f32 or rounds else 5e-3)
            detail = f"rel L2 {rel:.2e}, lse {lse_err:.2e}" + ("" if f32 else f", {ulps:.2f} ulp")
        else:
            ref, ref_lse = _kr_plain_fwd(mode, streams, pairs, h, d, kv_len)
            got = _kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse, False)
            want = _kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse, True)
            pairs_ = [(a, b) for gs, ws in zip(got, want) for a, b in zip(gs, ws) if b.numel()]
            # relative L2 per cotangent; one that is 0 up to rounding (a
            # single key: p = 1, so ds = 0 and dq, dk are rounding noise;
            # its norm under a thousandth of the call's largest) is measured
            # against the largest cotangent norm instead of its own
            top = max(b.float().norm().item() for _, b in pairs_)
            rel = max((a.float() - b.float()).norm().item()
                      / (b.float().norm().item() if b.float().norm() >= 1e-3 * top else top)
                      for a, b in pairs_)
            err = max((a.float() - b.float()).abs().max().item() for a, b in pairs_)
            ok = rel <= (KR_BWD_F32 if f32 else KR_BF16)
            detail = f"rel L2 {rel:.2e}"
        torch.cuda.synchronize()
        counts = (counter.generic_launches - n0, counter.launches - s0)
        if not ok or counts != (1, 0):
            raise AssertionError(f"generic {mode} {direction} {dt} d={d} {shape} rms={rms}: "
                                 f"{detail}, launches (generic, wgmma) {counts}")
        errs[direction] = (err, detail)
    return errs


def check_generic_edges():
    """The generic kernels at KR_EDGES for each dtype and head width of
    KR_WIDTHS that routes to them, every mode, forward and backward; joint
    and single with and without the fused qk-RMS."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    n, worst = 0, {}
    for dt in (torch.float32, torch.bfloat16):
        for d in KR_WIDTHS:
            for mode, shapes in KR_EDGES.items():
                for rms in ((True, False) if mode in ("joint", "single") else (False,)):
                    for shape in shapes:
                        for direction, (err, _) in _kr_case(mode, dt, d, shape, g,
                                                            rms=rms).items():
                            n += 1
                            key = (str(dt).split(".")[-1], direction)
                            worst[key] = max(worst.get(key, 0.0), err)
    print(f"generic kernels at the tile edges: {n} (dtype, d, mode, RMS, shape, direction) cases "
          f"within bounds; max abs err against the twins "
          + ", ".join(f"{k[0]} {k[1]} {v:.3e}" for k, v in sorted(worst.items())), flush=True)


def _kr_attn_full(name, mode, shape, d, g, library, rms=True):
    """A full-width fp32 generic case (joint / single with the fused qk-RMS
    unless not ``rms``): checked (``_kr_case``), two calls each way held
    bitwise equal, and timed forward and backward beside the plain versions,
    SDPA in fp32 where it computes the same function (``library``) and the
    bounds of the 3xTF32 tensor cores (the entries' ``bound_ms``) and of FFMA
    (``bound_ffma_ms``). Returns the two kernels-line entries (launches
    filled in later)."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops.attention import to_bhsd

    dt = torch.float32
    errs = _kr_case(mode, dt, d, shape, g, rms=rms)
    streams, pairs, h = _kr_inputs(mode, dt, d, shape, g, rms)
    kv_len = shape[-1] if mode in ("bshd", "bhsd") else None
    b = shape[0]
    ref, ref_lse = _kr_plain_fwd(mode, streams, pairs, h, d, kv_len)
    row = -2 if mode == "bhsd" else 1  # the sequence dim
    s_q = sum(s[0].shape[row] for s in streams)
    s_kv = sum(s[1].shape[row] for s in streams) if kv_len is None else kv_len
    # bytes: q, k, v read and o written (forward); q, k, v, do read and dq,
    # dk, dv written (backward); the fp32 row statistics beside them
    qkv = _nbytes(*(t for s in streams for t in s[:3]))
    stats = _nbytes(*ref_lse)
    # the bound of the 3xTF32 tensor cores (the kernels' route) and, beside
    # it, of FFMA
    bytes_f, bytes_b = qkv + _nbytes(*ref) + stats, 2 * qkv + _nbytes(*ref) + 2 * stats
    flops_f, flops_b = 4.0 * b * h * s_q * s_kv * d, 10.0 * b * h * s_q * s_kv * d
    least_f, least_b = (_bound(bytes_f, flops_f, TF32_3X_FLOPS),
                        _bound(bytes_b, flops_b, TF32_3X_FLOPS))
    ffma_f, ffma_b = _bound(bytes_f, flops_f, FP32_FLOPS), _bound(bytes_b, flops_b, FP32_FLOPS)
    # no atomics: two calls on the same inputs are bitwise equal
    for direction, call in (("forward", lambda: _kr_fwd(mode, streams, pairs, h, d, kv_len)),
                            ("backward", lambda: _kr_bwd(mode, streams, pairs, h, d, kv_len,
                                                         ref, ref_lse, False))):
        first = [t.clone() for t in _flat(call())]
        if not all(torch.equal(a, b_) for a, b_ in zip(first, _flat(call()))):
            raise AssertionError(f"generic {mode} fp32 {name} {direction}: two calls differ")
    iters = 5 if s_q > 4096 else 10
    fwd_ms = _median_ms(lambda: _kr_fwd(mode, streams, pairs, h, d, kv_len), iters=iters)
    plain_f = _median_ms(lambda: _kr_plain_fwd(mode, streams, pairs, h, d, kv_len, dt),
                         iters=3, warmup=1)
    bwd_ms = _median_ms(lambda: _kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse,
                                        False), iters=iters)
    plain_b = _median_ms(lambda: _kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse,
                                         True), iters=3, warmup=1)
    lib_f = lib_b = None
    if library:  # SDPA on the (B, H, S, D) views of the concatenated streams
        if mode == "bhsd":
            qkv = [streams[0][i] for i in range(3)]
        else:
            qkv = [to_bhsd(torch.cat([s[i] for s in streams], 1), h) for i in range(3)]
        lib_f = _median_ms(lambda: F.scaled_dot_product_attention(*qkv), iters=iters)
        leaves = [t.detach().requires_grad_() for t in qkv]
        out = F.scaled_dot_product_attention(*leaves)
        lib_b = _median_ms(lambda: torch.autograd.grad(out, leaves, torch.ones_like(out),
                                                       retain_graph=True), iters=iters)
        del out, leaves, qkv
    print(f"generic {mode} fp32 {name} {shape} d={d} rms={pairs is not None}: forward "
          f"{errs['fwd'][1]}, {fwd_ms:.4f} ms "
          f"vs plain {plain_f:.4f} vs SDPA {_ms(lib_f)}; bound {least_f[0]:.4f} ms 3xTF32 "
          f"({least_f[1]}), {ffma_f[0]:.4f} FFMA; backward {errs['bwd'][1]}, {bwd_ms:.4f} ms "
          f"vs plain {plain_b:.4f} vs SDPA backward {_ms(lib_b)}; bound {least_b[0]:.4f} ms "
          f"3xTF32 ({least_b[1]}), {ffma_b[0]:.4f} FFMA; two calls bitwise equal", flush=True)
    replaces = {"joint": ("adv_grpo_tpu/ops/joint_attention.py:73",
                          "adv_grpo_tpu/ops/joint_attention.py:224"),
                "single": ("adv_grpo_tpu/ops/joint_attention.py:644",
                           "adv_grpo_tpu/ops/joint_attention.py:387"),
                "bshd": ("adv_grpo_tpu/ops/attention.py:346", "adv_grpo_tpu/ops/attention.py:395"),
                "bhsd": ("adv_grpo_tpu/ops/attention.py:104", "adv_grpo_tpu/ops/attention.py:201")}
    del streams, ref, ref_lse
    torch.cuda.empty_cache()
    return (dict(_entry(f"attention_generic_fwd_{mode}_f32_{name}", GENERIC_FWD_SOURCE,
                        replaces[mode][0], errs["fwd"][0], fwd_ms, plain_f, least_f, lib_f),
                 bound_ffma_ms=ffma_f[0]),
            dict(_entry(f"attention_generic_bwd_{mode}_f32_{name}", GENERIC_BWD_SOURCE,
                        replaces[mode][1], errs["bwd"][0], bwd_ms, plain_b, least_b, lib_b),
                 bound_ffma_ms=ffma_b[0]))


def _flat(result):
    """The tensors of a ``_kr_fwd`` / ``_kr_bwd`` result, in order."""
    out = []
    for x in result:
        out.extend(_flat(x) if isinstance(x, (list, tuple)) else [x])
    return out


def check_rms_bwd_d128(g):
    """The generic joint backward in bf16 with the fused qk-RMS at d = 128
    (the wgmma backward builds it at 64 only) at Flux.1-dev's shape, 1024 +
    512 tokens of 24 heads: against its twin (KR_BF16) and timed beside the
    twin and the bf16 bound. No model runs it, so it has no kernels-line
    entry."""
    import torch

    shape, d = (1, 1024, 512, 24), 128
    errs = _kr_case("joint", torch.bfloat16, d, shape, g, ("bwd",))
    streams, pairs, h = _kr_inputs("joint", torch.bfloat16, d, shape, g)
    ref, ref_lse = _kr_plain_fwd("joint", streams, pairs, h, d, None)
    ms = _median_ms(lambda: _kr_bwd("joint", streams, pairs, h, d, None, ref, ref_lse, False))
    plain_ms = _median_ms(lambda: _kr_bwd("joint", streams, pairs, h, d, None, ref, ref_lse,
                                          True), iters=3, warmup=1)
    qkv = _nbytes(*(t for s in streams for t in s[:3]))
    s_all = shape[1] + shape[2]
    least = _bound(2 * qkv + qkv // 3 + 2 * _nbytes(*ref_lse),
                   10.0 * h * s_all * s_all * d, BF16_TENSOR_FLOPS)
    print(f"generic joint backward bf16 with the qk-RMS at d=128 {shape}: {errs['bwd'][1]} "
          f"against its twin (bound {KR_BF16}); {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
          f"{least[0]:.4f} ms ({least[1]})", flush=True)


def check_fp32_norms(g):
    """The fp32 norms at the full-width shapes against their plain versions
    (KR_NORM_F32 relative L2) and timed beside ``F.layer_norm`` /
    ``F.rms_norm`` where one call computes the same function; returns the
    kernels-line entries."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import fused_norms as fn

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    out = []
    x = randn(2, 1024, 1536) + 0.5
    mods = randn(2, 6 * 1536)
    sc, sh = mods[:, :1536], mods[:, 1536:3072]
    cases = [
        ("lnmod_f32", "modulated_layer_norm (2,1024,1536)", "adv_grpo_tpu/ops/fused_norms.py:252",
         lambda: fn.modulated_layer_norm(x, sc, sh),
         lambda: fn.lnmod_reference(x, sc, sh, 1e-6, torch.float32), None, (x, sc, sh), x),
    ]
    w = randn(8100, 1536)[None] * 2.0
    cases.append(("ln_f32", "layer_norm (1,8100,1536)", "adv_grpo_tpu/ops/fused_norms.py:54",
                  lambda: fn.layer_norm(w), lambda: fn.ln_reference(w, 1e-6, torch.float32),
                  lambda: F.layer_norm(w, (1536,), eps=1e-6), (w,), w))
    r = randn(1, 1536, 2 * 3072)[..., :3072]  # strided rows, as from a fused projection
    wr = (1.0 + 0.1 * randn(128)).float()
    cases.append(("rms_heads_f32", "rms_norm_heads (1,1536,24x128)",
                  "adv_grpo_tpu/ops/fused_norms.py:127",
                  lambda: fn.rms_norm_heads(r, wr, num_heads=24),
                  lambda: fn.rms_reference(r, wr, 24, 1e-6, torch.float32),
                  lambda: F.rms_norm(r.view(1, 1536, 24, 128), (128,), wr, eps=1e-6),
                  (r, wr), r))
    for name, shape, replaces, kern, plain, lib, ins, like in cases:
        y, ref = kern(), plain()
        rel = _rel_l2(y, ref)
        err = (y - ref).abs().max().item()
        if not rel <= KR_NORM_F32 or y.dtype != torch.float32:
            raise AssertionError(f"{name} {shape}: relative L2 {rel}, dtype {y.dtype}")
        ms = _median_ms(kern, iters=50, warmup=5)
        plain_ms = _median_ms(plain)
        lib_ms = None if lib is None else _median_ms(lib, iters=50, warmup=5)
        least = _bound(_nbytes(*ins) + _nbytes(like), 8.0 * like.numel(), FP32_FLOPS)
        print(f"kernel {name} {shape}: relative L2 {rel:.2e}, max abs {err:.3e} (bound "
              f"{KR_NORM_F32}); median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs library "
              f"{_ms(lib_ms)}; bound {least[0]:.4f} ms ({least[1]})", flush=True)
        out.append(_entry(name, NORMS_SOURCE, replaces, err, ms, plain_ms, least, lib_ms))
    return out


def _kr_counts(kinds):
    """The launch counters of ``kinds`` (names of KR_COUNTERS)."""
    from adv_grpo_torch.ops import attention, fused_norms, joint_attention as ja

    table = {"lnmod": fused_norms.modulated_layer_norm.launches,
             "rms": fused_norms.rms_norm_heads.launches, "ln": fused_norms.layer_norm.launches,
             "joint": ja.joint_mha.generic_launches, "single": ja.mha_rms.generic_launches,
             "joint_bwd": ja.joint_attention_bwd.generic_launches,
             "single_bwd": ja.mha_rms_bwd.generic_launches,
             "bshd": attention.mha_bshd.generic_launches,
             "bshd_bwd": attention.mha_bshd_bwd.generic_launches}
    return [table[k] for k in kinds]


def _kr_run(what, fn, kinds, want, metrics=None):
    """Run ``fn`` (a CLI entry on the card) with every counter at 0 first;
    the launches of ``kinds`` must be ``want(result)`` and the wgmma
    kernels' ``launches`` 0 (every tensor is fp32); with ``metrics`` (a
    ``metrics.jsonl``) each epoch's reward, loss, approx_kl and clipfrac
    finite. Returns (the run's result, {kind: launches})."""
    import numpy as np
    import torch

    _kr_zero()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _kr_counts(kinds)
    wgmma = sum(f.launches for f in generic_counters())
    line = f"{what}: {wall:.2f} s wall (pipeline build included); launches {dict(zip(kinds, got))}"
    if metrics is not None:
        with open(metrics) as f:
            records = [json.loads(r) for r in f]
        keys = ("reward_avg", "loss", "approx_kl", "clipfrac")
        bad = [(r["epoch"], k) for r in records for k in keys if not np.isfinite(r[k])]
        line += f"; {len(records)} epochs, last " + ", ".join(
            f"{k} {records[-1][k]:.4g}" for k in keys)
        if bad or len(records) != 2:
            raise AssertionError(f"{what}: non-finite {bad} over {len(records)} epochs")
    print(line, flush=True)
    want = list(want(result))
    if got != want or wgmma:
        raise AssertionError(f"{what}: launches {got}, expected {list(want)}; wgmma kernels "
                             f"{wgmma}")
    return result, dict(zip(kinds, got))


def run_kernel_range_presets(work):
    """The README's five CPU commands on the card through their entry
    points, and ``cli.infer`` at full SD3.5-M width in fp32 (40 steps, CFG
    batch 2, one image): every launch count as derived from the configs.
    Returns {family: {kind: launches}}."""
    import numpy as np
    from PIL import Image

    from adv_grpo_torch.cli import infer, train, wan_sde_demo
    from adv_grpo_torch.cli.common import build_pipeline, resolve_config
    from adv_grpo_torch.models.mmdit import MMDiTConfig

    sd3_kinds = ("lnmod", "joint", "single", "joint_bwd", "single_bwd")
    flux_kinds = ("lnmod", "rms", "joint", "bshd", "joint_bwd", "bshd_bwd")
    wan_kinds = ("lnmod", "rms", "ln", "bshd", "bshd_bwd")
    counts = {}

    def add(family, got):
        fam = counts.setdefault(family, {})
        for k, n in got.items():
            fam[k] = fam.get(k, 0) + n

    def trained(argv, name):
        return train.main(argv + ["--set", f"save_dir={os.path.join(work, name)}"])

    def metrics(name):
        return os.path.join(work, name, "metrics.jsonl")

    # the trainings' counts derived from the configs their trainers hold;
    # the inference entries' from the tiny configs their pipelines build
    _, got = _kr_run("cli.train smoke_sd3_fast on the card (fp32 tiny MMDiT, 4 heads of 32)",
                     lambda: trained(KR_SD3_TRAIN, "sd3"), sd3_kinds,
                     lambda t: expected_train_counts(t.config, t.pipeline.mmdit_cfg)[0],
                     metrics("sd3"))
    add("sd3", got)

    cfg = resolve_config("flux_smoke")
    steps = int(cfg.sample.eval_num_steps)
    paths, got = _kr_run(
        "cli.infer flux_smoke on the card (fp32 tiny Flux, 2 heads of 16)",
        lambda: infer.main(KR_FLUX_INFER + ["--out_dir", os.path.join(work, "fi")]),
        flux_kinds[:4], lambda _: [c * steps for c in flux_per_forward_counts(
            build_pipeline(cfg).flux_cfg)])
    add("flux", got)
    img = np.asarray(Image.open(paths[0]))
    if img.ndim != 3 or img.shape[2] != 3:
        raise AssertionError(f"flux_smoke PNG of shape {img.shape}")
    _, got = _kr_run("cli.train flux_smoke on the card", lambda: trained(KR_FLUX_TRAIN, "flux"),
                     flux_kinds,
                     lambda t: expected_flux_train_counts(t.config, t.pipeline.flux_cfg)[0],
                     metrics("flux"))
    add("flux", got)

    cfg = resolve_config("wan_smoke")
    steps = int(cfg.sample.num_steps) * (2 if float(cfg.sample.get("kl_reward", 0.0)) > 0
                                         else 1)  # a KL forward per step
    path, got = _kr_run(
        "cli.wan_sde_demo wan_smoke on the card (fp32 tiny WAN, 2 heads of 16)",
        lambda: wan_sde_demo.main(KR_WAN_DEMO + ["--out_dir", os.path.join(work, "wd")]),
        wan_kinds[:4], lambda _: [c * steps for c in wan_per_forward_counts(build_pipeline(
            cfg, frames=int(cfg.sample.get("num_frames", 9))).wan_cfg)])
    add("wan", got)
    if not os.path.exists(path):
        raise AssertionError(f"wan_sde_demo wrote no {path}")
    _, got = _kr_run("cli.train wan_smoke on the card", lambda: trained(KR_WAN_TRAIN, "wan"),
                     wan_kinds,
                     lambda t: expected_wan_train_counts(t.config, t.pipeline.wan_cfg)[0],
                     metrics("wan"))
    add("wan", got)

    t0 = time.perf_counter()
    paths, got = _kr_run(
        f"cli.infer eval_sd3_fast full width in fp32, {STEPS} steps, CFG batch 2",
        lambda: infer.main(INFER_ARGV + ["--set", "mixed_precision=fp32", "--out_dir",
                                         os.path.join(work, "e")]),
        sd3_kinds[:3], lambda _: [c * STEPS for c in per_forward_counts(
            MMDiTConfig.sd35_medium())])
    wall = time.perf_counter() - t0
    add("sd3", got)
    img = np.asarray(Image.open(paths[0]))
    print(f"  eval_sd3_fast fp32: {wall:.2f} s for one image (build, {STEPS} steps, fp32 "
          f"decode); PNG {img.shape}, pixel range {img.min()}..{img.max()}", flush=True)
    if img.shape != (512, 512, 3) or img.min() == img.max():
        raise AssertionError(f"bad fp32 eval PNG: {img.shape}, {img.min()}..{img.max()}")
    return counts


def check_fp32_model():
    """A 2-layer full-width MMDiT in fp32 on the card (the generic kernels,
    the fp32 LayerNorm) against the same weights on the CPU: the output and
    the LoRA gradients through a fixed cotangent, within KR_MODEL_F32."""
    import torch

    from adv_grpo_torch.models.lora import init_params_
    from adv_grpo_torch.models.mmdit import MMDiT, MMDiTConfig

    cfg = MMDiTConfig.sd35_medium(num_layers=2, dual_attention_layers=(0,), lora_rank=32,
                                  lora_alpha=64.0, dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED + 22)
    cpu = MMDiT(cfg, device="cpu")
    init_params_(cpu, g)
    for name, p in cpu.named_parameters():
        if name.endswith("lora_b"):
            p.data.normal_(0.0, 0.02, generator=g)
    gpu = MMDiT(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    inputs = (torch.randn(2, 16, 16, 16, generator=g), torch.tensor([1000.0, 500.0]),
              torch.randn(2, 154, 4096, generator=g) * 0.2, torch.randn(2, 2048, generator=g) * 0.2)
    with torch.inference_mode():
        ref = cpu(*inputs)
        out = gpu(*(a.cuda() for a in inputs)).cpu()
    cot = torch.randn(ref.shape, generator=g)
    gc_ = _lora_grads(cpu, lambda m: m(*inputs), cot)
    gg = _lora_grads(gpu, lambda m: m(*(a.cuda() for a in inputs)), cot)
    rel, rel_g = _rel_l2(out, ref), _rel_l2(gg, gc_)
    print(f"2-layer full-width MMDiT in fp32, card vs CPU: output relative L2 {rel:.3e}, LoRA "
          f"gradients {rel_g:.3e} (bound {KR_MODEL_F32}, TF32 off)", flush=True)
    if not (rel <= KR_MODEL_F32 and rel_g <= KR_MODEL_F32):
        raise AssertionError(f"fp32 MMDiT on the card: output {rel}, gradients {rel_g}")
    del cpu, gpu
    torch.cuda.empty_cache()


def check_context_parallel_d32():
    """``context_parallel_attention`` at head width 32 (KR_CP_SHAPE, fp32)
    in a one-rank group: one generic ``mha`` forward and backward, against
    fp32 autograd (KR_FWD_F32 / KR_BWD_F32); returns {kind: launches}."""
    import torch
    import torch.distributed as dist

    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops.ring_attention import context_parallel_attention

    own = not dist.is_initialized()
    if own:
        print(f"process group initialized at {init_group()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    b, h, s, d = KR_CP_SHAPE
    leaves = [torch.randn((b, h, s, d), generator=g, device="cuda").requires_grad_()
              for _ in range(3)]
    do = torch.randn((b, h, s, d), generator=g, device="cuda")
    _kr_zero()
    o = context_parallel_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    counts = {"bhsd": attention.mha.generic_launches,
              "bhsd_bwd": attention.mha_bwd.generic_launches}
    ref = attention.attention_reference(*leaves, sm_scale=d ** -0.5)
    ref_grads = torch.autograd.grad(ref, leaves, do)
    rel, rel_g = _rel_l2(o, ref), max(_rel_l2(a, r) for a, r in zip(grads, ref_grads))
    print(f"context_parallel_attention {KR_CP_SHAPE} fp32 (d=32): output relative L2 "
          f"{rel:.2e}, gradients {rel_g:.2e}; generic launches {counts}", flush=True)
    if own:
        dist.destroy_process_group()
    if counts != {"bhsd": 1, "bhsd_bwd": 1} or rel > KR_FWD_F32 or rel_g > KR_BWD_F32:
        raise AssertionError(f"context-parallel d=32: {rel}, {rel_g}, launches {counts}")
    return counts


def run_kernel_range_slice(smi):
    """Phase (``--kernel-range``): what the TPU kernels take beyond the
    wgmma kernels' bf16 at 64 / 128, on the card. The generic kernels at
    their tile edges (``check_generic_edges``) and at the full-width fp32
    shapes (SD3.5-M's joint and single-stream attention with the qk-RMS,
    Flux.1-dev's joint at d = 128 without it, WAN's self-attention, the
    context-parallel call), the fp32 norms, the bf16 joint backward with the qk-RMS at d =
    128; the five CI-sized presets and the fp32 ``eval_sd3_fast`` image
    (``run_kernel_range_presets``), a 2-layer fp32 MMDiT against the CPU and
    ``mha`` at d = 32 through ``context_parallel_attention``. Matmuls and
    convolutions run in full fp32 (TF32 off) throughout. Returns the
    kernels-line entries of the fp32 instances with the presets' launches."""
    import torch

    print(f"kernel range phase on {smi}: torch.backends.cuda.matmul.allow_tf32 and "
          "torch.backends.cudnn.allow_tf32 set to False (fp32 references in full fp32)",
          flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        check_no_generic("the kernel range phase (every earlier phase)")
        check_generic_edges()
        g = torch.Generator(device="cuda").manual_seed(SEED + 24)
        full = [e for name, mode, shape, d, rms in KR_FULL
                for e in _kr_attn_full(name, mode, shape, d, g, library=not rms, rms=rms)]
        check_rms_bwd_d128(g)
        norms = check_fp32_norms(g)
        with tempfile.TemporaryDirectory() as work:
            counts = run_kernel_range_presets(work)
        check_fp32_model()
        cp_counts = check_context_parallel_d32()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    launches = {
        "attention_generic_fwd_joint_f32_sd3": counts["sd3"]["joint"],
        "attention_generic_bwd_joint_f32_sd3": counts["sd3"]["joint_bwd"],
        "attention_generic_fwd_single_f32_sd3": counts["sd3"]["single"],
        "attention_generic_bwd_single_f32_sd3": counts["sd3"]["single_bwd"],
        "attention_generic_fwd_joint_f32_flux": counts["flux"]["joint"],
        "attention_generic_bwd_joint_f32_flux": counts["flux"]["joint_bwd"],
        "attention_generic_fwd_bshd_f32_wan": counts["flux"]["bshd"] + counts["wan"]["bshd"],
        "attention_generic_bwd_bshd_f32_wan": (counts["flux"]["bshd_bwd"]
                                               + counts["wan"]["bshd_bwd"]),
        "attention_generic_fwd_bhsd_f32_cp": cp_counts["bhsd"],
        "attention_generic_bwd_bhsd_f32_cp": cp_counts["bhsd_bwd"],
        "lnmod_f32": sum(c["lnmod"] for c in counts.values()),
        "ln_f32": counts["wan"]["ln"],
        "rms_heads_f32": counts["flux"]["rms"] + counts["wan"]["rms"]}
    # the single-stream backward never runs on these paths (the dual
    # attention of block 0 gets no gradient): its row is left out
    results = [e for e in full + list(norms) if launches.get(e["name"])]
    for e in results:
        e["launches"] = launches[e["name"]]
    print(f"kernel range phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return results


def mma_rate(smi):
    """``--mma-rate``: builds and runs ``csrc/probes/mma_rate.cu`` (the card's
    mma.sync rate in TF32 and bf16) in a temporary directory; returns its
    exit code."""
    from adv_grpo_torch.kernels import build

    src = os.path.join(build.CSRC_DIR, "probes", "mma_rate.cu")
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "mma_rate")
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", exe, src], check=True)
        return subprocess.run([exe]).returncode


def _ptxas_report(build, names):
    """{entry: {"registers", "static_smem", "spill_stores"}} from the ptxas
    report of this process's build, for the entries that name one of
    ``names``."""
    import re

    report, entry = {}, ""
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and any(k in entry for k in names):
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                report.setdefault(entry, {})["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report.setdefault(entry, {})["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                report[entry]["static_smem"] = int(m.group(1)) if m else 0
    return report


_SASS = {}  # the library's path: its SASS (cuobjdump -sass)


def _sass_counts(build, names, opcodes):
    """{function: its instructions of any of ``opcodes``} over the SASS
    functions of this process's build that name one of ``names``; None where
    cuobjdump is not on the machine."""
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("  cuobjdump not found: SASS not inspected", flush=True)
        return None
    lib = build.build()
    if lib not in _SASS:  # one disassembly a library
        _SASS[lib] = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                                    text=True).stdout
    counts, fn = {}, None
    for line in _SASS[lib].splitlines():
        m = re.search(r"Function : (\S+)", line)
        fn = m.group(1) if m else fn
        if fn and any(k in fn for k in names):
            counts[fn] = counts.get(fn, 0) + any(op in line for op in opcodes)
    return counts


def check_sm90_build(build):
    """The wgmma + TMA kernels' ptxas report (registers, shared memory, spill
    stores per instance) from this process's build, per source in
    SM90_KERNELS; raises on a spill store or on a missing instance. Where
    cuobjdump is on the machine, prints how many HGMMA (wgmma) instructions
    each instance of each wgmma kernel holds, and raises where one holds
    none."""
    report = _ptxas_report(build, {k for ks in SM90_KERNELS.values() for k in ks})
    for line in build.build_log.splitlines():
        if "wgmma" in line and "warning" in line.lower():  # serialised wgmma
            print(f"  ptxas: {line.strip()}", flush=True)
    # the tiles live in dynamic shared memory, sized in the sources (Smem)
    # and set at launch; ptxas sees only the static part
    for src, ks in SM90_KERNELS.items():
        print(f"{src} (ptxas): " + "; ".join(
            f"{e}: {r.get('registers')} registers at entry, {r.get('static_smem')} bytes of "
            f"static shared memory, {r.get('spill_stores')} bytes of spill stores"
            for e, r in sorted(report.items()) if any(k in e for k in ks)), flush=True)
        names = {n: sum(n in e for e in report) for n in ks}
        if names != ks:
            raise AssertionError(f"ptxas reported {names} instances, expected {ks}")
    spills = {e: r.get("spill_stores") for e, r in report.items() if r.get("spill_stores") != 0}
    if spills:
        raise AssertionError(f"a wgmma + TMA kernel spills: {spills}")
    for src, ks in SM90_KERNELS.items():
        wgmma_kernel, instances = next(iter(ks.items()))
        hgmma = _sass_counts(build, (wgmma_kernel,), ("HGMMA",))
        if hgmma is None:
            return
        print(f"  SASS: HGMMA instructions per {wgmma_kernel} instance {hgmma}", flush=True)
        if len(hgmma) != instances or not all(hgmma.values()):
            raise AssertionError(f"expected HGMMA in {instances} {wgmma_kernel} instances, got "
                                 f"{hgmma}")


def check_generic_tf32_build(build):
    """The generic kernels' fp32 instances (GENERIC_TF32_KERNELS) in this
    process's build: ptxas's registers and spill stores per instance
    (printed; raises on a missing instance; the dk/dv kernel at d = 128
    sits at the 255-register cap with a few bytes of spill, PERF.md §6 PR
    23) and, where cuobjdump is on the machine, the tensor-core
    instructions each instance holds (HGMMA: wgmma, HMMA: mma.sync): raises
    where one holds none, so fp32 runs on the tensor cores."""
    names = {k for ks in GENERIC_TF32_KERNELS.values() for k in ks}
    report = _ptxas_report(build, names)
    for src, ks in GENERIC_TF32_KERNELS.items():
        print(f"{src} fp32 instances (ptxas): " + "; ".join(
            f"{e}: {r.get('registers')} registers, {r.get('spill_stores')} bytes of spill stores"
            for e, r in sorted(report.items()) if any(k in e for k in ks)), flush=True)
        found = {n: sum(n in e for e in report) for n in ks}
        if found != ks:
            raise AssertionError(f"ptxas reported {found} fp32 generic instances, expected {ks}")
    ops = _sass_counts(build, names, ("HMMA", "HGMMA"))
    if ops is None:
        return
    print(f"  SASS: HGMMA / HMMA instructions per fp32 generic instance {ops}", flush=True)
    if len(ops) != sum(sum(ks.values()) for ks in GENERIC_TF32_KERNELS.values()) or not all(
            ops.values()):
        raise AssertionError(f"fp32 generic instances without HGMMA / HMMA: {ops}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if sys.argv[1:2] == ["--sd3-attention-ms"]:
        sd3_attention_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--attention-bwd-ms"]:
        attention_bwd_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--attention-fwd-ms"]:
        attention_fwd_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--sd3-forward-ms"]:
        sd3_forward_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--norms-ms"]:
        norms_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--generic-ms"]:
        generic_ms(sys.argv[2])
        return 0
    if sys.argv[1:] == ["--mma-rate"]:
        return mma_rate(smi)
    if sys.argv[1:2] == ["--wan-decode"]:  # the VAE alone: no kernel
        wan_decode_probe(smi, *(int(a) for a in sys.argv[2:5]))
        return 0
    print(smi, flush=True)
    ab = {"--sd3-attention-ab": "--sd3-attention-ms", "--attention-bwd-ab": "--attention-bwd-ms",
          "--attention-fwd-ab": "--attention-fwd-ms", "--sd3-forward-ab": "--sd3-forward-ms",
          "--norms-ab": "--norms-ms", "--generic-ab": "--generic-ms"}
    if sys.argv[1:2] and sys.argv[1] in ab:
        attention_ab(ab[sys.argv[1]], sys.argv[2], int(sys.argv[3]))
        return 0

    from adv_grpo_torch.kernels import build

    t0 = time.perf_counter()
    build.lib()
    if build.build_seconds is None:
        print(f"kernels: loaded the library already built from these sources in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    else:
        print(f"kernels built from adv_grpo_torch/csrc by nvcc in {build.build_seconds:.2f} s",
              flush=True)
        entry = ""
        for line in build.build_log.splitlines():  # ptxas: registers, spills, smem
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "Used" in line or "spill" in line:
                print(f"  {entry}: {line.strip()}", flush=True)
        check_sm90_build(build)
        check_generic_tf32_build(build)

    from adv_grpo_torch.ops import attention, fused_norms, joint_attention
    import torch.distributed as dist

    kernels = (fused_norms.modulated_layer_norm, joint_attention.joint_mha,
               joint_attention.mha_rms, joint_attention.joint_attention_bwd,
               joint_attention.mha_rms_bwd)
    flux_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                    joint_attention.joint_mha, attention.mha_bshd)
    flux_train_kernels = flux_kernels + (joint_attention.joint_attention_bwd,
                                         attention.mha_bshd_bwd)
    if sys.argv[1:2] == ["--flux-1024"]:  # alone; "--set key=value" overrides the config
        sets = sys.argv[2:]
        if len(sets) % 2 or any(a != "--set" for a in sets[::2]):
            raise SystemExit("usage: chip_smoke.py --flux-1024 [--set key=value ...]")
        run_flux_1024_slice(flux_train_kernels, smi, overrides=sets[1::2])
        return 0
    alone = {"--dino": run_dino_slice, "--checkpoint": run_checkpoint_slice,
             "--loaders": run_loader_slice,
             "--family-loaders": lambda kernels, smi: run_family_loader_slice(smi),
             "--prefix-image": run_prefix_image_slice,
             "--eval-tooling": run_eval_tooling_slice,
             "--remaining-rewards": run_remaining_rewards_slice}
    if sys.argv[1:2] and sys.argv[1] in alone:  # one phase, in its one-rank group
        print(f"process group initialized at {init_group()}", flush=True)
        alone[sys.argv[1]](kernels, smi)
        dist.destroy_process_group()
        check_no_generic(sys.argv[1])
        return 0
    wan_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                   fused_norms.layer_norm, attention.mha_bshd, attention.mha_bshd_bwd)
    if sys.argv[1:] == ["--wan-81"]:  # alone
        print("wan 81-frame kernels: " + json.dumps(run_wan_81_slice(wan_kernels, smi)),
              flush=True)
        return 0
    if sys.argv[1:] == ["--kernel-range"]:  # alone, its own one-rank group where it needs one
        print("kernel range kernels: " + json.dumps(run_kernel_range_slice(smi)), flush=True)
        return 0
    remat_ab = sys.argv[1:] == ["--remat-ab"]  # the whole script, with the remat timings
    if sys.argv[1:] and not remat_ab:
        raise SystemExit(f"chip_smoke.py: unknown arguments {sys.argv[1:]}")

    def clock(what):  # the script's time so far, against its 1200 s limit
        print(f"[clock] {what} done at {time.perf_counter() - T_START:.1f} s", flush=True)

    results = check_kernels() + check_backward_kernels()
    flux_results = check_flux_kernels()
    flux_train_results = check_flux_backward_kernels()
    check_model_grads(*check_model())
    clock("the SD3 and Flux kernel checks")
    run_pipeline()
    clock("SD3 inference")
    mha_results = check_mha_kernels()
    # the context-parallel phase and the SD3 training slice run inside a
    # one-rank NCCL group, so their collectives run on the card
    print(f"process group initialized at {init_group()}", flush=True)
    mha_counts = run_context_parallel()
    for r in mha_results:
        r["launches"] = mha_counts[r["name"]]
    counts = run_training_slice(kernels, smi, remat_ab)
    for r, n in zip(results, counts):
        r["launches"] = n
    clock("context parallelism and SD3 training")
    for phase in (run_cotrain_slice, run_checkpoint_slice, run_dino_slice, run_loader_slice,
                  run_prefix_image_slice, run_eval_tooling_slice, run_remaining_rewards_slice):
        phase(kernels, smi)
        clock(phase.__name__)
    dist.destroy_process_group()
    check_flux_model_grads(*check_flux_model())
    flux_counts = dict(zip(("modulated_layer_norm", "rms_norm_heads", "joint_mha_d128",
                            "mha_bshd"), run_flux_inference(flux_kernels)))
    for r in flux_results:
        r["launches"] = flux_counts[r["name"]]
    clock("Flux inference")
    flux_train_counts = run_flux_training(flux_train_kernels, smi, epochs=FLUX_EPOCHS,
                                          remat_ab=remat_ab)
    clock("Flux training")
    bwd_counts = dict(zip(("joint_attention_bwd_d128", "mha_bshd_bwd"), flux_train_counts[4:]))
    for r in flux_train_results:
        r["launches"] = bwd_counts[r["name"]]
    run_flux_1024_slice(flux_train_kernels, smi)
    clock("Flux 1024^2")
    wan_results = check_wan_kernels()
    check_model_grads(*check_wan_model(), what="2-layer full-width Wan2.1-T2V-1.3B")
    counts, cross = run_wan_sampling(wan_kernels[:4])
    clock("WAN sampling")
    wan_counts = dict(zip(("modulated_layer_norm_wan", "rms_norm_heads_wan", "layer_norm"),
                          counts))
    wan_counts.update(mha_bshd_wan_self=counts[3] - cross, mha_bshd_wan_cross=cross)
    counts, cross = run_wan_training(wan_kernels, smi, remat_ab)
    clock("WAN training")
    wan_counts.update(mha_bshd_bwd_wan_self=counts[4] - cross[1],
                      mha_bshd_bwd_wan_cross=cross[1])
    for r in wan_results:
        r["launches"] = wan_counts[r["name"]]
    wan_results += run_wan_81_slice(wan_kernels, smi)
    clock("WAN 81 frames")
    run_family_loader_slice(smi)
    clock("the Flux and WAN loaders")
    range_results = run_kernel_range_slice(smi)
    clock("the kernel range")
    print(json.dumps({"kernels": results + flux_results + flux_train_results + wan_results
                      + mha_results + range_results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
