#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is non-zero):

  1. the card's name and power limit, from nvidia-smi;
  2. build the CUDA kernels from adv_grpo_torch/csrc (nvcc, ctypes);
  3. each forward kernel against its plain PyTorch version at the SD3.5-M
     512^2 shapes, with max errors, stated bounds and median times;
  4. the two attention backward kernels (and the lse the forwards write for
     them) against their plain versions at the training shape, CFG batch 8:
     relative L2 per cotangent, median times, and the whole autograd backward
     against fp32 autograd of the plain forward;
  5. a 2-layer full-width MMDiT on the card (bf16, kernels) against the same
     weights on the CPU (fp32, plain versions) on a small input: the output,
     then the LoRA gradients through a fixed cotangent;
  6. ``adv_grpo_torch.cli.infer.main`` at the full SD3.5-M width (random
     weights from the seed), 512^2, 40 steps, CFG 4.5: the PNG must be
     512x512 and non-constant, and the kernel launch counts must be exactly
     109/24/13 per MMDiT forward times 40 steps;
  7. the same pipeline at 1 prompt (CFG batch 2) and 4 prompts (CFG batch 8):
     finite images, seconds per image;
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
     device memory.
 11. the Flux kernels against their plain versions at the Flux.1-dev 512^2
     shapes: the per-head RMS norm (d = 128, and one head across a 5120-wide
     row), the BSHD attention (B = 1 and 4, and 4608 tokens with kv_len
     4600), the joint attention at head width 128 without RMS, the modulated
     LayerNorm at D = 3072; median times beside the plain versions' and one
     PyTorch library call's;
 12. the Flux attention backward kernels against their plain twins at the
     Flux.1-dev 512^2 shapes: the BSHD backward at B = 1, S = 1536, 24 heads
     of 128 (and 4608 tokens with kv_len 4600), the joint backward at head
     width 128, 1024 + 512 tokens; relative L2 per cotangent, median times
     beside the plain twin's and the SDPA backward's;
 13. a 1-double + 1-single block Flux.1-dev at full width on the card (bf16,
     kernels) against the same weights on the CPU (fp32, plain versions):
     the output, then the LoRA gradients through a fixed cotangent;
 14. ``adv_grpo_torch.cli.infer.generate`` on a full-width Flux.1-dev
     pipeline (random weights from the seed) at 512^2, 28 steps, guidance
     3.5: launch counts exactly 115/152/19/38 per forward times 28 steps,
     finite images, a non-constant 512x512 PNG; then 1 and 4 prompts on the
     warm pipeline: seconds per image, one forward's time and achieved
     TFLOP/s, its device kernel time by group (torch.profiler) and busy
     share, peak device memory;
 15. ``GRPOTrainer`` on a full-width Flux.1-dev pipeline (LoRA r=32, random
     weights from the seed) for 2 epochs of ``flux_smoke`` at 512^2
     (FLUX_TRAIN_OVERRIDES: 8-step full-SDE rollouts of 4 images, 2 window
     steps, one row per microstep, 16 microsteps per epoch, EMA every 2
     steps, the jpeg_compressibility reward): finite metrics, every LoRA
     factor and its EMA moved, the launch counts of all six Flux kernels
     exactly as derived from the config (7,360 / 9,728 / 1,216 / 2,432
     forwards, 608 / 1,216 backwards); seconds per epoch (rollout + decode,
     exposed reward, train), per microstep, peak device memory, and one
     microstep's device time by kernel group (torch.profiler);
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
 19. ``GRPOTrainer`` on a full-width Wan2.1-T2V-1.3B pipeline for 2 epochs
     of ``wan_smoke`` (WAN_TRAIN_OVERRIDES: 33 frames of 480^2, 8-step
     rollouts of one 2-video group per sampling batch, 2 window steps, one
     row per microstep): finite metrics, every LoRA factor and its EMA
     moved, the launch counts of the four WAN kernels and the BSHD backward
     exactly as derived from the config; seconds per epoch, per microstep,
     peak memory and one microstep's device time by kernel group.

``python3 chip_smoke.py --sd3-attention-ab PARENT PAIRS`` instead times the
SD3.5-M attention forwards of the checkout at PARENT (an older tree) against
this one's, in PAIRS alternating pairs of processes;
``python3 chip_smoke.py --attention-bwd-ab PARENT PAIRS`` likewise times the
attention backwards #9 (Flux's (1,1536,3072), WAN self and cross) and #11
(MHA_SHAPES), by CUDA events and by device kernel time.

Prints one JSON line of per-kernel results (each with its least possible time
on the card, from the published H100 SXM peaks), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when no
CUDA device is visible or when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
STEPS = 40
FLUX_STEPS = 28  # FluxSamplerConfig's default, the reference's
# published peaks of one H100 SXM (the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the rate of their type)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
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
# every 2 of the run's 4 optimizer steps; 2 epochs
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
# microsteps, 2 optimizer steps per epoch), EMA every 2 of the run's 4 steps
WAN_STEPS = 50
# #8's max abs error (output and lse) at WAN's self and cross shapes as
# recorded (PERF.md §6, at its precision) when the BSHD forward still
# pre-scaled q and rounded it to bf16: scaling the fp32 scores must not make
# it larger
PRESCALED_Q_MHA_BSHD_ERR = {"self": 1.55e-3, "cross": 3.05e-3}
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
# the backward kernel of #9 and #11 (wgmma + TMA), and its kernels' names as
# ptxas and cuobjdump print them
BWD_SM90_SOURCE = "adv_grpo_torch/csrc/attention_bwd_sm90.cu"
BWD_SM90_KERNELS = ("attn_bwd_sm90_kernel", "attn_bwd_convert_kernel")
WAN_TRAIN_OVERRIDES = [f"resolution={WAN_RES}", f"sample.num_frames={WAN_FRAMES}",
                       "sample.num_steps=8", "sample.train_num_steps=2",
                       "train.micro_splits=2", "train.ema=True", "train.ema_interval=2"]


def per_forward_counts(mcfg):
    """Kernel launches of one MMDiT forward: (modulated LN, joint attention,
    single-stream attention). Per block: the image, context and MLP norms,
    one more for a dual-attention block, one more for the context MLP of every
    block but the last (context_pre_only); then the output norm."""
    n, dual = mcfg.num_layers, len(mcfg.dual_attention_layers)
    return 3 * n + dual + (n - 1) + 1, n, dual


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
    ms = _median_ms(lambda: fused_norms.modulated_layer_norm(x, sc, sh))
    plain_ms = _median_ms(
        lambda: fused_norms.lnmod_reference(x, sc, sh, 1e-6, torch.bfloat16))
    print(f"kernel modulated_layer_norm: max_abs_err {max_err:.3e}, max err "
          f"{worst_ulps:.2f} bf16 ulp (bound 1 ulp of the fp32 result, ulp floored at 2^-15); "
          f"(2,1024,1536) median {ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    if worst_ulps > 1.0:
        raise AssertionError(f"modulated_layer_norm off by {worst_ulps} ulp")
    # no single PyTorch call computes it: F.layer_norm has no per-item
    # (1 + scale, shift) modulation
    results.append(_entry("modulated_layer_norm", "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:252", max_err, ms, plain_ms,
                          _bound(_nbytes(x, sc, sh, x), 8.0 * x.numel(), FP32_FLOPS), None))

    # 2/3: attention; bound 2e-2 absolute, the bf16 bound of the TPU kernel's
    # own tests (adv_grpo_tpu/ops/joint_attention.py:41-45)
    def weights(n):
        return [(1.0 + 0.1 * torch.randn(64, generator=g, device=dev)).float()
                for _ in range(n)]

    qi, ki, vi = (randn(b, s_img, dim) for _ in range(3))
    qt, kt, vt = (randn(b, s_txt, dim) for _ in range(3))
    w4 = weights(4)
    oi, ot = joint_attention.joint_mha(qi, ki, vi, qt, kt, vt, num_heads=heads,
                                       rms_weights=w4)
    ri, rt = joint_attention.joint_mha_reference(
        *(t.float() for t in (qi, ki, vi, qt, kt, vt)), num_heads=heads, rms_weights=w4)
    err = max((oi.float() - ri).abs().max().item(), (ot.float() - rt).abs().max().item())
    ms = _median_ms(lambda: joint_attention.joint_mha(qi, ki, vi, qt, kt, vt,
                                                      num_heads=heads, rms_weights=w4))
    plain_ms = _median_ms(lambda: joint_attention.joint_mha_reference(
        qi, ki, vi, qt, kt, vt, num_heads=heads, rms_weights=w4))
    print(f"kernel joint_mha: max_abs_err {err:.3e} (bound 2e-2); img 1024 + txt 154 "
          f"tokens, 24x64, B=2 median {ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    if not err <= 2e-2:
        raise AssertionError(f"joint_mha error {err}")
    # no library call fuses the qk-RMS into the attention
    results.append(_entry("joint_mha", "adv_grpo_torch/csrc/joint_attention.cu",
                          "adv_grpo_tpu/ops/joint_attention.py:73", err, ms, plain_ms,
                          _attn_bound((qi, ki, vi, qt, kt, vt, qi, qt), b, heads,
                                      s_img + s_txt, s_img + s_txt, 64), None))

    w2 = weights(2)
    o = joint_attention.mha_rms(qi, ki, vi, num_heads=heads, rms_weights=w2)
    r = joint_attention.mha_rms_reference(qi.float(), ki.float(), vi.float(),
                                          num_heads=heads, rms_weights=w2)
    err = (o.float() - r).abs().max().item()
    ms = _median_ms(lambda: joint_attention.mha_rms(qi, ki, vi, num_heads=heads,
                                                    rms_weights=w2))
    plain_ms = _median_ms(lambda: joint_attention.mha_rms_reference(
        qi, ki, vi, num_heads=heads, rms_weights=w2))
    print(f"kernel mha_rms: max_abs_err {err:.3e} (bound 2e-2); (2,1024,1536) 24x64 "
          f"median {ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    if not err <= 2e-2:
        raise AssertionError(f"mha_rms error {err}")
    results.append(_entry("mha_rms", "adv_grpo_torch/csrc/joint_attention.cu",
                          "adv_grpo_tpu/ops/joint_attention.py:644", err, ms, plain_ms,
                          _attn_bound((qi, ki, vi, qi), b, heads, s_img, s_img, 64), None))
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


def check_backward_kernels():
    """Phase: the two backward kernels (and the lse the forwards now write)
    against their plain versions at the training shape: CFG batch 8 of the
    4-image microbatch, 1024 + 154 tokens, 24x64, bf16. Bound: relative L2
    2e-2 per cotangent — bf16 rounding of p and t, the same budget as the
    forward's 2e-2."""
    import torch

    from adv_grpo_torch.ops import joint_attention as ja
    from adv_grpo_torch.ops.attention import bwd_row_stats

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
        print(f"kernel {name}: B={b} {'+'.join(map(str, lens[:n]))} tokens 24x64 median "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)

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
        results.append(_entry(name, "adv_grpo_torch/csrc/joint_attention_bwd.cu", replaces,
                              max_abs, ms, plain_ms, least, None))
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


def check_model_grads(cpu, gpu, inputs, g, what="2-layer full-width MMDiT"):
    """Phase: LoRA gradients of the same 2-layer full-width model (the MMDiT,
    or the WAN; non-zero LoRA B) on the card (bf16, forward and backward
    kernels) and on the CPU (fp32, plain versions), through one fixed
    cotangent. Bound: relative L2 5e-2 of the concatenated LoRA gradients,
    the forward's bf16 budget."""
    import torch

    from adv_grpo_torch.models.lora import freeze_non_lora

    cot = torch.randn(inputs[0].shape, generator=g)
    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        lora = freeze_non_lora(model)
        out = model(*(a.to(dev) for a in inputs))
        gs = torch.autograd.grad(out.float(), list(lora.values()), cot.to(dev))
        grads.append(torch.cat([x.float().flatten().cpu() for x in gs]))
    rel = _rel_l2(grads[1], grads[0])
    print(f"model gradients: {what}, LoRA gradients card bf16 vs CPU fp32 relative L2 "
          f"{rel:.3e} over {grads[0].numel()} values (bound 5e-2)", flush=True)
    if not (torch.isfinite(grads[1]).all() and rel <= 5e-2):
        raise AssertionError(f"card LoRA gradients disagree with the CPU's: {rel}")


def run_pipeline():
    """Phases 5 and 6; returns the launch counts of the main-path run."""
    import numpy as np
    import torch
    from PIL import Image

    from adv_grpo_torch.cli import infer
    from adv_grpo_torch.ops import fused_norms, joint_attention

    kernels = (fused_norms.modulated_layer_norm, joint_attention.joint_mha,
               joint_attention.mha_rms)
    argv = ["--config", "eval_sd3_fast", "--prompts", "a flower",
            "--set", "pretrained.model=''"]
    with tempfile.TemporaryDirectory() as out_dir:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        paths = infer.main(argv + ["--out_dir", out_dir])
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
    return counts


def expected_train_counts(config, mcfg):
    """Launches of the 5 kernels in a TRAIN_ARGV run, from the config: rollout
    forwards (one CFG-batched forward per step), replay forwards and their
    backwards (one per microbatch, two with cfg_sequential)."""
    s, t = config.sample, config.train
    micro = (EPOCHS * max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
             * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    replay = micro * (2 if bool(t.cfg_sequential) and bool(t.cfg) else 1)
    fwd = EPOCHS * int(s.num_batches_per_epoch) * int(s.num_steps) + replay
    return ([c * fwd for c in per_forward_counts(mcfg)]
            + [c * replay for c in per_backward_counts(mcfg)]), micro // EPOCHS


def run_training_slice(kernels):
    """Phase: ``adv_grpo_torch.cli.train.main`` on TRAIN_ARGV (full width,
    random weights from the seed); returns the kernels' launch counts."""
    import os

    import numpy as np
    import torch

    from adv_grpo_torch.cli import train
    from adv_grpo_torch.cli.common import build_pipeline
    from adv_grpo_torch.models.lora import lora_params

    with tempfile.TemporaryDirectory() as save_dir:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train.main(TRAIN_ARGV + ["--set", f"save_dir={save_dir}"])
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
        reward = r["time/reward_wait"] + r["time/reward_dispatch"] * nb
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
    return counts


def flux_per_forward_counts(fcfg):
    """Kernel launches of one Flux forward: (modulated LN, per-head RMS, joint
    attention, BSHD attention). A double block: 4 LNs (attention and MLP of
    both streams), 4 qk-norms, 1 joint attention; a single block: 1 LN, 2
    qk-norms, 1 attention; the output head: 1 LN."""
    n2, n1 = fcfg.num_double_layers, fcfg.num_single_layers
    return 4 * n2 + n1 + 1, 4 * n2 + 2 * n1, n2, n1


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
    results.append(_entry("mha_bshd", "adv_grpo_torch/csrc/joint_attention.cu",
                          "adv_grpo_tpu/ops/attention.py:346", err, ms, plain_ms,
                          _attn_bound((q, k, v, q), 1, heads, s, s, d), lib_ms))

    # 2 at head width 128, no RMS (Flux's double blocks)
    qi, ki, vi = (randn(1, s_img, dim) for _ in range(3))
    qt, kt, vt = (randn(1, s_txt, dim) for _ in range(3))
    streams = (qi, ki, vi, qt, kt, vt)
    oi, ot = joint_attention.joint_mha(*streams, num_heads=heads)
    ri, rt = joint_attention.joint_mha_reference(*(t.float() for t in streams), num_heads=heads)
    err = max((oi.float() - ri).abs().max().item(), (ot.float() - rt).abs().max().item())
    ms = _median_ms(lambda: joint_attention.joint_mha(*streams, num_heads=heads))
    plain_ms = _median_ms(lambda: joint_attention.joint_mha_reference(*streams, num_heads=heads))
    cat4 = [attention.to_bhsd(torch.cat([a, c], dim=1), heads)
            for a, c in ((qi, qt), (ki, kt), (vi, vt))]
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(*cat4))
    print(f"kernel joint_mha (d=128, no RMS): max_abs_err {err:.3e} (bound 2e-2); img 1024 + "
          f"txt 512, 24x128, B=1 median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA on the "
          f"concatenated streams {lib_ms:.4f} ms", flush=True)
    if not err <= 2e-2:
        raise AssertionError(f"joint_mha d=128 error {err}")
    results.append(_entry("joint_mha_d128", "adv_grpo_torch/csrc/joint_attention.cu",
                          "adv_grpo_tpu/ops/joint_attention.py:73", err, ms, plain_ms,
                          _attn_bound(streams + (qi, qt), 1, heads, s, s, d), lib_ms))

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
    import torch.nn.functional as F

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

    def sdpa_bwd_ms(q, k, v, do):  # (B, S, H*D) -> the SDPA backward alone
        leaves = [attention.to_bhsd(t, heads).detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        return _grad_ms((out,), leaves, (attention.to_bhsd(do, heads),))

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
            lib_ms = sdpa_bwd_ms(q, k, v, do)
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
    lib_ms = sdpa_bwd_ms(*cat, torch.cat(do, dim=1))
    least = _attn_bound(tuple(streams) + tuple(do) + tuple(lse) + tuple(di) + tuple(got), 1,
                        heads, s, s, d, products=5)
    print(f"kernel joint_attention_bwd (d=128, no RMS): img 1024 + txt 512, 24x128, B=1 median "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA backward on the concatenated "
          f"streams {lib_ms:.4f} ms; bound {least[0]:.4f} ms", flush=True)
    results.append(_entry("joint_attention_bwd_d128", "adv_grpo_torch/csrc/joint_attention_bwd.cu",
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
    plain versions), through one fixed cotangent. Bound: relative L2 5e-2 of
    the concatenated LoRA gradients, the forward's bf16 budget."""
    import torch

    from adv_grpo_torch.models.lora import freeze_non_lora

    lat, t, ctx, pooled, guidance, ids = inputs
    cot = torch.randn(lat.shape, generator=g)
    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        lora = freeze_non_lora(model)
        out = model(*(a.to(dev) for a in (lat, t, ctx, pooled)), *ids,
                    guidance=guidance.to(dev))
        gs = torch.autograd.grad(out.float(), list(lora.values()), cot.to(dev))
        grads.append(torch.cat([x.float().flatten().cpu() for x in gs]))
    rel = _rel_l2(grads[1], grads[0])
    print(f"model gradients: 1-double + 1-single full-width Flux.1-dev, LoRA gradients card "
          f"bf16 vs CPU fp32 relative L2 {rel:.3e} over {grads[0].numel()} values (bound 5e-2)",
          flush=True)
    if not (torch.isfinite(grads[1]).all() and rel <= 5e-2):
        raise AssertionError(f"card Flux LoRA gradients disagree with the CPU's: {rel}")


_KERNEL_GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("attention kernel", ("attn_fwd_kernel",)),
    ("attention backward kernels", ("attn_bwd_",)),
    ("per-head RMS kernel", ("rms_heads_kernel",)),
    ("modulated LN kernel", ("layer_norm_kernel<__nv_bfloat16, true>",)),
    ("LN kernel", ("layer_norm_kernel<__nv_bfloat16, false>",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "splitK")),
    ("concatenations", ("CatArrayBatchedCopy",)),
    ("copies and casts", ("copy_", "direct_copy", "to_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _profile_forward(fn, reps=2):
    """Trace ``reps`` warm calls of ``fn`` with torch.profiler: (device kernel
    time per call, {kernel group: (launches, ms) per call}). The busy share
    is the kernel time over the call's untraced CUDA-event time (the profiler
    slows the host, so its own wall is no measure of idleness)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    print(f"Flux phase peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return counts


def expected_flux_train_counts(config, fcfg):
    """Launches of the 6 Flux kernels in the FLUX_TRAIN_OVERRIDES run, from
    the config: rollout forwards (one per step of each sampling batch) and
    replay forwards (one per microstep), then the backwards (one per
    microstep: every joint and BSHD attention, all of which a LoRA factor
    reaches)."""
    s, t = config.sample, config.train
    micro = (EPOCHS * max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
             * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    fwd = EPOCHS * int(s.num_batches_per_epoch) * int(s.num_steps) + micro
    return ([c * fwd for c in flux_per_forward_counts(fcfg)]
            + [fcfg.num_double_layers * micro, fcfg.num_single_layers * micro]), micro // EPOCHS


def run_flux_training(kernels):
    """Phase: ``GRPOTrainer`` on a full-width Flux.1-dev pipeline (random
    weights from the seed, LoRA rank and alpha of ``flux_smoke``) for EPOCHS
    epochs of ``flux_smoke`` with FLUX_TRAIN_OVERRIDES; returns the kernels'
    launch counts."""
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

    config = apply_overrides(resolve_config("flux_smoke"), FLUX_TRAIN_OVERRIDES)
    latent_hw = int(config.resolution) // 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fcfg = FluxConfig.dev(lora_rank=int(config.train.lora_rank),
                          lora_alpha=float(config.train.lora_alpha))
    pipeline = FluxPipeline.random_init(
        torch.Generator(device="cuda").manual_seed(SEED), fcfg, VAEConfig.flux(), "cuda",
        latent_hw=latent_hw, text_seq_len=512, guidance=float(config.sample.guidance_scale))
    start = {k: p.detach().clone() for k, p in lora_params(pipeline.transformer).items()}
    encode = build_text_encoder(config, pipeline)
    with tempfile.TemporaryDirectory() as save_dir:
        config.save_dir = save_dir
        trainer = GRPOTrainer(config, pipeline, TextPromptDataset(str(config.dataset), "train"),
                              encode, multi_score(dict(config.reward_fn)), latent_hw=latent_hw)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        trainer.run(max_epochs=EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    want, micro = expected_flux_train_counts(config, fcfg)
    print(f"GRPOTrainer flux_smoke full-width Flux.1-dev 512^2, {config.sample.num_steps}-step "
          f"rollouts of 4 images, {EPOCHS} epochs: {wall:.2f} s wall; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {counts} (LN, RMS, joint, BSHD, joint backward, "
          f"BSHD backward; expected {want})", flush=True)
    nb = int(config.sample.num_batches_per_epoch)
    for r in records:
        rollout = r["time/rollout"] * nb
        reward = r["time/reward_wait"] + r["time/reward_dispatch"] * nb
        print(f"  epoch {r['epoch']}: rollout+decode {rollout:.3f} s, reward {reward:.3f} s "
              f"(not overlapped with a rollout), train {r['time/train']:.3f} s = "
              f"{r['time/train'] / micro:.3f} s per microstep ({micro} microsteps); reward "
              f"{r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}, "
              f"clipfrac {r['clipfrac']:.3f}, rollout "
              f"{r.get('perf/rollout_tflops_per_sec', float('nan')):.1f} TFLOP/s", flush=True)
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"epoch {r['epoch']}: non-finite {bad}")
    if len(records) != EPOCHS or trainer.state.global_step == 0:
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
    sig, ts = flux_schedule(int(config.sample.num_steps), (latent_hw // 2) ** 2)
    dev = torch.device("cuda")
    emb, pooled = (torch.from_numpy(a).to(dev) for a in encode(["a flower"]))
    mb = dict(latents=torch.randn((1, 1, T + 1, (latent_hw // 2) ** 2, fcfg.in_channels),
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
    print(f"  one microstep (B=1, 1536 tokens): {step_ms:.1f} ms (CUDA events); device kernel "
          f"time {kernel_ms / T:.1f} ms = {100 * kernel_ms / T / step_ms:.1f}% busy", flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms / T:.2f} ms, {calls / T:.0f} launches per microstep", flush=True)
    return counts


def wan_per_forward_counts(wcfg):
    """Kernel launches of one WanTransformer forward: (modulated LN, RMS, LN,
    BSHD attention). Per block: 2 modulated LNs (attention and FFN), 4 RMS
    qk-norms (self and cross), 1 LN (the cross-attention input), 2
    attentions; the output head: 1 modulated LN."""
    n = wcfg.num_layers
    return 2 * n + 1, 4 * n, n, 2 * n


def check_wan_kernels():
    """Phase: the kernels of the WAN path against their plain versions at
    the Wan2.1-T2V-1.3B shapes (8,100 video tokens of 33 frames at 480^2, 512
    text tokens, 12 heads of 128, width 1536), with median times beside the
    plain versions' and one PyTorch call's. Bounds: 1 bf16 ulp of the fp32
    result for the norms; 2e-2 absolute for the attention forward (output
    and lse), 2e-2 relative L2 per cotangent for its backward."""
    import torch
    import torch.nn.functional as F

    from adv_grpo_torch.ops import attention, fused_norms
    from adv_grpo_torch.ops.attention import bwd_row_stats

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    heads, d, s, s_txt = 12, 128, 8100, WAN_TEXT
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
    ms = _median_ms(lambda: fused_norms.layer_norm(x))
    plain_ms = _median_ms(lambda: fused_norms.ln_reference(x, 1e-6, torch.bfloat16))
    lib_ms = _median_ms(lambda: F.layer_norm(x, (dim,), eps=1e-6))
    least = _bound(_nbytes(x, x), 8.0 * x.numel(), FP32_FLOPS)
    print(f"kernel layer_norm: max_abs_err {max_err:.3e}, max err {worst:.2f} bf16 ulp (bound 1 "
          f"ulp of the fp32 result) at (1|2,8100,1536); (1,8100,1536) median {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms vs F.layer_norm {lib_ms:.4f} ms; bound {least[0]:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"layer_norm off by {worst} ulp")
    results.append(_entry("layer_norm", "adv_grpo_torch/csrc/fused_norms.cu",
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
    ms = _median_ms(lambda: fused_norms.modulated_layer_norm(x, sc, sh))
    plain_ms = _median_ms(lambda: fused_norms.lnmod_reference(x, sc, sh, 1e-6, torch.bfloat16))
    # one item, so one affine LayerNorm computes the same function
    w_mod, b_mod = 1.0 + sc[0], sh[0]
    lib_ms = _median_ms(lambda: F.layer_norm(x, (dim,), w_mod, b_mod, 1e-6))
    print(f"kernel modulated_layer_norm at WAN's (1,8100,1536): max err {worst:.2f} bf16 ulp "
          f"(bound 1); median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs F.layer_norm with "
          f"weight 1+scale, bias shift {lib_ms:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"modulated_layer_norm at the WAN shape off by {worst} ulp")
    results.append(_entry("modulated_layer_norm_wan", "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:252", max_err, ms, plain_ms,
                          _bound(_nbytes(x, sc, sh, x), 8.0 * x.numel(), FP32_FLOPS), lib_ms))

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
    print(f"kernel rms_norm_heads at WAN's one 1536-wide head, (1,8100,1536) strided: max err "
          f"{worst:.2f} bf16 ulp (bound 1); median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"F.rms_norm {lib_ms:.4f} ms", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"rms_norm_heads at the WAN row off by {worst} ulp")
    results.append(_entry("rms_norm_heads_wan", "adv_grpo_torch/csrc/fused_norms.cu",
                          "adv_grpo_tpu/ops/fused_norms.py:139", max_err, ms, plain_ms,
                          _bound(_nbytes(q, w, q), 4.0 * q.numel(), FP32_FLOPS), lib_ms))
    del qkv, q

    # 8 and 9: self (8100 x 8100) and cross (8100 x 512) attention
    sm_scale = d ** -0.5
    for kind, skv in (("self", s), ("cross", s_txt)):
        q, do = randn(1, s, dim), randn(1, s, dim)
        k, v = randn(1, skv, dim), randn(1, skv, dim)
        o, lse = attention.mha_bshd_fwd(q, k, v, heads, sm_scale, None, want_lse=True)
        ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(),
                                                    num_heads=heads, return_lse=True)
        err = max((o.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        old = _prescaled_q_err(q, k, v, heads, ref, ref_lse) if kind == "self" else None
        del ref, ref_lse
        print(f"  #8 score scaling at WAN {kind}: max abs err {err:.3e} (output and lse) "
              f"against the pre-scaled-q order's recorded {PRESCALED_Q_MHA_BSHD_ERR[kind]:.2e} (q "
              f"rounded to bf16" + ("" if old is None else f"; on the same inputs: {old:.3e}")
              + ")", flush=True)
        if not err <= PRESCALED_Q_MHA_BSHD_ERR[kind]:
            raise AssertionError(f"mha_bshd WAN {kind} error {err} grew past the pre-scaled-q "
                                 f"order's {PRESCALED_Q_MHA_BSHD_ERR[kind]}")
        ms = _median_ms(lambda: attention.mha_bshd(q, k, v, num_heads=heads))
        plain_ms = _median_ms(lambda: attention.mha_bshd_reference(q, k, v, num_heads=heads),
                              iters=5)
        q4, k4, v4 = (attention.to_bhsd(t, heads) for t in (q, k, v))
        lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        least = _attn_bound((q, k, v, o), 1, heads, s, skv, d)
        print(f"kernel mha_bshd WAN {kind} 8100 x {skv}, 12x128: max abs err {err:.3e} (output "
              f"and lse; bound 2e-2); median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs SDPA "
              f"{lib_ms:.4f} ms; bound {least[0]:.4f} ms", flush=True)
        if not err <= 2e-2:
            raise AssertionError(f"mha_bshd WAN {kind} error {err}")
        results.append(_entry(f"mha_bshd_wan_{kind}", "adv_grpo_torch/csrc/joint_attention.cu",
                              "adv_grpo_tpu/ops/attention.py:346", err, ms, plain_ms, least,
                              lib_ms))

        di = bwd_row_stats(o, do, heads)
        got = attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads)
        twin = attention.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                            di, num_heads=heads)
        max_abs = _check_rel_l2(f"mha_bshd_bwd WAN {kind} kernel vs its plain twin (dq, dk, dv)",
                                got, twin)
        del twin
        ms = _median_ms(lambda: attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=heads))
        plain_ms = _median_ms(lambda: attention.bshd_bwd_reference(
            q, k, v, do, lse, di, num_heads=heads), iters=3, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*leaves)
        lib_ms = _grad_ms((out,), leaves, (attention.to_bhsd(do, heads),))
        del out, leaves
        least = _attn_bound((q, k, v, do, lse, di) + tuple(got), 1, heads, s, skv, d, products=5)
        print(f"kernel mha_bshd_bwd WAN {kind} 8100 x {skv}: median {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms vs SDPA backward {lib_ms:.4f} ms; bound {least[0]:.4f} ms",
              flush=True)
        results.append(_entry(f"mha_bshd_bwd_wan_{kind}", BWD_SM90_SOURCE,
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


def _wan_pipeline(config):
    """A full-width Wan2.1-T2V-1.3B pipeline with the preset's LoRA rank and
    alpha, random weights from the seed, at 33 frames of 480^2 and 512 text
    tokens."""
    import torch

    from adv_grpo_torch.models.wan import WanConfig
    from adv_grpo_torch.models.wan_vae import WanVAEConfig
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    vcfg = WanVAEConfig.wan()
    wcfg = WanConfig.t2v_1_3b(lora_rank=int(config.train.lora_rank),
                              lora_alpha=float(config.train.lora_alpha))
    return WanPipeline.random_init(
        torch.Generator(device="cuda").manual_seed(SEED), wcfg, vcfg, "cuda",
        latent_hw=WAN_RES // vcfg.spatial_factor, latent_frames=vcfg.latent_frames(WAN_FRAMES),
        text_seq_len=WAN_TEXT)


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

    t0 = time.perf_counter()
    sample_video(pipeline, latents, text, WanSamplerConfig(num_steps=WAN_STEPS),
                 torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
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
    print(f"  warm: {warm:.2f} s per video; VAE decode {decode_s:.3f} s; one forward "
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


def expected_wan_train_counts(config, wcfg):
    """Launches of the 4 WAN forward kernels and the BSHD backward in the
    WAN_TRAIN_OVERRIDES run, from the config: rollout forwards (one per step
    of each sampling batch; no KL forward: the trainer's pipeline carries no
    kl_reward) and replay forwards (one per microstep, two with a KL loss),
    then the backwards (one per microstep: both attentions of every block,
    all of which a LoRA factor reaches)."""
    s, t = config.sample, config.train
    micro = (EPOCHS * max(int(t.num_inner_epochs), 1) * int(s.num_batches_per_epoch)
             * max(int(t.micro_splits), 1) * int(s.train_num_steps))
    replay = micro * (2 if float(t.beta) > 0 else 1)
    fwd = EPOCHS * int(s.num_batches_per_epoch) * int(s.num_steps) + replay
    return ([c * fwd for c in wan_per_forward_counts(wcfg)]
            + [2 * wcfg.num_layers * micro]), micro // EPOCHS


def run_wan_training(kernels):
    """Phase: ``GRPOTrainer`` on a full-width Wan2.1-T2V-1.3B pipeline
    (random weights from the seed, LoRA rank and alpha of ``wan_smoke``) for
    EPOCHS epochs of ``wan_smoke`` with WAN_TRAIN_OVERRIDES; returns the
    kernels' launch counts and the BSHD forward's and backward's
    cross-attention (S_q != S_kv) shares of theirs."""
    import numpy as np
    import torch

    from adv_grpo_torch.cli.common import apply_overrides, build_text_encoder, resolve_config
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.models.lora import lora_params
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.rollout.wan import wan_schedule
    from adv_grpo_torch.train.driver import GRPOTrainer

    config = apply_overrides(resolve_config("wan_smoke"), WAN_TRAIN_OVERRIDES)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipeline = _wan_pipeline(config)
    wcfg = pipeline.wan_cfg
    latent_hw = int(config.resolution) // 8
    start = {k: p.detach().clone() for k, p in lora_params(pipeline.transformer).items()}
    encode = build_text_encoder(config, pipeline)
    with tempfile.TemporaryDirectory() as save_dir:
        config.save_dir = save_dir
        trainer = GRPOTrainer(config, pipeline, TextPromptDataset(str(config.dataset), "train"),
                              encode, multi_score(dict(config.reward_fn)), latent_hw=latent_hw)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        trainer.run(max_epochs=EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        cross = [k.cross_launches for k in kernels[3:]]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    want, micro = expected_wan_train_counts(config, wcfg)
    print(f"GRPOTrainer wan_smoke full-width Wan2.1-T2V-1.3B, {WAN_FRAMES} frames of "
          f"{WAN_RES}^2, {config.sample.num_steps}-step rollouts of "
          f"{config.sample.mini_num_image_per_prompt} videos, {EPOCHS} epochs: {wall:.2f} s wall; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {counts} (modulated LN, RMS, LN, "
          f"BSHD, BSHD backward; expected {want}), {cross} of the BSHD ones cross-attention",
          flush=True)
    nb = int(config.sample.num_batches_per_epoch)
    for r in records:
        rollout = r["time/rollout"] * nb
        reward = r["time/reward_wait"] + r["time/reward_dispatch"] * nb
        print(f"  epoch {r['epoch']}: rollout+decode {rollout:.3f} s, reward {reward:.3f} s "
              f"(not overlapped with a rollout), train {r['time/train']:.3f} s = "
              f"{r['time/train'] / micro:.3f} s per microstep ({micro} microsteps); reward "
              f"{r['reward_avg']:.5f}, loss {r['loss']:.3e}, approx_kl {r['approx_kl']:.3e}, "
              f"clipfrac {r['clipfrac']:.3f}, rollout "
              f"{r.get('perf/rollout_tflops_per_sec', float('nan')):.1f} TFLOP/s", flush=True)
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"epoch {r['epoch']}: non-finite {bad}")
    if len(records) != EPOCHS or trainer.state.global_step == 0:
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

    # one minibatch of one row and T window steps through the trainer's epoch
    # (T microsteps: replay forward, backward, optimizer), traced
    T = int(config.sample.train_num_steps)
    sig, ts = wan_schedule(int(config.sample.num_steps))
    dev = torch.device("cuda")
    emb, pooled = (torch.from_numpy(a).to(dev) for a in encode(["a flower"]))
    shape = (1, 1, T + 1, wcfg.in_channels, pipeline.latent_frames, latent_hw, latent_hw)
    s_vid = trainer._s_img
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

    step_ms = _median_ms(epoch, iters=3, warmup=1) / T
    kernel_ms, groups = _profile_forward(epoch, reps=1)
    print(f"  one microstep (B=1, {s_vid} video tokens): "
          f"{step_ms:.1f} ms (CUDA events); device kernel time {kernel_ms / T:.1f} ms = "
          f"{100 * kernel_ms / T / step_ms:.1f}% busy", flush=True)
    for grp, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {grp}: {ms / T:.2f} ms, {calls / T:.0f} launches per microstep", flush=True)
    del trainer, pipeline
    torch.cuda.empty_cache()
    return counts, cross

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
        results.append(_entry(f"mha_{name}", "adv_grpo_torch/csrc/joint_attention.cu",
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
    """``--sd3-attention-ms TREE``: median ms (50 CUDA-event-timed calls after
    5 warm-ups, the wrapper's host time included) and device kernel ms (mean
    of 20 traced calls) of the SD3.5-M joint and single-stream qk-RMS
    attention forwards (B=2, 1024 image + 154 text tokens, 24 heads of 64)
    of the ``adv_grpo_torch`` in the checkout at TREE, and the forward
    kernel's registers when this process built it; one JSON line."""
    sys.path.insert(0, tree)
    import re

    import torch

    from adv_grpo_torch.kernels import build
    from adv_grpo_torch.ops import joint_attention

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, s_img, s_txt, heads, dim = 2, 1024, 154, 24, 1536

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    qi, ki, vi = (randn(b, s_img, dim) for _ in range(3))
    qt, kt, vt = (randn(b, s_txt, dim) for _ in range(3))
    w = [(1.0 + 0.1 * torch.randn(64, generator=g, device="cuda")).float() for _ in range(4)]
    joint = _median_ms(lambda: joint_attention.joint_mha(qi, ki, vi, qt, kt, vt, num_heads=heads,
                                                         rms_weights=w), iters=50, warmup=5)
    single = _median_ms(lambda: joint_attention.mha_rms(qi, ki, vi, num_heads=heads,
                                                        rms_weights=w[:2]), iters=50, warmup=5)
    joint_kernel, _ = _profile_forward(lambda: joint_attention.joint_mha(
        qi, ki, vi, qt, kt, vt, num_heads=heads, rms_weights=w), reps=20)
    single_kernel, _ = _profile_forward(lambda: joint_attention.mha_rms(
        qi, ki, vi, num_heads=heads, rms_weights=w[:2]), reps=20)
    # ptxas's registers per thread of the attention forward, when this
    # process built the tree's kernels: {mangled kernel name: registers}
    registers, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "attn_fwd_kernel" in entry:
            registers[entry] = int(m.group(1))
    print(json.dumps({"module": joint_attention.__file__, "joint_mha": joint,
                      "mha_rms": single, "joint_mha_kernel": joint_kernel,
                      "mha_rms_kernel": single_kernel, "registers": registers}), flush=True)


def sd3_attention_ab(parent, pairs):
    """``--sd3-attention-ab PARENT PAIRS``: PAIRS alternating pairs of
    :func:`sd3_attention_ms` runs, each in its own process, of the checkout
    at PARENT and of this one (parent, change, change, parent, ...); prints
    every run, then each side's median and range."""
    import statistics

    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--sd3-attention-ms", parent if side == "parent" else here],
                                 capture_output=True, text=True, check=True).stdout
            r = json.loads(out.strip().splitlines()[-1])
            runs[side].append(r)
            print(f"pair {i} {side}: joint_mha {r['joint_mha']:.4f} ms (kernel "
                  f"{r['joint_mha_kernel']:.4f}), mha_rms {r['mha_rms']:.4f} ms (kernel "
                  f"{r['mha_rms_kernel']:.4f}) ({r['module']})", flush=True)
            for name, n in r["registers"].items():
                print(f"  ptxas: {name} {n} registers", flush=True)
    for side, rs in runs.items():
        for k in ("joint_mha", "joint_mha_kernel", "mha_rms", "mha_rms_kernel"):
            v = [r[k] for r in rs]
            print(f"{side} {k}: median {statistics.median(v):.4f} ms, range "
                  f"{min(v):.4f}..{max(v):.4f} ms over {len(v)} runs", flush=True)


# ``--attention-bwd-ab``: #9 at Flux's (1,1536,3072), WAN self and WAN cross
# (name, B, S_q, S_kv, H, D), and #11 at MHA_SHAPES
BWD_AB_BSHD = (("flux", 1, 1536, 1536, 24, 128), ("wan_self", 1, 8100, 8100, 12, 128),
               ("wan_cross", 1, 8100, WAN_TEXT, 12, 128))


def attention_bwd_ms(tree):
    """``--attention-bwd-ms TREE``: the ``adv_grpo_torch`` in the checkout at
    TREE times its attention backward wrappers, #9 (``mha_bshd_bwd``) at
    BWD_AB_BSHD and #11 (``mha_bwd``) at MHA_SHAPES: median ms of 50
    CUDA-event-timed calls after 5 warm-ups (the wrapper's host time and its
    scratch zeroing included) and device kernel ms per call (mean of 10 traced
    calls, every kernel the call launches); one JSON line."""
    sys.path.insert(0, tree)
    import torch

    from adv_grpo_torch.ops import attention

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
    print(json.dumps(out), flush=True)


def attention_bwd_ab(parent, pairs):
    """``--attention-bwd-ab PARENT PAIRS``: PAIRS alternating pairs of
    :func:`attention_bwd_ms` runs, each in its own process, of the checkout
    at PARENT and of this one (parent, change, change, parent, ...); prints
    every run, then each side's median and range per shape."""
    import statistics

    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--attention-bwd-ms", parent if side == "parent" else here],
                                 capture_output=True, text=True, check=True).stdout
            r = json.loads(out.strip().splitlines()[-1])
            runs[side].append(r)
            print(f"pair {i} {side} ({r['module']}): " + ", ".join(
                f"{k} {v[0]:.4f} ms (kernels {v[1]:.4f})" for k, v in r.items()
                if k != "module"), flush=True)
    keys = [k for k in runs["change"][0] if k != "module"]
    medians = {}
    for side, rs in runs.items():
        for k in keys:
            for j, what in enumerate(("ms", "kernel ms")):
                v = [r[k][j] for r in rs]
                medians[side, k, what] = statistics.median(v)
                print(f"{side} {k} {what}: median {statistics.median(v):.4f}, range "
                      f"{min(v):.4f}..{max(v):.4f} over {len(v)} runs", flush=True)
    for k in keys:
        ratio, kernel_ratio = (medians["parent", k, w] / medians["change", k, w]
                               for w in ("ms", "kernel ms"))
        print(f"{k}: parent / change {ratio:.3f}x by median ms, {kernel_ratio:.3f}x by kernel "
              "ms", flush=True)


def check_bwd_sm90_build(build):
    """The wgmma + TMA backward's ptxas report (registers, shared memory,
    spill stores per instance) from this process's build; raises on a spill
    store or on an instance missing from the report. Where cuobjdump is on
    the machine, prints how many HGMMA (wgmma) instructions each of its
    instances holds."""
    import re

    report, entry = {}, ""
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and any(k in entry for k in BWD_SM90_KERNELS):
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                report.setdefault(entry, {})["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report.setdefault(entry, {})["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                report[entry]["static_smem"] = int(m.group(1)) if m else 0
    names = {n: sum(n in e for e in report) for n in BWD_SM90_KERNELS}
    # the tiles live in dynamic shared memory, sized in the source (Smem) and
    # set at launch; ptxas sees only the static part
    print(f"{BWD_SM90_SOURCE} (ptxas): " + "; ".join(
        f"{e}: {r.get('registers')} registers at entry, {r.get('static_smem')} bytes of static "
        f"shared memory, {r.get('spill_stores')} bytes of spill stores"
        for e, r in sorted(report.items())), flush=True)
    if names["attn_bwd_sm90_kernel"] != 4 or names["attn_bwd_convert_kernel"] != 1:
        raise AssertionError(f"ptxas reported {names} instances of {BWD_SM90_KERNELS}")
    spills = {e: r.get("spill_stores") for e, r in report.items() if r.get("spill_stores") != 0}
    if spills:
        raise AssertionError(f"the backward kernel spills: {spills}")
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("  cuobjdump not found: SASS not inspected", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", build.build()], capture_output=True,
                          text=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        fn = m.group(1) if m else fn
        if fn and "attn_bwd_sm90_kernel" in fn and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
    print(f"  SASS: HGMMA instructions per attn_bwd_sm90_kernel instance {hgmma}", flush=True)
    if len(hgmma) != 4:
        raise AssertionError(f"expected HGMMA in 4 attn_bwd_sm90_kernel instances, got {hgmma}")


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
    print(smi, flush=True)
    if sys.argv[1:2] == ["--sd3-attention-ab"]:
        sd3_attention_ab(sys.argv[2], int(sys.argv[3]))
        return 0
    if sys.argv[1:2] == ["--attention-bwd-ab"]:
        attention_bwd_ab(sys.argv[2], int(sys.argv[3]))
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
        check_bwd_sm90_build(build)

    from adv_grpo_torch.ops import attention, fused_norms, joint_attention

    results = check_kernels() + check_backward_kernels()
    flux_results = check_flux_kernels()
    flux_train_results = check_flux_backward_kernels()
    check_model_grads(*check_model())
    run_pipeline()
    mha_results = check_mha_kernels()
    # the context-parallel phase and the SD3 training slice run inside a
    # one-rank NCCL group, so their collectives run on the card
    import torch.distributed as dist

    print(f"process group initialized at {init_group()}", flush=True)
    mha_counts = run_context_parallel()
    for r in mha_results:
        r["launches"] = mha_counts[r["name"]]
    kernels = (fused_norms.modulated_layer_norm, joint_attention.joint_mha,
               joint_attention.mha_rms, joint_attention.joint_attention_bwd,
               joint_attention.mha_rms_bwd)
    counts = run_training_slice(kernels)
    for r, n in zip(results, counts):
        r["launches"] = n
    dist.destroy_process_group()
    check_flux_model_grads(*check_flux_model())
    flux_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                    joint_attention.joint_mha, attention.mha_bshd)
    flux_counts = dict(zip(("modulated_layer_norm", "rms_norm_heads", "joint_mha_d128",
                            "mha_bshd"), run_flux_inference(flux_kernels)))
    for r in flux_results:
        r["launches"] = flux_counts[r["name"]]
    flux_train_counts = run_flux_training(
        flux_kernels + (joint_attention.joint_attention_bwd, attention.mha_bshd_bwd))
    bwd_counts = dict(zip(("joint_attention_bwd_d128", "mha_bshd_bwd"), flux_train_counts[4:]))
    for r in flux_train_results:
        r["launches"] = bwd_counts[r["name"]]
    wan_results = check_wan_kernels()
    check_model_grads(*check_wan_model(), what="2-layer full-width Wan2.1-T2V-1.3B")
    wan_kernels = (fused_norms.modulated_layer_norm, fused_norms.rms_norm_heads,
                   fused_norms.layer_norm, attention.mha_bshd)
    counts, cross = run_wan_sampling(wan_kernels)
    wan_counts = dict(zip(("modulated_layer_norm_wan", "rms_norm_heads_wan", "layer_norm"),
                          counts))
    wan_counts.update(mha_bshd_wan_self=counts[3] - cross, mha_bshd_wan_cross=cross)
    counts, cross = run_wan_training(wan_kernels + (attention.mha_bshd_bwd,))
    wan_counts.update(mha_bshd_bwd_wan_self=counts[4] - cross[1],
                      mha_bshd_bwd_wan_cross=cross[1])
    for r in wan_results:
        r["launches"] = wan_counts[r["name"]]
    print(json.dumps({"kernels": results + flux_results + flux_train_results + wan_results
                      + mha_results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
