#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is non-zero):

  1. the card's name and power limit, from nvidia-smi;
  2. build the CUDA kernels from adv_grpo_torch/csrc (nvcc, ctypes);
  3. each kernel of the slice against its plain PyTorch version at the
     SD3.5-M 512^2 shapes, with max errors, stated bounds and median times;
  4. a 2-layer full-width MMDiT on the card (bf16, kernels) against the same
     weights on the CPU (fp32, plain versions) on a small input;
  5. ``adv_grpo_torch.cli.infer.main`` at the full SD3.5-M width (random
     weights from the seed), 512^2, 40 steps, CFG 4.5: the PNG must be
     512x512 and non-constant, and the kernel launch counts must be exactly
     109/24/13 per MMDiT forward times 40 steps;
  6. the same pipeline at 1 prompt (CFG batch 2) and 4 prompts (CFG batch 8):
     finite images, seconds per image.

Prints one JSON line of per-kernel results, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when no
CUDA device is visible or when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

SEED = 0
STEPS = 40
LN_CALLS, JOINT_CALLS, DUAL_CALLS = 109, 24, 13  # per SD3.5-M MMDiT forward


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
    results.append(dict(name="modulated_layer_norm", route="cuda",
                        source="adv_grpo_torch/csrc/fused_norms.cu",
                        replaces="adv_grpo_tpu/ops/fused_norms.py:252",
                        max_abs_err=max_err, ms=ms, plain_ms=plain_ms))

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
    results.append(dict(name="joint_mha", route="cuda",
                        source="adv_grpo_torch/csrc/joint_attention.cu",
                        replaces="adv_grpo_tpu/ops/joint_attention.py:73",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))

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
    results.append(dict(name="mha_rms", route="cuda",
                        source="adv_grpo_torch/csrc/joint_attention.cu",
                        replaces="adv_grpo_tpu/ops/joint_attention.py:644",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))
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
    want = [LN_CALLS * STEPS, JOINT_CALLS * STEPS, DUAL_CALLS * STEPS]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from adv_grpo_torch.kernels import build

    t0 = time.perf_counter()
    build.lib()
    if build.build_seconds is None:
        print(f"kernels: loaded the library already built from these sources in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    else:
        print(f"kernels built from adv_grpo_torch/csrc by nvcc in {build.build_seconds:.2f} s",
              flush=True)
        for line in build.build_log.splitlines():  # ptxas: registers, spills, smem
            if "Used" in line or "spill" in line:
                print("  " + line.strip(), flush=True)

    results = check_kernels()
    check_model()
    counts = run_pipeline()
    for r, n in zip(results, counts):
        r["launches"] = n
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
