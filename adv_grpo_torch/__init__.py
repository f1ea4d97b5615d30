"""adv_grpo_torch — the PyTorch / CUDA port of adv_grpo_tpu for NVIDIA Hopper.

The JAX package ``adv_grpo_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  kernels/  nvcc build of ``csrc/*.cu`` into one ctypes-loaded library
  ops/      hand-written Hopper kernels with their plain PyTorch twins
            (modulated LayerNorm, per-head RMS, joint / single-stream
            qk-RMS attention forward and backward, BSHD and BHSD multi-head
            attention), their autograd Functions, and ring and
            context-parallel attention over a process group
  models/   MMDiT and Flux (diffusers state-dict names), LoRA with the fused
            sibling projection and its subtree helpers, the VAE decoder, and
            the JAX -> torch parameter converters
  core/     the fp32 Flow-CPS and Flow-SDE steps, the flow-match schedule,
            the GRPO loss and advantages, the per-prompt stat tracker, the EMA
  rollout/  the SD3 denoise loop with CFG and the stochastic training window,
            the Flux full-SDE rollouts, and the window-step replays
  rewards/  the host JPEG rewards and their ensembles
  data/     the prompt datasets, the k-repeat sampler, the embedding store
  parallel/ the process group (torchrun's env or an init_method; NCCL or
            gloo) and its numeric gathers, broadcast and gradient mean
  train/    the SD3, Flux and WAN pipeline bundles, the LoRA AdamW state, the
            GRPO phases and the trainer (one process per device)
  config/   the SD3 and Flux presets, as plain dictionaries
  utils/    the FLOP model, the metric logger, the uint8 image packer
  cli/      the inference and training entry points

The package imports torch and never jax, and nothing of adv_grpo_tpu: where
it needs one of the JAX package's jax-free modules it keeps its own copy,
which tests/test_torch_copies.py holds against the original.
"""

__version__ = "0.1.0"
