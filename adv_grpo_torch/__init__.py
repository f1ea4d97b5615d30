"""adv_grpo_torch — the PyTorch / CUDA port of adv_grpo_tpu for NVIDIA Hopper.

The JAX package ``adv_grpo_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  kernels/  nvcc build of ``csrc/*.cu`` into one ctypes-loaded library
  ops/      hand-written Hopper kernels with their plain PyTorch twins
            (modulated LayerNorm, joint / single-stream qk-RMS attention
            forward and backward) and their autograd Functions
  models/   MMDiT (diffusers SD3Transformer2DModel state-dict names), LoRA
            with its subtree helpers, the VAE decoder, and the JAX -> torch
            parameter converters
  core/     the fp32 Flow-CPS step, the GRPO loss and advantages, the EMA
  rollout/  the denoise loop with CFG and the stochastic training window,
            and the window-step replay
  rewards/  the host reward ensembles
  train/    the SD3 pipeline bundle, the LoRA AdamW state, the GRPO phases
            and the single-device trainer
  config/   the SD3 presets, as plain dictionaries
  cli/      the inference and training entry points

The package imports torch and never jax; it reuses only the jax-free modules
of adv_grpo_tpu (the flow-match schedule, the hash text encoder, the config
override parser, the embedding store, the uint8 image packer, the prompt
datasets and k-repeat sampler, the per-prompt stat tracker, the host reward
scorers and the metric logger).
"""

__version__ = "0.1.0"
