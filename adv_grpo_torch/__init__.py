"""adv_grpo_torch — the PyTorch / CUDA port of adv_grpo_tpu for NVIDIA Hopper.

The JAX package ``adv_grpo_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  kernels/  nvcc build of ``csrc/*.cu`` into one ctypes-loaded library
  ops/      hand-written Hopper kernels with their plain PyTorch twins
            (modulated LayerNorm, joint / single-stream qk-RMS attention)
  models/   MMDiT (diffusers SD3Transformer2DModel state-dict names), LoRA,
            the VAE decoder, and the JAX -> torch parameter converters
  core/     the fp32 Flow-CPS step
  rollout/  the denoise loop with CFG and the stochastic training window
  train/    the SD3 pipeline bundle
  config/   the SD3 presets, as plain dictionaries
  cli/      the inference entry point

The package imports torch and never jax; it reuses only the jax-free modules
of adv_grpo_tpu (the flow-match schedule, the hash text encoder, the config
override parser, the embedding store and the uint8 image packer).
"""

__version__ = "0.1.0"
