"""Per-block activation checkpointing: the JAX models' ``remat``.

Port of the JAX ``nn.remat`` around each transformer block
(adv_grpo_tpu/models/mmdit.py:464-479, flux.py:294-295, wan.py:218), set by
``MMDiTConfig.remat`` / ``remat_policy``, ``FluxConfig.remat`` and
``WanConfig.remat`` from the config's ``tpu.remat`` / ``tpu.remat_policy``.
Off by default in the port (on in JAX): every published size measured on an
H100 80GB fits without it, and its recompute slows each microstep.

While autograd records (a training forward), :func:`run_block` runs each
block under non-reentrant ``torch.utils.checkpoint``: the forward keeps only
the block's inputs, and the backward runs the block again to rebuild what
its own backward needs. Non-reentrant, because the GRPO microstep takes
``torch.autograd.grad`` of the LoRA factors, which reentrant checkpointing
refuses; no RNG state is stashed, because no block draws random numbers.
Under ``torch.no_grad()`` / ``inference_mode`` (rollouts, eval, the LoRA-off
reference replay) a block runs as it is, and nothing is checkpointed.

Policies: the MMDiT takes the JAX names ``"full"`` and ``"save_attn"`` (the
JAX default), and both recompute the whole block, the attention kernels
included, as Flux's and WAN's JAX ``nn.remat`` without a policy does. Keeping
the attention outputs through the backward, as the JAX ``save_attn`` does,
bought no time on the H100 and cost memory. The JAX package's three richer
v5e tiers raise by name: they trade memory for less recompute on a 16 GB
chip.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# the JAX MMDiT's policies and the residuals each keeps
# (adv_grpo_tpu/models/mmdit.py:465-471)
SAVED_NAMES = {"save_attn": ("attn_out",), "save_attn_ff": ("attn_out", "ff1"),
               "save_attn_qkv": ("attn_out", "qkv_out"),
               "save_big": ("attn_out", "ff1", "qkv_out"), "full": None}
PORTED_POLICIES = ("full", "save_attn")


def check_policy(policy: str) -> None:
    """Raise for a policy name outside the JAX table (the JAX message), or
    for one of its v5e tiers, which the port does not take."""
    if policy not in SAVED_NAMES:
        raise ValueError(f"unknown remat_policy {policy!r}: "
                         f"expected one of {sorted(SAVED_NAMES)}")
    if policy not in PORTED_POLICIES:
        raise NotImplementedError(
            f"remat_policy {policy!r} also keeps {SAVED_NAMES[policy][1:]}: a v5e tier "
            f"(less recompute for more memory on a 16 GB chip) that is not ported; the port "
            f"takes {PORTED_POLICIES}")


def run_block(block, *args, remat: bool):
    """``block(*args)``, checkpointed when ``remat`` is set and autograd
    records."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
