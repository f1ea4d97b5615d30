"""Generator train state: LoRA-only AdamW with accumulation, clipping and EMA.

Port of adv_grpo_tpu/train/train_state.py:35-108. The JAX package builds the
optimizer as ``optax.MultiSteps(optax.chain(clip_by_global_norm(max_norm),
adamw(...)), every_k)``; this module implements those exact semantics by
hand on the LoRA tensors, because ``torch.optim.AdamW`` and
``clip_grad_norm_`` differ from them:

  * each microbatch's gradient enters a running mean ``acc += (g - acc) /
    (n + 1)`` (optax's Welford accumulation); only every ``accum_steps``-th
    microbatch (a sync step) updates the LoRA, the other updates are zero;
  * at a sync step the *averaged* gradient is clipped to global norm
    ``max_grad_norm`` as ``g / norm * max_norm`` when ``norm >= max_norm``
    (``clip_grad_norm_`` adds 1e-6 to the norm);
  * AdamW: ``mu_hat / (sqrt(nu_hat) + eps) + wd * p``, eps outside the square
    root, bias corrections ``1 - b ** count`` in fp32, then ``p -= lr *
    update``;
  * the EMA advances on sync steps only, when the new global step is a
    multiple of ``ema_interval``, with the decay of the previous global step.

The LoRA parameters are the model's own (updated in place); the optimizer
moments, the accumulator and the EMA are fp32 tensors of the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from adv_grpo_torch.core.ema import ema_decay_at, ema_init, ema_update_
from adv_grpo_torch.utils.metrics import span


@dataclasses.dataclass
class GeneratorState:
    lora: Dict[str, torch.nn.Parameter]  # JAX flat path -> the model's parameter
    acc: Dict[str, torch.Tensor]  # running mean of this window's gradients
    mu: Dict[str, torch.Tensor]  # Adam first moment
    nu: Dict[str, torch.Tensor]  # Adam second moment
    ema: Optional[Dict[str, torch.Tensor]]  # EMA shadow of the LoRA
    hp: Dict[str, float]  # lr, b1, b2, eps, weight_decay, max_grad_norm
    accum_steps: int = 1
    ema_decay: float = 0.9
    ema_interval: int = 8
    count: int = 0  # Adam steps taken (the inner optimizer's count)
    global_step: int = 0  # optimizer (sync) steps
    micro_step: int = 0  # microbatches seen


def make_optimizer(train_cfg) -> Dict[str, float]:
    """The AdamW + clip hyperparameters of ``train_cfg`` (optax's
    ``make_optimizer``; the accumulation count lives on the state)."""
    return dict(lr=float(train_cfg.learning_rate), b1=float(train_cfg.adam_beta1),
                b2=float(train_cfg.adam_beta2), eps=float(train_cfg.adam_epsilon),
                weight_decay=float(train_cfg.adam_weight_decay),
                max_grad_norm=float(train_cfg.max_grad_norm))


def create_generator_state(lora: Dict[str, torch.nn.Parameter], train_cfg,
                           train_num_steps: int,
                           use_ema: Optional[bool] = None) -> GeneratorState:
    """Fresh state over ``lora`` (the model's LoRA parameters by JAX path).

    Accumulation: ``gradient_accumulation_steps * train_num_steps *
    micro_splits`` microbatches per optimizer step, as in the JAX package."""
    accum = (int(train_cfg.gradient_accumulation_steps) * int(train_num_steps)
             * max(int(train_cfg.get("micro_splits", 1)), 1))
    use_ema = bool(train_cfg.ema) if use_ema is None else use_ema

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in lora.items()}

    return GeneratorState(
        lora=lora, acc=zeros(), mu=zeros(), nu=zeros(),
        ema=ema_init(lora) if use_ema else None, hp=make_optimizer(train_cfg),
        accum_steps=accum, ema_decay=float(train_cfg.ema_decay),
        ema_interval=int(train_cfg.ema_interval))


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def _adamw_step_(state: GeneratorState) -> None:
    hp = state.hp
    grads = state.acc
    any_g = next(iter(grads.values()))
    # optax: keep the gradient when norm < max_norm, else g / norm * max_norm
    # (no clipping at all with an infinite max_norm)
    clip = False
    if hp["max_grad_norm"] != float("inf"):
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = bool(norm >= hp["max_grad_norm"])
    state.count += 1
    bc1 = 1.0 - _f32(hp["b1"], any_g) ** state.count
    bc2 = 1.0 - _f32(hp["b2"], any_g) ** state.count
    for k, p in state.lora.items():
        g = grads[k] / norm * hp["max_grad_norm"] if clip else grads[k]
        mu, nu = state.mu[k], state.nu[k]
        mu.mul_(hp["b1"]).add_((1.0 - hp["b1"]) * g)
        nu.mul_(hp["b2"]).add_((1.0 - hp["b2"]) * (g * g))
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + hp["eps"]) + hp["weight_decay"] * p
        p.add_(update * -hp["lr"])
        grads[k].zero_()


def apply_microbatch_grads(state: GeneratorState, grads: Dict[str, torch.Tensor]):
    """One microbatch: fold ``grads`` (JAX path -> gradient) into the running
    mean; on a sync step clip, take the AdamW step and advance the EMA. Updates
    ``state`` and the LoRA parameters in place; returns ``state``. Timed as the device span
    "optimizer" of ``utils.metrics.SPANS``."""
    n = state.micro_step % state.accum_steps
    with span("optimizer", device=next(iter(state.acc.values())).device), torch.no_grad():
        for k, a in state.acc.items():
            a.add_((grads[k].float() - a) / (n + 1))
        prev_step = state.global_step
        state.micro_step += 1
        if state.micro_step % state.accum_steps == 0:
            _adamw_step_(state)
            state.global_step += 1
            if state.ema is not None and state.global_step % state.ema_interval == 0:
                ema_update_(state.ema, state.lora,
                            1.0 - ema_decay_at(prev_step, state.ema_decay))
    return state


def adamw_state(params: Dict[str, torch.nn.Parameter], lr: float, b1: float, b2: float,
                eps: float, weight_decay: float) -> GeneratorState:
    """Plain AdamW state over ``params`` (no clipping, accumulation or EMA):
    ``optax.adamw`` with these hyperparameters, taken by
    :func:`adamw_update_` (the offline PickScore finetune's optimizer)."""
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    return GeneratorState(lora=params, acc={}, mu=zeros(), nu=zeros(), ema=None,
                          hp=dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                  max_grad_norm=float("inf")))


def adamw_update_(state: GeneratorState, grads: Dict[str, torch.Tensor]) -> GeneratorState:
    """One AdamW step of ``state`` (:func:`adamw_state`) on ``grads``, in
    place: the parameters move, the moments advance; ``grads`` are used as
    they are (the step zeroes them after) and hold no accumulated window."""
    state.acc = grads
    _adamw_step_(state)
    state.acc = {}
    state.global_step += 1
    state.micro_step += 1
    return state
