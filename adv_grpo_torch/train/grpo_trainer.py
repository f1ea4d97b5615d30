"""GRPO phases of the trainer: sampling, eval generation, the inner training
epoch, advantages and rebatching, for the sd3, flux and wan families.

Port of adv_grpo_tpu/train/grpo_trainer.py (``make_sample_fn`` :47 with
independent latents, ``make_flux_sample_fn`` :117, ``make_flux_eval_fn`` :151,
``make_wan_sample_fn`` :185, ``make_wan_eval_fn`` :223, ``make_eval_fn`` :247,
``make_train_epoch_fn`` :269, ``compute_advantages`` :546,
``rebatch_for_training`` :559). The JAX phases are jitted functions of
(LoRA, frozen params, batch); here they close over the pipeline, whose
``transformer`` (the MMDiT, Flux or WAN transformer) holds the live LoRA
parameters, and run eagerly:

  * sampling and eval run under ``torch.no_grad()``;
  * the training epoch is a Python loop over (minibatch, window step)
    microbatches in the JAX scan's order; each microbatch replays its window
    step through the transformer's forward and backward (the family's replay:
    the CPS step with its CFG batch for sd3, the Flow-SDE step with embedded
    guidance for flux, the WAN Flow-SDE step over the UniPC sigmas for wan),
    where only the LoRA factors require gradients, averages the gradients
    across the ranks of a process group (``parallel.mesh``; nothing without
    one) and feeds them to ``apply_microbatch_grads``.

The PickScore D-step (``scorer_trainable_mask`` :369,
``make_pickscore_d_step`` :396) trains the CLIP scorer's last vision layers
in place; the DINO D-steps (``make_dino_d_step`` :449,
``make_dino_multi_d_step`` :484) train the DINO head, or the per-layer
heads and the fusion, in place on features of the frozen backbone.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from adv_grpo_torch.adversarial.clip_criterion import pickscore_d_step_loss_and_acc
from adv_grpo_torch.adversarial.dino_hinge import dino_hinge_loss, dino_multi_hinge_loss
from adv_grpo_torch.core.grpo import grpo_loss
from adv_grpo_torch.core.stat_tracking import PerPromptStatTracker, calculate_zero_std_ratio
from adv_grpo_torch.models.lora import lora_params, merge_lora_params
from adv_grpo_torch.parallel import mesh
from adv_grpo_torch.rollout.flux import compute_flux_log_prob, flux_denoise_window_with_logprob
from adv_grpo_torch.rollout.sampler import (
    SamplerConfig, compute_log_prob, denoise_with_logprob)
from adv_grpo_torch.rollout.wan import (
    WanSamplerConfig, make_wan_log_prob_fn, wan_denoise_window_with_logprob)
from adv_grpo_torch.train.train_state import GeneratorState, apply_microbatch_grads

INFO_KEYS = ("loss", "policy_loss", "kl_loss", "approx_kl", "clipfrac",
             "clipfrac_gt_one", "clipfrac_lt_one")


@contextlib.contextmanager
def lora_swapped(module, lora_flat: Dict[str, torch.Tensor]):
    """Run with ``module``'s LoRA parameters set to ``lora_flat`` (e.g. the
    EMA shadow), restoring the live values afterwards."""
    saved = {k: p.detach().clone() for k, p in lora_params(module).items()}
    merge_lora_params(module, lora_flat)
    try:
        yield
    finally:
        merge_lora_params(module, saved)


def make_sample_fn(pipeline, sampler_cfg: SamplerConfig, latent_hw: int):
    """One sampling batch: independent initial latents, the windowed rollout
    and the VAE decode -> (RolloutResult, images in [-1, 1])."""

    @torch.no_grad()
    def sample(embeds, pooled, neg_embeds, neg_pooled, generator, rt):
        lat0 = pipeline.prepare_latents(generator, embeds.shape[0], latent_hw)
        out = denoise_with_logprob(pipeline.velocity_fn(), lat0, embeds, pooled,
                                   neg_embeds, neg_pooled, generator, sampler_cfg, rt)
        return out, pipeline.decode(out.final_latents)

    return sample


def make_eval_fn(pipeline, eval_cfg: SamplerConfig, latent_hw: int):
    """Deterministic eval generation (noise 0) with the given LoRA values (the
    driver passes the EMA when it keeps one) -> images."""

    @torch.no_grad()
    def evaluate(lora_flat, embeds, pooled, neg_embeds, neg_pooled, generator):
        with lora_swapped(pipeline.transformer, lora_flat):
            lat0 = pipeline.prepare_latents(generator, embeds.shape[0], latent_hw)
            out = denoise_with_logprob(pipeline.velocity_fn(), lat0, embeds, pooled,
                                       neg_embeds, neg_pooled, generator, eval_cfg, 0)
            return pipeline.decode(out.final_latents)

    return evaluate


def make_flux_sample_fn(pipeline, sampler_cfg: SamplerConfig, latent_hw: int,
                        same_latent: bool = False, group_size: int = 1):
    """One Flux sampling batch: the full-SDE rollout (every step stochastic),
    the window gather and the decode -> (RolloutResult, images in [-1, 1]).
    The signature of :func:`make_sample_fn`'s closure; the negative
    embeddings are unused (guidance is embedded, there is no CFG batch).
    ``same_latent`` shares each group's initial latent (a full-SDE chain has
    no deterministic prefix to share)."""

    @torch.no_grad()
    def sample(embeds, pooled, neg_embeds, neg_pooled, generator, rt):
        del neg_embeds, neg_pooled
        b = embeds.shape[0]
        if same_latent and group_size > 1:
            lat0 = pipeline.prepare_latents(generator, b // group_size, latent_hw)
            lat0 = lat0.repeat_interleave(group_size, dim=0)
        else:
            lat0 = pipeline.prepare_latents(generator, b, latent_hw)
        vfn = pipeline.velocity_fn()
        out = flux_denoise_window_with_logprob(
            lambda x, t: vfn(x, t, embeds, pooled), lat0, generator, sampler_cfg.num_steps,
            sampler_cfg.train_num_steps, sampler_cfg.noise_level, rt)
        return out, pipeline.decode(out.final_latents)

    return sample


def make_flux_eval_fn(pipeline, eval_cfg: SamplerConfig, latent_hw: int):
    """Deterministic Flux eval generation (noise level 0: the Flow-SDE step
    is the plain flow update) with the given LoRA values -> images."""

    @torch.no_grad()
    def evaluate(lora_flat, embeds, pooled, neg_embeds, neg_pooled, generator):
        del neg_embeds, neg_pooled
        with lora_swapped(pipeline.transformer, lora_flat):
            lat0 = pipeline.prepare_latents(generator, embeds.shape[0], latent_hw)
            vfn = pipeline.velocity_fn()
            out = flux_denoise_window_with_logprob(
                lambda x, t: vfn(x, t, embeds, pooled), lat0, generator, eval_cfg.num_steps,
                0, eval_cfg.noise_level, 0)
            return pipeline.decode(out.final_latents)

    return evaluate


def _wan_sampler_cfg(pipeline, sampler_cfg: SamplerConfig, deterministic: bool = False):
    """The WAN sampler of a trainer's ``SamplerConfig``: the pipeline's shift;
    the per-step KL only when the pipeline carries a ``kl_reward`` (the JAX
    trainer reads it from the pipeline, which ``config.sample.kl_reward``
    never reaches)."""
    return WanSamplerConfig(num_steps=sampler_cfg.num_steps, shift=float(pipeline.shift),
                            deterministic=deterministic,
                            kl_reward=float(getattr(pipeline, "kl_reward", 0.0)))


def make_wan_sample_fn(pipeline, sampler_cfg: SamplerConfig, latent_hw: int,
                       same_latent: bool = False, group_size: int = 1):
    """One WAN sampling batch: the whole stochastic video rollout, the window
    gather and the 3D VAE decode -> (WanWindowResult, video (B, F, 3, H, W)).
    The signature of :func:`make_sample_fn`'s closure; the pooled and negative
    embeddings are unused (no CFG batch). ``same_latent`` shares each group's
    initial latent."""
    wcfg = _wan_sampler_cfg(pipeline, sampler_cfg)

    @torch.no_grad()
    def sample(embeds, pooled, neg_embeds, neg_pooled, generator, rt):
        del pooled, neg_embeds, neg_pooled
        b = embeds.shape[0]
        if same_latent and group_size > 1:
            lat0 = pipeline.prepare_latents(generator, b // group_size, latent_hw)
            lat0 = lat0.repeat_interleave(group_size, dim=0)
        else:
            lat0 = pipeline.prepare_latents(generator, b, latent_hw)
        # the KL's reference policy is the same modules at lora_scale 0
        policies = {s: pipeline.velocity_fn(s) for s in (1.0, 0.0)}
        out = wan_denoise_window_with_logprob(
            lambda x, t, s: policies[s](x, t, embeds), lat0, generator, wcfg,
            sampler_cfg.train_num_steps, rt)
        return out, pipeline.decode(out.final_latents)

    return sample


def make_wan_eval_fn(pipeline, eval_cfg: SamplerConfig, latent_hw: int):
    """Deterministic WAN eval generation (the WAN step's deterministic mode)
    with the given LoRA values -> video."""
    wcfg = _wan_sampler_cfg(pipeline, eval_cfg, deterministic=True)

    @torch.no_grad()
    def evaluate(lora_flat, embeds, pooled, neg_embeds, neg_pooled, generator):
        del pooled, neg_embeds, neg_pooled
        with lora_swapped(pipeline.transformer, lora_flat):
            lat0 = pipeline.prepare_latents(generator, embeds.shape[0], latent_hw)
            vfn = pipeline.velocity_fn()
            out = wan_denoise_window_with_logprob(lambda x, t, s: vfn(x, t, embeds), lat0,
                                                  generator, wcfg, 0, 0)
            return pipeline.decode(out.final_latents)

    return evaluate


def make_train_epoch_fn(pipeline, sampler_cfg: SamplerConfig, train_cfg, beta: float = 0.0):
    """The inner epoch over (minibatch, window-step) microbatches."""
    T = sampler_cfg.train_num_steps
    clip_range = float(train_cfg.clip_range)
    adv_clip_max = float(train_cfg.adv_clip_max)
    # the family seam: the window-step replay is the one family-specific piece
    # of the epoch (sd3: CPS step + CFG batch; flux: Flow-SDE step, embedded
    # guidance; wan: the WAN step over the UniPC sigmas); the signatures are
    # identical
    family = getattr(pipeline, "family", "sd3")
    if family == "wan":
        log_prob_fn = make_wan_log_prob_fn(_wan_sampler_cfg(pipeline, sampler_cfg))
    else:
        log_prob_fn = compute_flux_log_prob if family == "flux" else compute_log_prob

    def microstep(state: GeneratorState, mb, neg_embeds, neg_pooled):
        args = (mb["latents"], mb["next_latents"], mb["t"], mb["sigma"], mb["sigma_prev"],
                mb["embeds"], mb["pooled"], neg_embeds, neg_pooled, sampler_cfg)
        lp, mean, _ = log_prob_fn(pipeline.velocity_fn(), *args)
        mean_ref = None
        if beta > 0.0:
            with torch.no_grad():
                _, mean_ref, _ = log_prob_fn(pipeline.velocity_fn(lora_scale=0.0), *args)
        out = grpo_loss(lp, mb["old_log_prob"], mb["advantages"], clip_range=clip_range,
                        adv_clip_max=adv_clip_max, beta=beta,
                        prev_sample_mean=mean if beta > 0 else None,
                        prev_sample_mean_ref=mean_ref)
        keys = list(state.lora)
        grads = torch.autograd.grad(out.loss, [state.lora[k] for k in keys])
        # data parallelism: the mean over ranks of equal local batches is the
        # gradient of the global batch's mean loss
        mesh.all_reduce_mean_(grads)
        apply_microbatch_grads(state, dict(zip(keys, grads)))
        return torch.stack([getattr(out, k).detach() for k in INFO_KEYS])

    def train_epoch(state: GeneratorState, samples, neg_embeds, neg_pooled):
        """samples: dict of (num_mini, bs, ...) tensors; runs num_mini * T
        microbatches in (minibatch-major, window-step-minor) order and returns
        the mean of each diagnostic."""
        num_mini = samples["latents"].shape[0]
        infos = []
        for idx in range(num_mini * T):
            i, j = idx // T, idx % T
            mini = {k: v[i] for k, v in samples.items()}
            mb = dict(latents=mini["latents"][:, j], next_latents=mini["latents"][:, j + 1],
                      t=mini["timesteps"][:, j], sigma=mini["sigmas"][:, j],
                      sigma_prev=mini["sigmas_prev"][:, j],
                      old_log_prob=mini["log_probs"][:, j], advantages=mini["advantages"],
                      embeds=mini["embeds"], pooled=mini["pooled"])
            infos.append(microstep(state, mb, neg_embeds, neg_pooled))
        means = torch.stack(infos).mean(0).tolist()
        return state, dict(zip(INFO_KEYS, means))

    return train_epoch


# ───────────────────────── discriminator step ─────────────────────────


def scorer_trainable_mask(clip, tune_layer: int) -> Dict[str, bool]:
    """{parameter name: trainable} of the co-trained CLIP scorer: only the
    vision layers ``range(num_layers)[tune_layer:]`` train (the last one for
    the preset's -1; reference train_sd3_fast_pickscore.py:1016-1020
    freezes everything else)."""
    trainable = set(range(clip.vision_model.cfg.num_layers)[tune_layer:])
    return {name: (name.startswith("vision_model.layers.")
                   and int(name.split(".")[2]) in trainable)
            for name, _ in clip.named_parameters()}


def make_pickscore_d_step(scorer, tune_layer: int, d_lr: float):
    """The adversarial PickScore D-step: the CLIP criterion with (real =
    reference images, fake = generated images), Adam(d_lr, betas (0.5,
    0.999), eps 1e-8; ``optax.adam``'s update) on the trainable tail, which
    it updates in place. Every other parameter of the scorer gets
    ``requires_grad=False``, so autograd records nothing below the tail (the
    JAX step's stop_gradient and dead-code elimination). Across the ranks of
    a process group the tail's gradients are averaged, so every rank keeps
    the same discriminator.

    Returns (step, optimizer, tail): ``tail`` the trainable vision layers (a
    ``ModuleList``), ``step(tail, optimizer, images_real, images_fake,
    input_ids) -> (tail, optimizer, loss, accuracy)`` in the JAX step's
    functional form, the gradients left in the tail's ``.grad``."""
    mask = scorer_trainable_mask(scorer.clip, tune_layer)
    for name, p in scorer.clip.named_parameters():
        p.requires_grad_(mask[name])
    layers = scorer.clip.vision_model.layers
    tail = torch.nn.ModuleList(layers[i] for i in range(len(layers))[tune_layer:])
    optimizer = _adam(tail, d_lr)

    def step(tail, optimizer, images_real, images_fake, input_ids):
        loss, acc = pickscore_d_step_loss_and_acc(scorer, images_real, images_fake, input_ids)
        _apply(tail, optimizer, loss)
        return tail, optimizer, loss.detach(), acc

    return step, optimizer, tail


def _adam(module, d_lr: float):
    return torch.optim.Adam(module.parameters(), lr=d_lr, betas=(0.5, 0.999), eps=1e-8)


def _apply(module, optimizer, loss):
    """One Adam step of ``module`` on ``loss``, its gradients averaged over
    the ranks of a process group first (every rank keeps the same D)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_mean_(p.grad for p in module.parameters())
    optimizer.step()


def make_dino_d_step(dino, head, d_lr: float, n_patches: int = 64,
                     patch_loss_weight: float = 0.3):
    """The DINO-head hinge D-step (``adversarial.dino_hinge``):
    Adam(d_lr, betas (0.5, 0.999), eps 1e-8) on ``head`` only, in place, on
    features of the frozen backbone taken without a graph (real and fake in
    separate calls). Returns (step, optimizer); ``step(head, optimizer,
    images_real, images_fake, generator=None, indices=None) -> (head,
    optimizer, loss, accuracy)``. The patch indices are ``indices`` (idx_r,
    idx_f), or drawn from ``generator`` as the JAX step draws them from its
    key: idx_r then idx_f, each over the global batch (every rank's rows),
    of which a rank takes its own."""
    optimizer = _adam(head, d_lr)

    def step(head, optimizer, images_real, images_fake, generator=None, indices=None):
        tokens_real = dino.features(images_real)
        tokens_fake = dino.features(images_fake)
        if indices is None:
            b = tokens_real.shape[0]
            rows = slice(mesh.rank() * b, (mesh.rank() + 1) * b)
            indices = [dino.draw_patch_indices(b * mesh.world_size(), generator, n_patches)[rows]
                       for _ in range(2)]
        idx_r, idx_f = (i.to(tokens_real.device) for i in indices)
        out = dino_hinge_loss(head, tokens_real, tokens_fake, idx_r, idx_f, patch_loss_weight)
        _apply(head, optimizer, out.loss)
        return head, optimizer, out.loss.detach(), out.accuracy

    return step, optimizer


def make_dino_multi_d_step(dino_multi, multi, d_lr: float):
    """The multi-layer DINO D-step: the per-layer heads and the fusion of
    ``multi`` trained together with the top-k pooled hinge
    (``dino_multi_hinge_loss``), Adam as :func:`make_dino_d_step`, in place.
    The step's signature is the single-head one; top-k pooling draws nothing,
    so ``generator`` and ``indices`` go unused."""
    optimizer = _adam(multi, d_lr)

    def step(multi, optimizer, images_real, images_fake, generator=None, indices=None):
        del generator, indices
        toks_r = dino_multi.dino.layer_tokens(images_real, dino_multi.layer_ids)
        toks_f = dino_multi.dino.layer_tokens(images_fake, dino_multi.layer_ids)
        out = dino_multi_hinge_loss(multi.heads, multi.fusion, toks_r, toks_f)
        _apply(multi, optimizer, out.loss)
        return multi, optimizer, out.loss.detach(), out.accuracy

    return step, optimizer


def compute_advantages(tracker: PerPromptStatTracker, prompts, rewards_avg,
                       algorithm: str = "grpo"):
    """Per-prompt advantages and the logged group statistics."""
    advantages = tracker.update(prompts, rewards_avg, type=algorithm)
    group_size, n_prompts = tracker.get_stats()
    zero_std_ratio, reward_std_mean = calculate_zero_std_ratio(prompts, rewards_avg)
    tracker.clear()
    stats = dict(group_size=group_size, trained_prompt_num=n_prompts,
                 zero_std_ratio=zero_std_ratio, reward_std_mean=reward_std_mean)
    return advantages.astype(np.float32), stats


def rebatch_for_training(samples: Dict[str, torch.Tensor], num_minibatches: int):
    """(N, ...) -> (num_minibatches, N // num_minibatches, ...), dropping the
    remainder rows as the JAX package does."""
    out = {}
    for k, v in samples.items():
        bs = v.shape[0] // num_minibatches
        out[k] = v[: num_minibatches * bs].reshape((num_minibatches, bs) + tuple(v.shape[1:]))
    return out
