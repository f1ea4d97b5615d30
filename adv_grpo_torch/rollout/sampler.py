"""Denoise rollout with a stochastic training window and per-step logprobs,
and the training replay of one window step.

Port of adv_grpo_tpu/rollout/sampler.py (``SamplerConfig``,
``RolloutResult``, ``denoise_with_logprob``, ``denoise_prefix``,
``compute_log_prob``, ``sample_random_timestep``, ``denoise_from_image``). The
JAX ``lax.scan`` is a Python loop here:

  * the step loop walks the flow-match schedule (``core/scheduler.py``);
  * CFG runs as one batched forward with [uncond ; cond] stacked on the batch
    axis, uncond first, and the guidance combine runs in the model's output
    dtype (bf16 at full size); only the CPS step lifts to fp32;
  * latents are carried in fp32;
  * the noise of every step comes from the caller's ``torch.Generator``;
  * the window [random_timestep, random_timestep + train_num_steps) gets
    ``noise_level``, every other step is deterministic; with
    ``train_num_steps > 0`` each step's input/output latents, logprob, timestep
    and sigmas are recorded and the per-sample window gathered at the end;
  * steps before ``start_idx`` (the image-to-image entry) pass x through: no
    model call, log-prob 0 and no noise drawn (the JAX ``skip_step`` splits
    no key), but they are recorded, so the window gather indexes by step.

``denoise_from_image`` draws the posterior sample, the forward noise and the
rollout's noise from one generator, in that order, where the JAX function
splits its key three ways.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from adv_grpo_torch.core.scheduler import flow_match_schedule
from adv_grpo_torch.core.sde import cps_step_with_logprob


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 10
    train_num_steps: int = 2
    guidance_scale: float = 4.5
    noise_level: float = 0.7
    shift: float = 3.0
    num_train_timesteps: int = 1000
    # training replay only: the CFG uncond/cond halves as two sequential
    # B-sized forwards instead of one 2B-batched forward (same math, half the
    # activations the backward keeps)
    cfg_sequential: bool = False

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


class RolloutResult(NamedTuple):
    final_latents: torch.Tensor  # (B, C, h, w) raw latents after the last step
    latents: torch.Tensor  # (B, T+1, C, h, w) training-window latents
    log_probs: torch.Tensor  # (B, T)
    timesteps: torch.Tensor  # (B, T)
    sigmas: torch.Tensor  # (B, T) sigma at each window step
    sigmas_prev: torch.Tensor  # (B, T)


def denoise_with_logprob(
    velocity_fn: Callable,
    latents: torch.Tensor,
    prompt_embeds: torch.Tensor,
    pooled_embeds: torch.Tensor,
    neg_prompt_embeds: Optional[torch.Tensor],
    neg_pooled_embeds: Optional[torch.Tensor],
    generator: torch.Generator,
    cfg: SamplerConfig,
    random_timestep=0,
    start_idx: int = 0,
) -> RolloutResult:
    """Run the full denoise chain and extract the stochastic training window.

    velocity_fn(latents, timestep (B,), prompt_embeds, pooled) -> velocity.
    ``random_timestep`` is an int or a per-sample (B,) tensor; the steps
    before ``start_idx`` pass x through (fp32, log-prob 0, no noise drawn).
    """
    sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift,
                                num_train_timesteps=cfg.num_train_timesteps)
    dev = latents.device
    B = latents.shape[0]
    T = cfg.train_num_steps
    rt = torch.broadcast_to(torch.as_tensor(random_timestep, dtype=torch.long,
                                            device=dev), (B,))
    if cfg.do_cfg:
        embeds = torch.cat([neg_prompt_embeds, prompt_embeds], dim=0)
        pooled = torch.cat([neg_pooled_embeds, pooled_embeds], dim=0)
    else:
        embeds, pooled = prompt_embeds, pooled_embeds

    x = latents.float()
    record = []
    for i in range(cfg.num_steps):
        t = float(sched.timesteps[i])
        sig, sig_prev = float(sched.sigmas[i]), float(sched.sigmas[i + 1])
        if i < start_idx:  # pass-through: no model call, no noise drawn
            if T:
                record.append((x, x, torch.zeros((B,), device=dev), t, sig, sig_prev))
            continue
        nl = torch.where((i >= rt) & (i < rt + T), cfg.noise_level, 0.0).float()
        v = _guided_velocity(velocity_fn, x, t, embeds, pooled, cfg)
        noise = torch.randn(x.shape, generator=generator, device=dev, dtype=torch.float32)
        out = cps_step_with_logprob(v, x, sig, sig_prev, nl, noise=noise)
        if T:
            record.append((x, out.prev_sample, out.log_prob, t, sig, sig_prev))
        x = out.prev_sample

    if T == 0:
        empty = torch.zeros((B, 0), device=dev)
        return RolloutResult(x, torch.zeros((B, 0) + x.shape[1:], device=dev),
                             empty, empty, empty, empty)

    # gather each sample's window steps rt[b] .. rt[b] + T - 1
    steps = rt[:, None] + torch.arange(T, device=dev)[None, :]  # (B, T)
    rows = torch.arange(B, device=dev)[:, None]
    x_in = torch.stack([r[0] for r in record], dim=1)  # (B, num_steps, C, h, w)
    x_out = torch.stack([r[1] for r in record], dim=1)
    lp = torch.stack([r[2] for r in record], dim=1)  # (B, num_steps)

    def per_step(k):
        vals = torch.tensor([r[k] for r in record], dtype=torch.float32, device=dev)
        return vals[steps]

    return RolloutResult(
        final_latents=x,
        latents=torch.cat([x_in[rows[:, 0], rt][:, None], x_out[rows, steps]], dim=1),
        log_probs=lp[rows, steps],
        timesteps=per_step(3),
        sigmas=per_step(4),
        sigmas_prev=per_step(5),
    )


def _guided_velocity(velocity_fn, x, t: float, embeds, pooled, cfg: SamplerConfig):
    """The velocity at x: one forward at the CFG batch [uncond ; cond] and the
    guidance combine, or one forward without CFG."""
    B = x.shape[0]
    if not cfg.do_cfg:
        return velocity_fn(x, torch.full((B,), t, device=x.device), embeds, pooled)
    v = velocity_fn(torch.cat([x, x], dim=0), torch.full((2 * B,), t, device=x.device),
                    embeds, pooled)
    v_uncond, v_cond = v.chunk(2, dim=0)
    return v_uncond + cfg.guidance_scale * (v_cond - v_uncond)


def denoise_prefix(velocity_fn: Callable, latents: torch.Tensor, prompt_embeds: torch.Tensor,
                   pooled_embeds: torch.Tensor, neg_prompt_embeds: Optional[torch.Tensor],
                   neg_pooled_embeds: Optional[torch.Tensor], cfg: SamplerConfig,
                   rt: int) -> torch.Tensor:
    """The deterministic schedule prefix: steps [0, rt) at noise level 0 (the
    noise a zero tensor), the CFG batch as in the rollout; fp32 latents out.
    The group-shared sampler runs it on one latent per prompt slot (the
    pre-window trajectory is the same for every member of a group), so it
    saves (1 - 1/group) of the pre-window forwards. ``rt == 0`` returns the
    latents in fp32."""
    x = latents.float()
    if rt == 0:
        return x
    sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift,
                                num_train_timesteps=cfg.num_train_timesteps)
    if cfg.do_cfg:
        embeds = torch.cat([neg_prompt_embeds, prompt_embeds], dim=0)
        pooled = torch.cat([neg_pooled_embeds, pooled_embeds], dim=0)
    else:
        embeds, pooled = prompt_embeds, pooled_embeds
    for i in range(int(rt)):
        v = _guided_velocity(velocity_fn, x, float(sched.timesteps[i]), embeds, pooled, cfg)
        x = cps_step_with_logprob(v, x, float(sched.sigmas[i]), float(sched.sigmas[i + 1]),
                                  0.0, noise=torch.zeros_like(x)).prev_sample
    return x


def compute_log_prob(velocity_fn: Callable, latents_j, next_latents_j, t_j, sigma_j,
                     sigma_prev_j, prompt_embeds, pooled_embeds, neg_prompt_embeds,
                     neg_pooled_embeds, cfg: SamplerConfig):
    """Training-time re-forward of one window step under the current weights:
    replays the recorded transition (``prev_sample=next_latents_j``) and scores
    it. Returns (log_prob, prev_sample_mean, std_dev_t)."""
    if cfg.do_cfg and cfg.cfg_sequential:
        v_uncond = velocity_fn(latents_j, t_j, neg_prompt_embeds, neg_pooled_embeds)
        v_cond = velocity_fn(latents_j, t_j, prompt_embeds, pooled_embeds)
        v = v_uncond + cfg.guidance_scale * (v_cond - v_uncond)
    elif cfg.do_cfg:
        v = velocity_fn(torch.cat([latents_j, latents_j], dim=0), torch.cat([t_j, t_j]),
                        torch.cat([neg_prompt_embeds, prompt_embeds], dim=0),
                        torch.cat([neg_pooled_embeds, pooled_embeds], dim=0))
        v_uncond, v_cond = v.chunk(2, dim=0)
        v = v_uncond + cfg.guidance_scale * (v_cond - v_uncond)
    else:
        v = velocity_fn(latents_j, t_j, prompt_embeds, pooled_embeds)
    out = cps_step_with_logprob(v, latents_j, sigma_j, sigma_prev_j, cfg.noise_level,
                                prev_sample=next_latents_j)
    return out.log_prob, out.prev_sample_mean, out.std_dev_t


def sample_random_timestep(rng: np.random.Generator, cfg: SamplerConfig, shape=()):
    """Window start ~ U{0, num_steps // 2}, drawn from a numpy generator (the
    JAX driver draws it with numpy too, adv_grpo_tpu/train/driver.py:283)."""
    return rng.integers(0, cfg.num_steps // 2 + 1, size=shape)


def denoise_from_image(velocity_fn: Callable, encode_image_fn: Callable, images: torch.Tensor,
                       prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
                       neg_prompt_embeds: Optional[torch.Tensor],
                       neg_pooled_embeds: Optional[torch.Tensor], generator: torch.Generator,
                       cfg: SamplerConfig, start_idx: int, random_timestep=None
                       ) -> RolloutResult:
    """Distribution transfer (the reference's ``flux_to_sd3_denoise``): an
    external image, VAE-encoded by ``encode_image_fn(images, generator)`` (a
    posterior sample), forward-noised at the schedule's ``start_idx``,

        x = (1 - sigma[start_idx]) * x0 + sigma[start_idx] * noise,

    then denoised by the windowed sampler from that step (the window at
    ``random_timestep``, by default ``start_idx``). The posterior sample, the
    noise and the rollout's noise come from ``generator`` in that order."""
    sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift,
                                num_train_timesteps=cfg.num_train_timesteps)
    x0 = encode_image_fn(images, generator).float()
    sigma0 = np.float32(sched.sigmas[int(start_idx)])
    noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=torch.float32)
    latents = float(np.float32(1.0) - sigma0) * x0 + float(sigma0) * noise
    rt = start_idx if random_timestep is None else random_timestep
    return denoise_with_logprob(velocity_fn, latents, prompt_embeds, pooled_embeds,
                                neg_prompt_embeds, neg_pooled_embeds, generator, cfg,
                                random_timestep=rt, start_idx=int(start_idx))
