"""WAN text-to-video rollouts with per-step log-probabilities and the per-step
KL against the adapter-free policy, and the replay of one window step.

Port of adv_grpo_tpu/rollout/wan.py: 5-D video latents denoised over the
UniPC flow-sigma schedule with the WAN Flow-SDE step (``core/sde.py
wan_sde_step_with_logprob``); with ``kl_reward > 0`` each step also runs the
``lora_scale=0`` policy (the reference's ``transformer.disable_adapter()``)
and records the KL of the two transition means. The JAX ``lax.scan`` is a
Python loop; each step's noise comes from the caller's ``torch.Generator``
(on the latents' device); latents are carried in fp32. No per-step host
sync: the schedule's values enter as Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from adv_grpo_torch.core.sde import wan_sde_step_with_logprob
from adv_grpo_torch.utils.metrics import span


def wan_schedule(num_steps: int, shift: float = 3.0, num_train_timesteps: int = 1000):
    """(sigmas (n+1,), timesteps (n,)) float32 numpy: the UniPC flow-sigma
    schedule as diffusers ``UniPCMultistepScheduler.set_timesteps`` derives it
    with ``use_flow_sigmas=True``:

        alphas = linspace(1, 1/T, N+1)   (float64)
        sigmas = flip(shift*(1-alphas) / (1 + (shift-1)*(1-alphas)))[:-1]
        t_i    = floor(sigmas_i * T)
        sigmas += [0.0]
    """
    alphas = np.linspace(1.0, 1.0 / num_train_timesteps, num_steps + 1, dtype=np.float64)
    base = 1.0 - alphas
    sigmas = np.flip(shift * base / (1.0 + (shift - 1.0) * base))[:-1]
    timesteps = np.floor(sigmas * num_train_timesteps).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return sigmas, timesteps


@dataclasses.dataclass(frozen=True)
class WanSamplerConfig:
    num_steps: int = 50
    shift: float = 3.0
    deterministic: bool = False
    kl_reward: float = 0.0  # > 0 records the per-step KL against lora_scale=0
    num_train_timesteps: int = 1000


class WanRolloutResult(NamedTuple):
    final_latents: torch.Tensor  # (B, C, F, H, W)
    all_latents: torch.Tensor  # (B, num_steps+1, C, F, H, W)
    log_probs: torch.Tensor  # (B, num_steps)
    kl: torch.Tensor  # (B, num_steps), zeros when kl_reward == 0


class WanWindowResult(NamedTuple):
    """The trainer's rollout record (``rollout.sampler.RolloutResult``'s
    fields) plus the per-step KL."""

    final_latents: torch.Tensor  # (B, C, F, H, W)
    latents: torch.Tensor  # (B, T+1, C, F, H, W)
    log_probs: torch.Tensor  # (B, T)
    timesteps: torch.Tensor  # (B, T)
    sigmas: torch.Tensor  # (B, T)
    sigmas_prev: torch.Tensor  # (B, T)
    kl: torch.Tensor  # (B, T), zeros when kl_reward == 0


def _sigma_bounds(sigmas):
    """(sigma_min, sigma_max) of the step: the appended terminal 0 and the
    schedule's second sigma (reference wan_pipeline_with_logprob.py:47-48)."""
    return float(sigmas[-1]), float(sigmas[1])


def _rollout(velocity_fn, latents, generator, cfg: WanSamplerConfig):
    """(final, all latents (B, n+1, ...), log-probs (B, n), KL (B, n),
    sigmas, timesteps) of the whole chain."""
    sigmas, timesteps = wan_schedule(cfg.num_steps, cfg.shift, cfg.num_train_timesteps)
    sigma_min, sigma_max = _sigma_bounds(sigmas)
    b, dev = latents.shape[0], latents.device
    dims = tuple(range(1, latents.ndim))
    x = latents.float()
    lats, lps, kls = [x], [], []
    for i in range(cfg.num_steps):
        t = torch.full((b,), float(timesteps[i]), device=dev)
        step = dict(sigma=float(sigmas[i]), sigma_prev=float(sigmas[i + 1]),
                    sigma_min=sigma_min, sigma_max=sigma_max)
        v = velocity_fn(x, t, 1.0)
        noise = torch.randn(x.shape, generator=generator, device=dev, dtype=torch.float32)
        out = wan_sde_step_with_logprob(v, x, noise=noise, deterministic=cfg.deterministic,
                                        **step)
        if cfg.kl_reward > 0:
            ref = wan_sde_step_with_logprob(velocity_fn(x, t, 0.0), x,
                                            prev_sample=out.prev_sample, **step)
            kl = ((out.prev_sample_mean - ref.prev_sample_mean) ** 2
                  / (2.0 * out.std_dev_t ** 2)).mean(dim=dims)
        else:
            kl = torch.zeros(b, device=dev)
        x = out.prev_sample
        lats.append(x)
        lps.append(out.log_prob)
        kls.append(kl)
    return (x, torch.stack(lats, dim=1), torch.stack(lps, dim=1), torch.stack(kls, dim=1),
            sigmas, timesteps)


def wan_denoise_with_logprob(velocity_fn: Callable, latents: torch.Tensor,
                             generator: torch.Generator, cfg: WanSamplerConfig
                             ) -> WanRolloutResult:
    """The whole chain with every latent, log-prob and KL.
    ``velocity_fn(latents, t (B,), lora_scale)``."""
    final, lats, lps, kls, _, _ = _rollout(velocity_fn, latents, generator, cfg)
    return WanRolloutResult(final, lats, lps, kls)


def wan_denoise_window_with_logprob(velocity_fn: Callable, latents: torch.Tensor,
                                    generator: torch.Generator, cfg: WanSamplerConfig,
                                    train_num_steps: int, rt) -> WanWindowResult:
    """The GRPO rollout: the whole stochastic chain (every step stochastic,
    reference wan_pipeline_with_logprob.py:229-341) with each sample's window
    [rt, rt + T) gathered afterwards (``rt`` an int or a (B,) tensor)."""
    with span("denoise", device=latents.device, rows=latents.shape[0]):
        b, dev = latents.shape[0], latents.device
        T = int(train_num_steps)
        final, lats, lps, kls, sigmas, timesteps = _rollout(velocity_fn, latents, generator, cfg)
        rt = torch.broadcast_to(torch.as_tensor(rt, dtype=torch.long, device=dev), (b,))
        rows = torch.arange(b, device=dev)[:, None]
        w = rt[:, None] + torch.arange(T, device=dev)[None, :]  # (B, T)
        w_lat = rt[:, None] + torch.arange(T + 1, device=dev)[None, :]  # (B, T+1)
        sig = torch.as_tensor(sigmas, device=dev)
        ts = torch.as_tensor(timesteps, device=dev)
        return WanWindowResult(final_latents=final, latents=lats[rows, w_lat],
                               log_probs=lps[rows, w], timesteps=ts[w], sigmas=sig[w],
                               sigmas_prev=sig[w + 1], kl=kls[rows, w])


def make_wan_log_prob_fn(cfg: WanSamplerConfig):
    """The training replay of one WAN window step, with the signature of
    ``rollout.sampler.compute_log_prob`` (the trainer's family seam): returns
    (log_prob, prev_sample_mean, std_dev_t). The negative embeddings and the
    pooled embedding are unused (no CFG batch; WAN conditions on the text
    states only)."""
    sigma_min, sigma_max = _sigma_bounds(
        wan_schedule(cfg.num_steps, cfg.shift, cfg.num_train_timesteps)[0])

    def log_prob(velocity_fn, latents_j, next_latents_j, t_j, sigma_j, sigma_prev_j,
                 prompt_embeds, pooled_embeds, neg_prompt_embeds, neg_pooled_embeds, _scfg):
        del pooled_embeds, neg_prompt_embeds, neg_pooled_embeds, _scfg
        v = velocity_fn(latents_j, t_j, prompt_embeds, None)
        out = wan_sde_step_with_logprob(v, latents_j, sigma_j, sigma_prev_j,
                                        sigma_min=sigma_min, sigma_max=sigma_max,
                                        prev_sample=next_latents_j)
        return out.log_prob, out.prev_sample_mean, out.std_dev_t

    return log_prob
