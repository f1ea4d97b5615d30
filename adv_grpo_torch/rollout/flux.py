"""Flux denoise rollouts with per-step log-probabilities, and the replay of
one window step.

Port of adv_grpo_tpu/rollout/flux.py: packed 2x2 latent tokens, the
resolution-dependent dynamic timestep shift (``calculate_shift``), every step
through the original Flow-SDE step (``core/sde.py
flow_sde_step_with_logprob``), and the Kontext editing mode of
``flux_denoise_with_logprob``: packed conditioning latents
(``train.flux_pipeline.FluxPipeline.encode_image``) concatenated after the
sample tokens for each model call, whose velocity is cut back to the sample
tokens before the step. The JAX ``lax.scan`` is a Python loop; the
noise of every step comes from the caller's ``torch.Generator``; latents are
carried in fp32. Flux's guidance is an embedded model input, so there is no
CFG batch and no negative prompt here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from adv_grpo_torch.core.sde import flow_sde_step_with_logprob
from adv_grpo_torch.rollout.sampler import RolloutResult
from adv_grpo_torch.utils.metrics import span

NUM_TRAIN_TIMESTEPS = 1000  # the flow-matching scheduler's, timestep = sigma * 1000


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """mu of the dynamic timestep shift (reference flux_...logprob.py:9-19)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def flux_schedule(num_steps: int, image_seq_len: int):
    """(sigmas (n+1,), timesteps (n,)) float32 numpy: ``linspace(1, 1/n, n)``
    time-shifted by exp(mu), a terminal 0 appended."""
    mu = calculate_shift(image_seq_len)
    base = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    e = math.exp(mu)
    sigmas = e / (e + (1.0 / base - 1.0))
    timesteps = (sigmas * NUM_TRAIN_TIMESTEPS).astype(np.float32)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32), timesteps


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 * W/2, 4C) Flux token packing."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H/2 * W/2, 4C) -> (B, C, H, W)."""
    b, _, d = tokens.shape
    x = tokens.reshape(b, height // 2, width // 2, d // 4, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, d // 4, height, width)


@dataclasses.dataclass(frozen=True)
class FluxSamplerConfig:
    num_steps: int = 28
    noise_level: float = 0.7


class FluxRolloutResult(NamedTuple):
    final_latents: torch.Tensor  # packed (B, S, D)
    all_latents: torch.Tensor  # (B, num_steps+1, S, D)
    log_probs: torch.Tensor  # (B, num_steps)
    timesteps: torch.Tensor  # (B, num_steps)


def _rollout(velocity_fn, packed_latents, generator, num_steps, noise_level,
             cond_latents=None):
    """Every step stochastic: (final, all latents (B, n+1, S, D), log-probs
    (B, n), sigmas, timesteps) of the full-SDE chain; with ``cond_latents``
    the model sees [x ; cond] along the sequence and its velocity's first S
    tokens step x."""
    b, s = packed_latents.shape[:2]
    dev = packed_latents.device
    sigmas, timesteps = flux_schedule(num_steps, s)
    sigma_at_one = float(sigmas[1])
    x = packed_latents.float()
    lats, lps = [x], []
    for i in range(num_steps):
        t = torch.full((b,), float(timesteps[i]), device=dev)
        if cond_latents is None:
            v = velocity_fn(x, t)
        else:
            v = velocity_fn(torch.cat([x, cond_latents.to(x.dtype)], dim=1), t)[:, :s]
        noise = torch.randn(x.shape, generator=generator, device=dev, dtype=torch.float32)
        out = flow_sde_step_with_logprob(v, x, float(sigmas[i]), float(sigmas[i + 1]),
                                         noise_level, sigma_at_one=sigma_at_one, noise=noise)
        x = out.prev_sample
        lats.append(x)
        lps.append(out.log_prob)
    return x, torch.stack(lats, dim=1), torch.stack(lps, dim=1), sigmas, timesteps


def flux_denoise_with_logprob(velocity_fn: Callable, packed_latents: torch.Tensor,
                              generator: torch.Generator, cfg: FluxSamplerConfig,
                              cond_latents: Optional[torch.Tensor] = None
                              ) -> FluxRolloutResult:
    """Full-SDE rollout, all latents and log-probs returned (reference flux
    loop :141-187). ``velocity_fn(packed, t (B,))``. ``cond_latents`` (packed,
    (B, S_c, D)) is the Kontext editing mode (reference kontext :209-211):
    concatenated along the sequence for each model call, and the velocity's
    sample tokens ``[:, :S]`` step x."""
    final, lats, lps, _, timesteps = _rollout(
        velocity_fn, packed_latents, generator, cfg.num_steps, cfg.noise_level, cond_latents)
    b = packed_latents.shape[0]
    ts = torch.as_tensor(timesteps, device=packed_latents.device).expand(b, -1)
    return FluxRolloutResult(final, lats, lps, ts)


def flux_denoise_window_with_logprob(velocity_fn: Callable, packed_latents: torch.Tensor,
                                     generator: torch.Generator, num_steps: int,
                                     train_num_steps: int, noise_level: float, rt
                                     ) -> RolloutResult:
    """The GRPO rollout of the Flux lineage: every step stochastic, every
    transition recorded, and each sample's window [rt, rt + T) gathered
    afterwards (``rt`` an int or a per-sample (B,) tensor). Returns the
    trainer's ``RolloutResult``: latents (B, T+1, S, D), log_probs /
    timesteps / sigmas / sigmas_prev (B, T), final_latents (B, S, D)."""
    with span("denoise", device=packed_latents.device, rows=packed_latents.shape[0]):
        b = packed_latents.shape[0]
        dev = packed_latents.device
        T = int(train_num_steps)
        final, lats, lps, sigmas, timesteps = _rollout(
            velocity_fn, packed_latents, generator, num_steps, noise_level)
        rt = torch.broadcast_to(torch.as_tensor(rt, dtype=torch.long, device=dev), (b,))
        rows = torch.arange(b, device=dev)[:, None]
        w = rt[:, None] + torch.arange(T, device=dev)[None, :]  # (B, T)
        w_lat = rt[:, None] + torch.arange(T + 1, device=dev)[None, :]  # (B, T+1)
        sig = torch.as_tensor(sigmas, device=dev)
        ts = torch.as_tensor(timesteps, device=dev)
        return RolloutResult(final_latents=final, latents=lats[rows, w_lat],
                             log_probs=lps[rows, w], timesteps=ts[w], sigmas=sig[w],
                             sigmas_prev=sig[w + 1])


def compute_flux_log_prob(velocity_fn, latents_j, next_latents_j, t_j, sigma_j, sigma_prev_j,
                          prompt_embeds, pooled_embeds, neg_prompt_embeds, neg_pooled_embeds,
                          cfg):
    """Training replay of one window step (the Flux counterpart of
    ``rollout.sampler.compute_log_prob``): the recorded transition re-scored
    under the current weights. ``cfg`` carries ``num_steps`` and
    ``noise_level``; the negative embeddings are unused (no CFG batch).
    Returns (log_prob, prev_sample_mean, std_dev_t)."""
    del neg_prompt_embeds, neg_pooled_embeds
    sigmas, _ = flux_schedule(cfg.num_steps, latents_j.shape[1])
    v = velocity_fn(latents_j, t_j, prompt_embeds, pooled_embeds)
    out = flow_sde_step_with_logprob(v, latents_j, sigma_j, sigma_prev_j, cfg.noise_level,
                                     sigma_at_one=float(sigmas[1]), prev_sample=next_latents_j)
    return out.log_prob, out.prev_sample_mean, out.std_dev_t
