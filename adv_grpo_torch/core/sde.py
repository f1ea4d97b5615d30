"""Flow sampling steps with their Gaussian log-probabilities.

Port of adv_grpo_tpu/core/sde.py:54 ``cps_step_with_logprob`` (reference
``sde_step_with_logprob_new``, the SD3 sampler's step), :112
``flow_sde_step_with_logprob`` (the original Flow-SDE step, the Flux
sampler's) and :171 ``wan_sde_step_with_logprob`` (the WAN video sampler's). All math runs in a float32 island whatever the
input dtype: bf16 can overflow here, and GRPO's clip range of 1e-5 makes the
ratio exp(lp - lp_old) meaningful only at fp32 precision.

``sigma`` / ``sigma_prev`` / ``noise_level`` may be python scalars, 0-d tensors
or per-sample (B,) tensors; they broadcast against the batch axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class SDEStepResult(NamedTuple):
    prev_sample: torch.Tensor  # x_{t-1}, float32
    log_prob: torch.Tensor  # (B,) per-sample logprob (mean over non-batch dims)
    prev_sample_mean: torch.Tensor  # mean of the transition Gaussian, float32
    std_dev_t: torch.Tensor  # (B, 1, ...) pre-dt noise scale (reference field)


def _bcast(x, like: torch.Tensor) -> torch.Tensor:
    """Scalar / (B,) coefficient -> fp32 tensor broadcasting over (B, ...).

    A Python number becomes a device tensor by a fill, not by
    ``torch.as_tensor``, whose host-to-device copy would make every sampler
    step wait for the device to drain."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=like.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    if x.ndim == 0:
        return x
    return x.reshape(x.shape[0], *([1] * (like.ndim - 1)))


def cps_step_with_logprob(model_output, sample, sigma, sigma_prev, noise_level, *,
                          noise: Optional[torch.Tensor] = None,
                          prev_sample: Optional[torch.Tensor] = None) -> SDEStepResult:
    """One Flow-CPS transition x_t -> x_{t-1} with its Gaussian log-probability.

        std_t   = sigma_prev * sin(noise_level * pi/2)
        x0_hat  = x - sigma * v
        x1_hat  = x + v * (1 - sigma)
        mean    = x0_hat * (1 - sigma_prev) + x1_hat * sqrt(sigma_prev^2 - std_t^2)
        x_{t-1} = mean + std_t * eps                       (sampling, ``noise``)
        logprob = mean_{non-batch}( -(x_{t-1} - mean)^2 )  (constants dropped)

    Pass ``noise`` (a standard normal draw) to sample, or ``prev_sample`` to
    score an existing transition (the GRPO replay).
    """
    v = model_output.float()
    x = sample.float()
    nl = _bcast(noise_level, x)
    sig = _bcast(sigma, x)
    sig_prev = _bcast(sigma_prev, x)

    std_dev_t = sig_prev * torch.sin(nl * math.pi / 2.0)
    pred_original = x - sig * v
    noise_estimate = x + v * (1.0 - sig)
    prev_sample_mean = pred_original * (1.0 - sig_prev) + noise_estimate * torch.sqrt(
        torch.clamp(sig_prev**2 - std_dev_t**2, min=0.0))

    if prev_sample is None:
        if noise is None:
            raise ValueError("cps_step_with_logprob: provide either noise or prev_sample")
        prev_sample = prev_sample_mean + std_dev_t * noise.float()
    else:
        prev_sample = prev_sample.float()

    # prev_sample is observed data: no gradient flows through it
    delta = prev_sample.detach() - prev_sample_mean
    log_prob = (-(delta**2)).mean(dim=tuple(range(1, x.ndim)))
    std_b = torch.broadcast_to(std_dev_t, (x.shape[0],) + (1,) * (x.ndim - 1))
    return SDEStepResult(prev_sample, log_prob, prev_sample_mean, std_b)


def flow_sde_step_with_logprob(model_output, sample, sigma, sigma_prev, noise_level, *,
                               sigma_at_one: float, noise: Optional[torch.Tensor] = None,
                               prev_sample: Optional[torch.Tensor] = None) -> SDEStepResult:
    """The original Flow-SDE step with the FULL Gaussian log-probability
    (adv_grpo_tpu/core/sde.py:112; reference sd3_sde_with_logprob.py:44-71),
    the step of the Flux rollouts:

        dt      = sigma_prev - sigma                     (negative)
        std_t   = sqrt(sigma / (1 - sigma')) * noise_level,
                  sigma' = sigma_at_one where sigma == 1 else sigma
        mean    = x*(1 + std_t^2/(2 sigma) dt) + v*(1 + std_t^2 (1-sigma)/(2 sigma)) dt
        x_{t-1} = mean + std_t sqrt(-dt) * eps
        logprob = mean_{non-batch}( -(x_{t-1}-mean)^2 / (2 (std_t sqrt(-dt))^2)
                                    - log(std_t sqrt(-dt)) - log(sqrt(2 pi)) )

    ``sigma_at_one`` is the schedule's second sigma, the reference's guard
    for the first step where sigma == 1. At noise level 0 the step is the
    deterministic Euler step and the log-probability is NaN (0/0), as in the
    JAX package; the inference path ignores it.
    """
    v = model_output.float()
    x = sample.float()
    nl = _bcast(noise_level, x)
    sig = _bcast(sigma, x)
    sig_prev = _bcast(sigma_prev, x)
    dt = sig_prev - sig

    sig_guard = torch.where(sig == 1.0, torch.full_like(sig, sigma_at_one), sig)
    std_dev_t = torch.sqrt(sig / (1.0 - sig_guard)) * nl
    prev_sample_mean = x * (1.0 + std_dev_t**2 / (2.0 * sig) * dt) + v * (
        1.0 + std_dev_t**2 * (1.0 - sig) / (2.0 * sig)) * dt

    step_std = std_dev_t * torch.sqrt(-dt)
    if prev_sample is None:
        if noise is None:
            raise ValueError("flow_sde_step_with_logprob: provide either noise or prev_sample")
        prev_sample = prev_sample_mean + step_std * noise.float()
    else:
        prev_sample = prev_sample.float()

    delta = prev_sample.detach() - prev_sample_mean
    log_prob = (-(delta**2) / (2.0 * step_std**2) - torch.log(step_std)
                - math.log(math.sqrt(2.0 * math.pi)))
    log_prob = log_prob.mean(dim=tuple(range(1, x.ndim)))
    std_b = torch.broadcast_to(std_dev_t, (x.shape[0],) + (1,) * (x.ndim - 1))
    return SDEStepResult(prev_sample, log_prob, prev_sample_mean, std_b)


def wan_sde_step_with_logprob(model_output, sample, sigma, sigma_prev, *, sigma_min: float,
                              sigma_max: float, noise: Optional[torch.Tensor] = None,
                              prev_sample: Optional[torch.Tensor] = None,
                              deterministic: bool = False) -> SDEStepResult:
    """The WAN video Flow-SDE step over the UniPC flow-sigma schedule
    (adv_grpo_tpu/core/sde.py:171; reference
    wan_pipeline_with_logprob.py:10-84):

        dt      = sigma_prev - sigma
        std_t   = sigma_min + (sigma_max - sigma_min) * sigma
        mean    = x*(1 + std_t^2/(2 sigma) dt) + v*(1 + std_t^2 (1-sigma)/(2 sigma)) dt
        x_{t-1} = mean + std_t sqrt(-dt) * eps;  deterministic: x + dt * v
        logprob = the full Gaussian of step std std_t sqrt(-dt), meaned over
                  the non-batch dims

    ``sigma_max`` is the schedule's second sigma and ``sigma_min`` its last
    (0 under the appended terminal sigma); the last step has sigma_prev = 0
    and divides by sigma only. ``std_dev_t`` of the result is the step std
    std_t sqrt(-dt), as in the JAX package.
    """
    v = model_output.float()
    x = sample.float()
    sig = _bcast(sigma, x)
    sig_prev = _bcast(sigma_prev, x)
    dt = sig_prev - sig

    std_dev_t = sigma_min + (sigma_max - sigma_min) * sig
    prev_sample_mean = x * (1.0 + std_dev_t**2 / (2.0 * sig) * dt) + v * (
        1.0 + std_dev_t**2 * (1.0 - sig) / (2.0 * sig)) * dt

    step_std = std_dev_t * torch.sqrt(-dt)
    if prev_sample is None:
        if noise is None:
            raise ValueError("wan_sde_step_with_logprob: provide either noise or prev_sample")
        prev_sample = (x + dt * v if deterministic
                       else prev_sample_mean + step_std * noise.float())
    else:
        prev_sample = prev_sample.float()

    delta = prev_sample.detach() - prev_sample_mean
    log_prob = (-(delta**2) / (2.0 * step_std**2) - torch.log(step_std)
                - math.log(math.sqrt(2.0 * math.pi)))
    log_prob = log_prob.mean(dim=tuple(range(1, x.ndim)))
    std_b = torch.broadcast_to(step_std, (x.shape[0],) + (1,) * (x.ndim - 1))
    return SDEStepResult(prev_sample, log_prob, prev_sample_mean, std_b)
