"""Flow-CPS sampling step with its Gaussian log-probability.

Port of adv_grpo_tpu/core/sde.py:54 ``cps_step_with_logprob`` (reference
``sde_step_with_logprob_new``). All math runs in a float32 island whatever the
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
    """Scalar / (B,) coefficient -> fp32 tensor broadcasting over (B, ...)."""
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
