"""Flow-match Euler discrete schedule (sigma / timestep tables).

The port's own copy of adv_grpo_tpu/core/scheduler.py (numpy, no framework).
It reproduces the schedule diffusers' ``FlowMatchEulerDiscreteScheduler``
gives ``retrieve_timesteps(scheduler, n)`` with ``sigmas=None``:

  * base sigmas ``linspace(1, N, N)[::-1] / N`` with the static shift
    ``s*sigma / (1 + (s-1)*sigma)``; sigma_max = 1, sigma_min = shifted 1/N;
  * ``set_timesteps(n)``: a t-grid ``linspace(sigma_max*N, sigma_min*N, n) / N``,
    shifted AGAIN (diffusers' double shift, which the reference inherits and
    the log-probabilities depend on), ``timesteps = sigmas * N``, and a
    terminal 0.0 sigma appended.

(The JAX package's single-shift variant, an experiment no sampler runs, is
not copied.)

``tests/test_torch_copies.py`` holds it equal to the JAX package's tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _static_shift(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Static tables of an n-step flow-match Euler sampler.

    sigmas: (n+1,) float32, descending, terminal 0.0 appended; timesteps:
    (n,) float32, ``sigmas[:-1] * num_train_timesteps`` (what the
    transformer's timestep embedding is fed)."""

    sigmas: np.ndarray
    timesteps: np.ndarray
    num_train_timesteps: int
    shift: float

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def flow_match_schedule(num_inference_steps: int, shift: float = 3.0,
                        num_train_timesteps: int = 1000) -> FlowMatchSchedule:
    """The n-step schedule, bit-compatible with diffusers' default path."""
    n = int(num_inference_steps)
    if n < 1:
        raise ValueError(f"num_inference_steps must be >= 1, got {n}")
    ntt = float(num_train_timesteps)
    sigma_min = _static_shift(np.array([1.0 / ntt]), shift)[0]
    sigma_max = 1.0  # shift(1.0) == 1.0
    t_grid = np.linspace(sigma_max * ntt, sigma_min * ntt, n, dtype=np.float64)
    sigmas = _static_shift(t_grid / ntt, shift)
    timesteps = (sigmas * ntt).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps,
                             num_train_timesteps=num_train_timesteps, shift=shift)
