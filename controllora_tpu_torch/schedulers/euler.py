"""Euler discrete sampler (counterpart of ``controllora_tpu/schedulers/euler.py``):
the probability-flow ODE in the variance-exploding frame x = x0 + sigma * eps, with
diffusers' ``EulerDiscreteScheduler`` defaults (linspace timesteps, linearly
interpolated sigmas, epsilon or v prediction). The initial noise scales by sigma_max
(``init_state``) and the UNet sees the sample scaled by 1 / sqrt(sigma^2 + 1)
(``model_input``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import DiffusionSchedule


class EulerDiscreteScheduler:
    def __init__(self, schedule: DiffusionSchedule | None = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def tables(self, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps (n,), sigmas (n + 1,)), float32, descending; sigma(t) =
        sqrt((1 - acp) / acp) interpolated at the float timesteps, final entry 0."""
        T = self.schedule.num_train_timesteps
        acp = np.asarray(self.schedule.alphas_cumprod, np.float64)
        sig = np.sqrt((1.0 - acp) / acp)
        ts = np.linspace(0, T - 1, num_inference_steps, dtype=np.float64)[::-1].copy()
        sigmas = np.concatenate([np.interp(ts, np.arange(T, dtype=np.float64), sig), [0.0]])
        return ts.astype(np.float32), sigmas.astype(np.float32)

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.ts, self.sigmas = self.tables(num_inference_steps)

    def init_state(self, sample: torch.Tensor) -> torch.Tensor:
        """x_T = sigma_max * noise."""
        return sample * float(self.sigmas[0])

    def get_sample(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def model_input(self, state: torch.Tensor, i: int) -> torch.Tensor:
        """diffusers ``scale_model_input``: divide by sqrt(sigma_i^2 + 1)."""
        return state / float(np.sqrt(self.sigmas[i]**2 + np.float32(1.0)))

    # the partial-trajectory frame (JAX pipeline :286-294): variance-exploding, so an
    # init sits at x0 + sigma_i * noise, and prepared latents do not pass through
    # init_state (which scales pure noise by sigma_max)

    def noised_init(self, init: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """``init`` noised to grid point ``i``; sigmas[N] = 0, so i == N is clean."""
        return init + float(self.sigmas[i]) * noise

    def prepare_state(self, init: torch.Tensor, noise: torch.Tensor,
                      start_index: int) -> torch.Tensor:
        return self.noised_init(init, noise, start_index)

    def wrap_state(self, sample: torch.Tensor) -> torch.Tensor:
        """Continuation latents are already in the VE frame at their sigma."""
        return sample

    def set_sample(self, state: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step(self, state: torch.Tensor, model_output: torch.Tensor, i: int,
             first_index: int = 0) -> torch.Tensor:
        """x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * (x - x0_hat) / sigma_i; a
        single-step update, so ``first_index`` is not needed."""
        sample, sigmas = state, self.sigmas
        s = sigmas[i]
        one = np.float32(1.0)
        if self.schedule.prediction_type == "epsilon":
            deriv = model_output  # x0 = x - sigma * eps, so the derivative is eps
        elif self.schedule.prediction_type == "v_prediction":
            x0 = (sample / float(s**2 + one)
                  - model_output * float(s / np.sqrt(s**2 + one)))
            deriv = (sample - x0) / float(s)
        else:
            raise ValueError(
                f"euler: unsupported prediction_type {self.schedule.prediction_type!r}")
        return sample + float(sigmas[i + 1] - s) * deriv
