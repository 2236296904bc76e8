"""DPM-Solver++ (2M) multistep sampler (counterpart of
``controllora_tpu/schedulers/dpmsolver.py``).

algorithm dpmsolver++, solver_order 2, midpoint, lower_order_final. The per-step
coefficient tables stay host numpy (float32); the update is torch on the sample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import (
    DiffusionSchedule,
    VPFrame,
    linspace_timesteps,
)


@dataclasses.dataclass
class DPMSolverState:
    sample: torch.Tensor
    prev_x0: torch.Tensor  # previous converted model output (zeros before the first step)


class DPMSolverMultistepScheduler(VPFrame):
    def __init__(self, schedule: DiffusionSchedule | None = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return linspace_timesteps(self.schedule.num_train_timesteps, num_inference_steps)

    def tables(self, num_inference_steps: int):
        """(timesteps, alpha, sigma, lambda); the last three have length steps + 1,
        index i being grid point i and the final entry timestep 0."""
        acp = self.schedule.alphas_cumprod
        ts = self.timesteps(num_inference_steps)
        ts_ext = np.concatenate([ts, [0]])
        alpha = np.sqrt(acp[ts_ext])
        sigma = np.sqrt(np.float32(1.0) - acp[ts_ext])
        lam = np.log(alpha) - np.log(sigma)
        return ts, alpha.astype(np.float32), sigma.astype(np.float32), lam.astype(np.float32)

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.num_inference_steps = num_inference_steps
        self._tables = self.tables(num_inference_steps)
        self.ts = self._tables[0]

    def init_state(self, sample: torch.Tensor) -> DPMSolverState:
        return DPMSolverState(sample=sample, prev_x0=torch.zeros_like(sample))

    def get_sample(self, state: DPMSolverState) -> torch.Tensor:
        return state.sample

    def model_input(self, state: DPMSolverState, i: int) -> torch.Tensor:
        return state.sample

    def step(self, state: DPMSolverState, model_output: torch.Tensor, i: int,
             first_index: int = 0) -> DPMSolverState:
        """One multistep update at grid index ``i`` in [0, steps). Order 1 at
        ``first_index`` and, below 15 steps, at the last step (lower_order_final)."""
        ts, alpha, sigma, lam = self._tables
        n = self.num_inference_steps
        x0 = self.schedule.pred_original_sample(state.sample, model_output, ts[i])
        a_t, s_t, l_t = alpha[i + 1], sigma[i + 1], lam[i + 1]
        s_s, l_s = sigma[i], lam[i]
        h = l_t - l_s
        ratio = float(s_t / s_s)
        coef = float(a_t * (np.exp(-h) - np.float32(1.0)))
        if i == first_index or (n < 15 and i == n - 1):  # DPM-Solver++ 1S
            new = ratio * state.sample - coef * x0
        else:  # 2M midpoint with the previous x0
            r0 = float((l_s - lam[max(i - 1, 0)]) / h)
            d1 = (x0 - state.prev_x0) / r0
            new = ratio * state.sample - coef * x0 - 0.5 * coef * d1
        return DPMSolverState(sample=new, prev_x0=x0)
