"""DPM-Solver++ (2M) multistep sampler (counterpart of
``controllora_tpu/schedulers/dpmsolver.py``).

algorithm dpmsolver++, solver_order 2, midpoint, lower_order_final. The per-step
coefficient tables stay host numpy (float32); the update is torch on the sample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import DiffusionSchedule, linspace_timesteps


@dataclasses.dataclass
class DPMSolverState:
    sample: torch.Tensor
    prev_x0: torch.Tensor  # previous converted model output (zeros before the first step)


class DPMSolverMultistepScheduler:
    def __init__(self, schedule: DiffusionSchedule | None = None, solver_order: int = 2,
                 lower_order_final: bool = True):
        if solver_order not in (1, 2):
            raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
        self.schedule = schedule or DiffusionSchedule.create()
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final

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

    def init_state(self, sample: torch.Tensor) -> DPMSolverState:
        return DPMSolverState(sample=sample, prev_x0=torch.zeros_like(sample))

    def step(self, state: DPMSolverState, model_output: torch.Tensor, i: int,
             num_inference_steps: int, tables=None, first_index: int = 0) -> DPMSolverState:
        """One multistep update at grid index ``i`` in [0, steps)."""
        ts, alpha, sigma, lam = tables if tables is not None else self.tables(
            num_inference_steps)
        x0 = self.schedule.pred_original_sample(state.sample, model_output, ts[i])
        a_t, s_t, l_t = alpha[i + 1], sigma[i + 1], lam[i + 1]
        s_s, l_s = sigma[i], lam[i]
        h = l_t - l_s
        ratio = float(s_t / s_s)
        coef = float(a_t * (np.exp(-h) - np.float32(1.0)))
        use_first = self.solver_order == 1 or i == first_index or (
            self.lower_order_final and num_inference_steps < 15
            and i == num_inference_steps - 1)
        if use_first:  # DPM-Solver++ 1S
            new = ratio * state.sample - coef * x0
        else:  # 2M midpoint with the previous x0
            r0 = float((l_s - lam[max(i - 1, 0)]) / h)
            d1 = (x0 - state.prev_x0) / r0
            new = ratio * state.sample - coef * x0 - 0.5 * coef * d1
        return DPMSolverState(sample=new, prev_x0=x0)
