"""DDIM sampler (counterpart of ``controllora_tpu/schedulers/ddim.py``): the
deterministic (eta 0) update over the 'leading' timestep grid. Coefficients are
float32 scalars from the host tables; the update is torch on the sample.
"""

from __future__ import annotations

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import (
    DiffusionSchedule,
    VPFrame,
    leading_timesteps,
)


def alpha_prod(schedule: DiffusionSchedule, t: int) -> np.float32:
    """alphas_cumprod[t], and 1 for t < 0 (the step past the last grid point)."""
    return schedule.alphas_cumprod[t] if t >= 0 else np.float32(1.0)


class DDIMScheduler(VPFrame):
    def __init__(self, schedule: DiffusionSchedule | None = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return leading_timesteps(self.schedule.num_train_timesteps, num_inference_steps,
                                 self.schedule.steps_offset)

    def set_timesteps(self, num_inference_steps: int) -> None:
        """The grid and each point's target; t < 0 after the last is the clean endpoint."""
        self.ts = self.timesteps(num_inference_steps)
        self.ts_prev = np.append(self.ts[1:], -1)

    def init_state(self, sample: torch.Tensor) -> torch.Tensor:
        return sample

    def get_sample(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def model_input(self, state: torch.Tensor, i: int) -> torch.Tensor:
        return state

    def set_sample(self, state: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step(self, state: torch.Tensor, model_output: torch.Tensor, i: int,
             first_index: int = 0) -> torch.Tensor:
        """x_t -> x_{t_prev} from grid point ``i``; a single-step update, so
        ``first_index`` is not needed."""
        s = self.schedule
        t, t_prev = int(self.ts[i]), int(self.ts_prev[i])
        acp_t, acp_prev = s.alphas_cumprod[t], alpha_prod(s, t_prev)
        x0 = s.pred_original_sample(state, model_output, t)
        eps = (state - float(np.sqrt(acp_t)) * x0) / float(np.sqrt(np.float32(1.0) - acp_t))
        dir_coef = np.sqrt(np.maximum(np.float32(1.0) - acp_prev, np.float32(0.0)))
        return float(np.sqrt(acp_prev)) * x0 + float(dir_coef) * eps
