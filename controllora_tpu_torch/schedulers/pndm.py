"""PNDM (pseudo linear multistep) sampler (counterpart of
``controllora_tpu/schedulers/pndm.py``): the skip_prk_steps configuration SD uses,
linear multistep with the order ramping 1 -> 4 as the history of model outputs
fills.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import (
    DiffusionSchedule,
    VPFrame,
    leading_timesteps,
)
from controllora_tpu_torch.schedulers.ddim import alpha_prod


@dataclasses.dataclass
class PNDMState:
    sample: torch.Tensor
    ets: List[torch.Tensor]  # recent model outputs, newest first, at most 4


class PNDMScheduler(VPFrame):
    def __init__(self, schedule: DiffusionSchedule | None = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return leading_timesteps(self.schedule.num_train_timesteps, num_inference_steps,
                                 self.schedule.steps_offset)

    def set_timesteps(self, num_inference_steps: int) -> None:
        """The grid and each point's target; the last step goes on one grid stride,
        clamped at -1 (the clean endpoint), as the JAX pipeline."""
        ts = self.ts = self.timesteps(num_inference_steps)
        last = max(int(ts[-1] - (ts[0] - ts[1])), -1) if len(ts) > 1 else -1
        self.ts_prev = np.append(ts[1:], last)

    def init_state(self, sample: torch.Tensor) -> PNDMState:
        return PNDMState(sample=sample, ets=[])

    def get_sample(self, state: PNDMState) -> torch.Tensor:
        return state.sample

    def model_input(self, state: PNDMState, i: int) -> torch.Tensor:
        return state.sample

    def _prev_sample(self, sample, t: int, t_prev: int, eps):
        """The PNDM transfer formula (Liu et al. 2022, eq. 11), coefficients in fp32."""
        acp_t, acp_prev = self.schedule.alphas_cumprod[t], alpha_prod(self.schedule, t_prev)
        one = np.float32(1.0)
        sample_coeff = np.sqrt(acp_prev / acp_t)
        denom = acp_t * np.sqrt(one - acp_prev) + np.sqrt(acp_prev * acp_t * (one - acp_t))
        eps_coeff = (acp_prev - acp_t) / denom
        return float(sample_coeff) * sample - float(eps_coeff) * eps

    def step(self, state: PNDMState, model_output: torch.Tensor, i: int,
             first_index: int = 0) -> PNDMState:
        """The order follows the history in ``state`` (empty after ``init_state`` or
        ``wrap_state``), so ``first_index`` is not needed."""
        e = [model_output] + state.ets[:3]
        if len(e) == 1:
            eps = e[0]
        elif len(e) == 2:
            eps = (3 * e[0] - e[1]) / 2
        elif len(e) == 3:
            eps = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
        else:
            eps = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24
        sample = self._prev_sample(state.sample, int(self.ts[i]), int(self.ts_prev[i]), eps)
        return PNDMState(sample=sample, ets=e)
