"""UniPC multistep sampler, order 2, bh2, data prediction (counterpart of
``controllora_tpu/schedulers/unipc.py``; Zhao et al. 2023), with diffusers'
``UniPCMultistepScheduler`` conventions: linspace grid, predict_x0, lower_order_final.

Each step corrects the arrival at the current grid point (UniC, with the model
output just evaluated there) and predicts the next one (UniP, the DPM-Solver++ 2M
midpoint form). Every h-dependent coefficient (the expm1 terms, the 2x2
order-condition solve of the corrector weights) is precomputed in float64 into
per-step float32 tables; the JAX module's docstring derives them.
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
class UniPCState:
    sample: torch.Tensor        # predicted x at the current grid point
    last_sample: torch.Tensor   # x at the previous grid point (corrector input)
    m0: torch.Tensor            # x0_hat at the previous grid point
    m1: torch.Tensor            # x0_hat two grid points back


class UniPCMultistepScheduler(VPFrame):
    def __init__(self, schedule: DiffusionSchedule | None = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return linspace_timesteps(self.schedule.num_train_timesteps, num_inference_steps)

    def tables(self, num_inference_steps: int):
        """(ts, ratio, A, r1, rc1, rc2), each of length n; transition i goes from grid
        point i to i + 1 (t = 0 after the last):
          ratio[i] = sigma_{i+1} / sigma_i;  A[i] = alpha_{i+1} * expm1(-h_i);
          r1[i] = (lambda_{i-1} - lambda_i) / h_i (r1[0] unused);
          rc1, rc2: the corrector weights of (m1 - m0) / r1 and (m_t - m0); at i = 0
          the corrector is order 1 (rc1 0, rc2 1/2)."""
        acp = np.asarray(self.schedule.alphas_cumprod, np.float64)
        ts = self.timesteps(num_inference_steps)
        ts_ext = np.concatenate([ts, [0]])
        alpha = np.sqrt(acp[ts_ext])
        sigma = np.sqrt(1.0 - acp[ts_ext])
        lam = np.log(alpha) - np.log(sigma)

        n = num_inference_steps
        ratio = sigma[1:] / sigma[:-1]
        h = lam[1:] - lam[:-1]
        E = np.expm1(-h)
        A = alpha[1:] * E
        r1 = np.zeros(n)
        r1[1:] = (lam[:-2] - lam[1:-1]) / h[1:]
        b1 = (E / (-h) - 1.0) / E
        b2 = 2.0 * ((E / (-h) - 1.0) / (-h) - 0.5) / E
        rc1 = np.zeros(n)
        rc2 = np.full(n, 0.5)
        rc1[1:] = (b1[1:] - b2[1:]) / (1.0 - r1[1:])
        rc2[1:] = b1[1:] - rc1[1:]
        return (ts,) + tuple(x.astype(np.float32) for x in (ratio, A, r1, rc1, rc2))

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.num_inference_steps = num_inference_steps
        self._tables = self.tables(num_inference_steps)
        self.ts = self._tables[0]

    def init_state(self, sample: torch.Tensor) -> UniPCState:
        z = torch.zeros_like(sample)
        return UniPCState(sample=sample, last_sample=sample, m0=z, m1=z)

    def get_sample(self, state: UniPCState) -> torch.Tensor:
        return state.sample

    def model_input(self, state: UniPCState, i: int) -> torch.Tensor:
        return state.sample

    def step(self, state: UniPCState, model_output: torch.Tensor, i: int,
             first_index: int = 0) -> UniPCState:
        """One UniC + UniP update with the model output evaluated on ``state.sample``
        at grid index ``i``. ``first_index``: the first grid index of the trajectory
        (no corrector and an order-1 predictor there); the last step is order 1 too."""
        ts, ratio, A, r1, rc1, rc2 = self._tables
        m_t = self.schedule.pred_original_sample(state.sample, model_output, ts[i])
        if i == first_index:
            x_c = state.sample
        else:  # redo transition j = i - 1 -> i with m_t in the data set
            j = i - 1
            d1c = (state.m1 - state.m0) / float(r1[j] if r1[j] != 0 else 1.0)
            x_c = (float(ratio[j]) * state.last_sample - float(A[j]) * state.m0
                   - float(A[j]) * (float(rc1[j]) * d1c + float(rc2[j]) * (m_t - state.m0)))
        first = float(ratio[i]) * x_c - float(A[i]) * m_t
        if i in (first_index, self.num_inference_steps - 1):
            x_next = first
        else:  # the 2M midpoint with the previous x0_hat
            d1p = (state.m0 - m_t) / float(r1[i] if r1[i] != 0 else 1.0)
            x_next = first - float(A[i] * np.float32(0.5)) * d1p
        return UniPCState(sample=x_next, last_sample=x_c, m0=m_t, m1=state.m0)
