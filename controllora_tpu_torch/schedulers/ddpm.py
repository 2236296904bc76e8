"""DDPM scheduler (counterpart of ``controllora_tpu/schedulers/ddpm.py``): the
regression target of the trainers and the ancestral sampling ``step``. The noising
step and the SNR live on the ``DiffusionSchedule`` (``schedule.add_noise``,
``schedule.snr``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from controllora_tpu_torch.schedulers.common import DiffusionSchedule


class DDPMScheduler:
    def __init__(self, schedule: Optional[DiffusionSchedule] = None,
                 clip_sample: bool = False):
        self.schedule = schedule or DiffusionSchedule.create()
        self.clip_sample = clip_sample

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """The regression target under the schedule's prediction type."""
        p = self.schedule.prediction_type
        if p == "epsilon":
            return noise.float()
        if p == "v_prediction":
            return self.schedule.get_velocity(x0, noise, t)
        raise ValueError(f"unsupported prediction type {p!r}")

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ancestral reverse step x_t -> x_{t-1} at the integer timestep ``t``.
        The posterior noise is ``noise`` when given, else drawn from ``generator``;
        none is added at t = 0."""
        s = self.schedule
        f32 = np.float32
        acp_t = f32(s.alphas_cumprod[t])
        acp_prev = f32(s.alphas_cumprod[t - 1]) if t > 0 else f32(1.0)
        beta_t = f32(1.0) - acp_t / acp_prev

        x0 = s.pred_original_sample(sample, model_output, t)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        coef_x0 = np.sqrt(acp_prev) * beta_t / (f32(1.0) - acp_t)
        coef_xt = np.sqrt(acp_t / acp_prev) * (f32(1.0) - acp_prev) / (f32(1.0) - acp_t)
        mean = float(coef_x0) * x0 + float(coef_xt) * sample
        if t == 0:
            return mean
        var = max(beta_t * (f32(1.0) - acp_prev) / (f32(1.0) - acp_t), f32(1e-20))
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, dtype=sample.dtype,
                                device=sample.device)
        return mean + float(np.sqrt(var)) * noise
