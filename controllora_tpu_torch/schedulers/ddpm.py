"""DDPM scheduler, training side (counterpart of ``controllora_tpu/schedulers/ddpm.py``):
the regression target of the ControlLoRA trainer. The noising step and the SNR live
on the ``DiffusionSchedule`` (``schedule.add_noise``, ``schedule.snr``). The ancestral
sampling ``step`` is not ported yet (no path of the port samples with DDPM).
"""

from __future__ import annotations

from typing import Optional

import torch

from controllora_tpu_torch.schedulers.common import DiffusionSchedule


class DDPMScheduler:
    def __init__(self, schedule: Optional[DiffusionSchedule] = None):
        self.schedule = schedule or DiffusionSchedule.create()

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """The regression target under the schedule's prediction type."""
        p = self.schedule.prediction_type
        if p == "epsilon":
            return noise.float()
        if p == "v_prediction":
            return self.schedule.get_velocity(x0, noise, t)
        raise ValueError(f"unsupported prediction type {p!r}")
