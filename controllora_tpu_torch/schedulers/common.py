"""Shared diffusion noise-schedule tables (counterpart of
``controllora_tpu/schedulers/common.py``).

The tables are host numpy (float32, like the JAX package's); only the per-sample
math takes tensors. SD1.5 schedule: scaled_linear betas in [0.00085, 0.012], 1000
train steps, epsilon prediction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep coefficient tables (float32, length num_train_timesteps)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    steps_offset: int = 1

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
               prediction_type: str = "epsilon",
               steps_offset: int = 1) -> "DiffusionSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                                dtype=np.float64) ** 2
        elif beta_schedule == "squaredcos_cap_v2":
            t = np.arange(num_train_timesteps, dtype=np.float64)

            def f(u):
                return np.cos((u / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.clip(1.0 - f(t + 1) / f(t), 0, 0.999)
        else:
            raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
        return cls(
            betas=betas.astype(np.float32),
            alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            steps_offset=steps_offset,
        )

    # ------------------------------------------------------------------ training math

    def _gather(self, table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-sample coefficients table[t] (fp32), broadcastable to an ndim tensor."""
        v = torch.as_tensor(table, device=t.device)[t.long()]
        return v.reshape(v.shape + (1,) * (ndim - v.dim()))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) sample in fp32: the trainer's noising step."""
        acp = self._gather(self.alphas_cumprod, t, x0.dim())
        return torch.sqrt(acp) * x0.float() + torch.sqrt(1.0 - acp) * noise.float()

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v-prediction target (diffusers convention), fp32."""
        acp = self._gather(self.alphas_cumprod, t, x0.dim())
        return torch.sqrt(acp) * noise.float() - torch.sqrt(1.0 - acp) * x0.float()

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio acp / (1 - acp) per sample, (B,) fp32 (the min-SNR
        loss weight reads it)."""
        acp = self._gather(self.alphas_cumprod, t, 1)
        return acp / (1.0 - acp)

    def pred_original_sample(self, sample: torch.Tensor, model_output: torch.Tensor,
                             t: int) -> torch.Tensor:
        """x0 estimate from a model output at integer timestep t."""
        acp = self.alphas_cumprod[int(t)]
        alpha_t = float(np.sqrt(acp))
        sigma_t = float(np.sqrt(np.float32(1.0) - acp))
        if self.prediction_type == "epsilon":
            return (sample - sigma_t * model_output) / alpha_t
        if self.prediction_type == "v_prediction":
            return alpha_t * sample - sigma_t * model_output
        if self.prediction_type == "sample":
            return model_output
        raise ValueError(f"unknown prediction_type {self.prediction_type!r}")


def linspace_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """DPM-Solver grid: linspace over [0, T-1], 0 endpoint dropped, descending
    (diffusers DPMSolverMultistepScheduler.set_timesteps)."""
    ts = (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
          .round()[::-1][:-1].astype(np.int32))
    return ts.copy()


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 1) -> np.ndarray:
    """DDIM/PNDM 'leading' grid with steps_offset, descending (diffusers
    DDIMScheduler)."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int32)
    return ts + steps_offset


class VPFrame:
    """The partial-trajectory frame of a variance-preserving sampler (DPM-Solver++,
    DDIM, PNDM, UniPC; JAX pipeline :295-308): where an init image sits at grid point
    ``i`` of the grid set by ``set_timesteps``, for img2img, inpaint and the ensemble
    split. Euler's variance-exploding frame is its own."""

    def noised_init(self, init: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """``init`` noised to grid point ``i`` (q(x_t | x_0) at ``ts[i]``); i == N is
        the clean end of the grid."""
        if i >= len(self.ts):
            return init
        return self.schedule.add_noise(init, noise, torch.tensor(int(self.ts[i]),
                                                                  device=init.device))

    def prepare_state(self, init: torch.Tensor, noise: torch.Tensor, start_index: int):
        """The state of an img2img trajectory starting at grid point ``start_index``."""
        return self.init_state(self.noised_init(init, noise, start_index))

    def wrap_state(self, sample: torch.Tensor):
        """Continuation latents, already at their grid point, with a fresh (empty)
        history: no re-noising."""
        return self.init_state(sample)

    def set_sample(self, state, sample: torch.Tensor):
        """``state`` with its sample overwritten (inpaint's re-injection)."""
        return dataclasses.replace(state, sample=sample)
