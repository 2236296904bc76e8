"""The SD noise schedule (scaled-linear betas 0.00085-0.012 over 1000 steps,
epsilon prediction), DDPM noising and the DPM-Solver++ 2M sampler (midpoint, order 1
at the first step and, under 15 steps, at the last), as diffusers defines them."""

from __future__ import annotations

import numpy as np
import torch

TRAIN_STEPS = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, TRAIN_STEPS, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    acp = torch.as_tensor(alphas_cumprod(), device=x0.device)[t.long()].reshape(-1, 1, 1, 1)
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def dpm_grid(steps: int):
    """(timesteps, alpha, sigma, lambda) of the grid; the last three carry one more
    entry, timestep 0."""
    acp = alphas_cumprod()
    ts = np.linspace(0, TRAIN_STEPS - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
    ext = np.concatenate([ts, [0]])
    alpha = np.sqrt(acp[ext].astype(np.float64))
    sigma = np.sqrt(1.0 - acp[ext].astype(np.float64))
    return ts, alpha, sigma, np.log(alpha) - np.log(sigma)


def dpm_solve(x: torch.Tensor, steps: int, eps_fn) -> torch.Tensor:
    """Runs the sampler from x (at grid point 0); eps_fn(x, t) is the guided noise."""
    ts, alpha, sigma, lam = dpm_grid(steps)
    prev = None
    for i in range(steps):
        eps = eps_fn(x, int(ts[i]))
        x0 = (x - sigma[i] * eps) / alpha[i]
        h = lam[i + 1] - lam[i]
        ratio = sigma[i + 1] / sigma[i]
        coef = alpha[i + 1] * (np.exp(-h) - 1.0)
        if i == 0 or (steps < 15 and i == steps - 1):
            x = ratio * x - coef * x0
        else:
            r0 = (lam[i] - lam[i - 1]) / h
            x = ratio * x - coef * x0 - 0.5 * coef * (x0 - prev) / r0
        prev = x0
    return x
