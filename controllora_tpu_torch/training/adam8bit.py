"""Block-wise 8-bit AdamW moments (counterpart of ``controllora_tpu/training/adam8bit.py``,
the capability the reference takes from ``bitsandbytes.optim.AdamW8bit``).

The same scheme as the JAX package, in plain torch ops (it has no Pallas kernel):

  * both Adam moments are stored as int8 with a per-block fp32 absmax scale, blocks
    of 256 flattened elements (the last one zero padded);
  * power-law codes, not a linear map: m as sign(m) * round(127 * sqrt(|m| / absmax)),
    v as round(127 * (v / absmax)^(1/4)), so small entries of a block keep a code;
  * parameters with fewer than ``min_quantize_size`` (4096) elements keep fp32
    moments.

``AdamW8bit`` is a ``torch.optim.Optimizer`` with the update of the JAX chain
``scale_by_adam8bit -> add_decayed_weights -> scale_by_learning_rate``:
u = m_hat / (sqrt(v_hat) + eps) + weight_decay * p, then p -= lr * u. The trainer's
``AdapterOptimizer`` puts the global-norm clip and the lr schedule around it, as
``make_optimizer`` chains them in JAX. Its state is tensors only (int8 codes, fp32
scales or fp32 moments, and the step), so ``state_dict`` goes through ``torch.save``.

Quantizing flattens a parameter in its own layout: a torch conv weight (O, I, kh, kw)
forms other blocks than the flax kernel (kh, kw, I, O), so the codes equal the JAX
package's only for parameters laid out alike.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256
M_POWER, V_POWER = 0.5, 0.25


def quantize(x: torch.Tensor, power: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (codes (n_blocks, 256) int8, scales (n_blocks, 1) fp32)."""
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    unit = blocks.abs() / scale.clamp(min=1e-30)
    codes = torch.sign(blocks) * torch.round(127.0 * unit**power)
    return codes.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, shape, power: float) -> torch.Tensor:
    q = codes.float()
    blocks = torch.sign(q) * (q.abs() / 127.0) ** (1.0 / power) * scale
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW whose moments of every parameter with at least ``min_quantize_size``
    elements are stored in 8 bits (state ``exp_avg_q``/``exp_avg_scale`` and
    ``exp_avg_sq_q``/``exp_avg_sq_scale``); smaller ones keep fp32 ``exp_avg`` and
    ``exp_avg_sq``. Every parameter with a gradient takes a step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, min_quantize_size: int = 4096):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      min_quantize_size=min_quantize_size))

    @staticmethod
    def _init_state(state, p, quantized: bool) -> None:
        state["step"] = torch.zeros((), dtype=torch.float32)
        zeros = torch.zeros_like(p, dtype=torch.float32)
        if quantized:
            state["exp_avg_q"], state["exp_avg_scale"] = quantize(zeros, M_POWER)
            state["exp_avg_sq_q"], state["exp_avg_sq_scale"] = quantize(zeros, V_POWER)
        else:
            state["exp_avg"], state["exp_avg_sq"] = zeros, zeros.clone()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                quantized = p.numel() >= group["min_quantize_size"]
                if not state:
                    self._init_state(state, p, quantized)
                state["step"] += 1
                # the bias corrections in fp32, as the JAX update computes them
                c = np.float32(state["step"].item())
                bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
                bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
                g = p.grad.float()
                if quantized:
                    m = dequantize(state["exp_avg_q"], state["exp_avg_scale"], p.shape, M_POWER)
                    v = dequantize(state["exp_avg_sq_q"], state["exp_avg_sq_scale"], p.shape,
                                   V_POWER)
                else:
                    m, v = state["exp_avg"], state["exp_avg_sq"]
                m = b1 * m + (1.0 - b1) * g
                v = b2 * v + (1.0 - b2) * g * g
                u = (m / bc1) / (torch.sqrt(v / bc2) + group["eps"])
                if quantized:
                    state["exp_avg_q"], state["exp_avg_scale"] = quantize(m, M_POWER)
                    state["exp_avg_sq_q"], state["exp_avg_sq_scale"] = quantize(v, V_POWER)
                else:
                    state["exp_avg"], state["exp_avg_sq"] = m, v
                u = u + group["weight_decay"] * p
                p.add_((-group["lr"]) * u)
        return None
