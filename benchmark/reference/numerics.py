"""The precision a reference computes in. ``float32`` is the reference itself (TF32
off). ``fp8`` is its control: every weight of a linear or convolution, and the
activation entering it, rounded to float8 e4m3 with a per-tensor scale (amax / 448),
products accumulated in float32, the rest in float32: the step below the
configurations' bfloat16."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()  # rounded forward, straight-through gradient


def apply(model: nn.Module, precision: str) -> list:
    """Puts ``model`` in ``precision``; returns hook handles (empty for float32)."""
    if precision == "float32":
        return []
    if precision != "fp8":
        raise ValueError(f"unknown reference precision {precision!r}")
    handles = []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(fp8_round(m.weight))
                handles.append(m.register_forward_pre_hook(
                    lambda _m, args: (fp8_round(args[0]),) + tuple(args[1:])))
    return handles


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
