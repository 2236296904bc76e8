"""Seeded weights, made by the benchmark and handed to both sides by parameter name.

Every parameter of rank >= 2 is N(0, 1/fan_in) (fan_in = prod(shape[1:])), a 1-D
weight is 1 and a bias 0, as ``zoo.random_init_`` sets them. The ControlLoRA's hint
encoder is drawn the same way, its LoRA ``down`` factors N(0, 1/rank) and ``up``
factors 0, and then every ControlLoRA parameter moves by +0.01 (``offset``), so that
the adapters act. The draws are made on ``device`` from one ``torch.Generator`` in a
few large calls (at most 2**30 values each) in the dtype the weights are served in;
the same seed gives the same weights on either side.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

CHUNK = 1 << 30
CONTROL_STREAM = 0x5EED  # the ControlLoRA's generator: seed XOR this


def _targets(modules: Dict[str, nn.Module]) -> List[Tuple[str, str, torch.Size]]:
    """(module key, parameter name, shape) of every parameter, in order."""
    return [(key, name, p.shape) for key, module in modules.items()
            for name, p in module.named_parameters()]


def _draw(shapes: Iterable[torch.Size], gen: torch.Generator, device, dtype) -> List[torch.Tensor]:
    """One standard normal tensor a shape, drawn in chunks of at most CHUNK values."""
    shapes = list(shapes)
    out, start = [], 0
    while start < len(shapes):
        stop, total = start, 0
        while stop < len(shapes) and (stop == start or total + shapes[stop].numel() <= CHUNK):
            total += shapes[stop].numel()
            stop += 1
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        offset = 0
        for shape in shapes[start:stop]:
            out.append(flat[offset:offset + shape.numel()].view(shape))
            offset += shape.numel()
        start = stop
    return out


@torch.no_grad()
def seeded(modules: Dict[str, nn.Module], seed: int, device, dtype,
           lora_rank: int = 0, offset: float = 0.0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module key: {parameter name: tensor}} for the parameter layout of ``modules``
    (modules on the meta device will do). ``lora_rank`` > 0 draws LoRA factors
    (names ending ``down.weight`` / ``up.weight``) as a fresh LoRA starts."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    targets = _targets(modules)
    drawn_at = [i for i, (_, _, shape) in enumerate(targets) if len(shape) >= 2]
    draws = dict(zip(drawn_at, _draw((targets[i][2] for i in drawn_at), gen, device, dtype)))
    out: Dict[str, Dict[str, torch.Tensor]] = {key: {} for key in modules}
    for i, (key, name, shape) in enumerate(targets):
        if i in draws:
            fan_in = shape[1:].numel()
            std = fan_in ** -0.5
            if lora_rank and name.endswith("down.weight"):
                std = 1.0 / lora_rank
            t = draws[i].mul_(std)
            if lora_rank and name.endswith("up.weight"):
                t.zero_()
        elif name.endswith("bias"):
            t = torch.zeros(shape, device=device, dtype=dtype)
        else:
            t = torch.ones(shape, device=device, dtype=dtype)
        if offset:
            t.add_(offset)
        out[key][name] = t
    return out


def control(module: nn.Module, seed: int, device, rank: int, offset: float
            ) -> Dict[str, torch.Tensor]:
    """The ControlLoRA's fp32 weights."""
    return seeded({"control": module}, int(seed) ^ CONTROL_STREAM, device, torch.float32,
                  lora_rank=rank, offset=offset)["control"]
