"""The final ControlLoRA artifact (counterpart of the JAX ``save_control_lora`` /
``load_control_lora`` in ``controllora_tpu/training/checkpoint.py``):
``config.json`` plus ``diffusion_pytorch_model.bin``, a ``torch.save`` of the
reference-named fp32 state dict, which the JAX package's ``load_control_lora`` and
the reference's ``ControlLoRA.from_pretrained`` read as they are. The resumable
train-state checkpoint (orbax in the JAX package) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from controllora_tpu.config import ControlLoRAConfig
from controllora_tpu_torch.models.control_lora import ControlLoRA

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "diffusion_pytorch_model.bin"


def save_control_lora(output_dir: str, control_lora: ControlLoRA) -> str:
    os.makedirs(output_dir, exist_ok=True)
    control_lora.config.save_json(os.path.join(output_dir, CONFIG_NAME))
    sd = {k: v.detach().float().cpu().contiguous() for k, v in control_lora.state_dict().items()}
    torch.save(sd, os.path.join(output_dir, WEIGHTS_NAME))
    return output_dir


def load_control_lora(path: str, device="cpu") -> Tuple[ControlLoRA, ControlLoRAConfig]:
    """A saved artifact directory -> (ControlLoRA on ``device``, fp32; its config).
    The load is strict: a missing or extra key fails."""
    from controllora_tpu_torch.models import zoo

    cfg = ControlLoRAConfig.from_json(os.path.join(path, CONFIG_NAME))
    model = zoo.build_control_lora(cfg, device)
    sd = torch.load(os.path.join(path, WEIGHTS_NAME), map_location=device, weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model, cfg
