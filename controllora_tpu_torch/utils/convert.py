"""Load JAX parameter trees (as numpy) into the port's modules.

The frozen stack goes through the JAX package's numpy-only exporters
(``controllora_tpu/utils/torch_compat.py``: ``flax_to_torch_unet``, ``_vae``,
``_clip``), the ControlLoRA through ``control_lora_to_torch``; both write diffusers /
reference state-dict keys, which are the port's parameter names. Every load is
``strict=True``, so a key gap fails loudly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from controllora_tpu.utils.torch_compat import (
    control_lora_to_torch,
    flax_to_torch_clip,
    flax_to_torch_unet,
    flax_to_torch_vae,
)


def load_numpy_state_dict(module: nn.Module, sd: Dict[str, Any]) -> nn.Module:
    """Copy numpy arrays into ``module`` (strict), converting to its dtypes."""
    tensors = {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
               for k, v in sd.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def load_unet(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, flax_to_torch_unet(params))


def load_vae(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, flax_to_torch_vae(params))


def load_clip(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, flax_to_torch_clip(params))


def load_control_lora(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, control_lora_to_torch(params, module.config))
