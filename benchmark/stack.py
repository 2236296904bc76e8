"""The two sides of a cell, built from one configuration file and one seed: the system
under test (``controllora_tpu_torch``'s modules, imported here only) and the plain
reference (``reference/models.py``), with the same seeded weights (``weights.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from benchmark import weights
from benchmark.reference import models as ref
from benchmark.reference import numerics

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layouts(config: dict, device="meta") -> Dict[str, nn.Module]:
    """The reference's modules (uninitialised), whose parameter names and shapes are
    the weights' layout."""
    with torch.device(device):
        return {"unet": ref.UNet(config["unet"]), "vae": ref.VAE(config["vae"]),
                "text": ref.text_encoder(config["text"]),
                "control": ref.ControlLoRA(config["control"])}


def _frozen_weights(config: dict, seed: int, device):
    mods = layouts(config)
    frozen = weights.seeded({k: mods[k] for k in ("unet", "vae", "text")}, seed, device,
                            DTYPES[config["dtype"]])
    frozen["control"] = weights.control(mods["control"], seed, device,
                                        config["control"]["lora_rank"],
                                        config["control_offset"])
    return frozen


def reference(config: dict, seed: int, device, precision: str = "float32"
              ) -> Dict[str, nn.Module]:
    """The reference stack in float32 with the cell's weights, put in ``precision``
    (``reference/numerics.py``); frozen, no gradients."""
    state = _frozen_weights(config, seed, device)
    mods = layouts(config)
    out = {}
    for key, module in mods.items():
        module = module.to_empty(device=device).float()
        module.load_state_dict({k: v.float() for k, v in state.pop(key).items()}, strict=True)
        module.eval().requires_grad_(False)
        numerics.apply(module, precision)
        out[key] = module
    return out


def _config_dict(obj) -> object:
    if dataclasses.is_dataclass(obj):
        return json_like(dataclasses.asdict(obj))
    return [_config_dict(o) for o in obj]


def json_like(value):
    """Tuples as lists, as a JSON file holds them."""
    if isinstance(value, dict):
        return {k: json_like(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_like(v) for v in value]
    return value


def program(config: dict, seed: int, device):
    """(unet, vae, text_encoder, control_lora) of the system under test, its modules
    built uninitialised and filled with the cell's weights. Raises where the program's
    architecture of ``config["variant"]`` is not the configuration file's."""
    from controllora_tpu_torch.config import ControlLoRAConfig, get_preset
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.models.control_lora import config_for_unet

    dtype = DTYPES[config["dtype"]]
    unet, vae, text = zoo.build_models(config["variant"], dtype, device)
    ccfg = config_for_unet(get_preset(config["control_preset"]), unet.config)
    control = zoo.build_control_lora(ccfg, device)
    stated = {"unet": _config_dict(unet.config), "vae": _config_dict(vae.config),
              "text": _config_dict(text.config),
              "control": json_like({k: getattr(ccfg, k) for k in ControlLoRAConfig._JSON_FIELDS})}
    for key, value in stated.items():
        if value != config[key]:
            raise ValueError(f"the program's {config['variant']} {key} configuration is not "
                             f"the configuration file's:\n{value}\n!=\n{config[key]}")
    state = _frozen_weights(config, seed, device)
    for key, module in (("unet", unet), ("vae", vae), ("text", text), ("control", control)):
        module.load_state_dict(state.pop(key), strict=True)
    return unet, vae, text, control
