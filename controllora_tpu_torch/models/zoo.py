"""Model zoo: the SD1.5 stack or its reduced smoke variant, with seeded random weights
(counterpart of ``controllora_tpu/models/zoo.py``).

There are no pretrained weights in the repository, so full-width runs use random
weights made from an explicit ``torch.Generator``: every floating parameter of rank
>= 2 is N(0, 1/fan_in) with fan_in = prod(shape[1:]), 1-D norm weights are 1 and
biases 0. Modules are built on the meta device and materialised on ``device``, so
no default initialisation runs first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from controllora_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from controllora_tpu_torch.models.control_lora import ControlLoRA, LoRALinear
from controllora_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from controllora_tpu_torch.models.vae import AutoencoderKL, VAEConfig

# Reduced architecture for hermetic smoke runs (the JAX package's SMOKE_* configs).
SMOKE_UNET = UNetConfig(block_out_channels=(32, 64, 96, 96), layers_per_block=1,
                        attention_head_dim=4)
SMOKE_VAE = VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                      norm_num_groups=8)
SMOKE_CLIP = CLIPTextConfig(vocab_size=49408, hidden_size=768, num_layers=2, num_heads=8,
                            intermediate_size=1536)

VARIANTS = {
    "sd15": (UNetConfig(), VAEConfig(), CLIPTextConfig()),
    "smoke": (SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP),
}


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded in-place init (see module docstring); draws follow parameter order."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in**-0.5, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module


def materialize(cls, config, device, generator: Optional[torch.Generator],
                dtype: torch.dtype) -> nn.Module:
    """Build ``cls(config)`` on ``device`` without default init; seed it from
    ``generator`` (fp32 draws, then cast to ``dtype``) or leave it uninitialised for
    a state-dict load when ``generator`` is None."""
    with torch.device("meta"):
        module = cls(config)
    module = module.to_empty(device=device)
    if generator is not None:
        random_init_(module, generator)
    return module.to(dtype).eval().requires_grad_(False)


def build_models(variant: str = "sd15", dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None
                 ) -> Tuple[UNet2DConditionModel, AutoencoderKL, CLIPTextModel]:
    """(unet, vae, text_encoder) on ``device`` in ``dtype``. With a generator the
    weights are random and seeded (the generator must live on ``device``); without
    one they are uninitialised, for ``utils/convert.py`` to fill."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown model variant {variant!r}; known: {sorted(VARIANTS)}")
    ucfg, vcfg, ccfg = VARIANTS[variant]
    device = torch.device(device)
    return (materialize(UNet2DConditionModel, ucfg, device, generator, dtype),
            materialize(AutoencoderKL, vcfg, device, generator, dtype),
            materialize(CLIPTextModel, ccfg, device, generator, dtype))


@torch.no_grad()
def build_control_lora(config, device="cuda", generator: Optional[torch.Generator] = None,
                       dtype: torch.dtype = torch.float32) -> ControlLoRA:
    """A ControlLoRA on ``device``. With a generator: the hint encoder is seeded as
    above and every LoRA pair starts as diffusers' LoRALinearLayer does (down
    N(0, 1/rank^2), up 0), so a fresh adapter is an exact no-op."""
    model = materialize(ControlLoRA, config, torch.device(device), generator, dtype)
    if generator is not None:
        for m in model.modules():
            if isinstance(m, LoRALinear):
                rank = m.down.out_features
                m.down.weight.normal_(0.0, 1.0 / rank, generator=generator)
                m.up.weight.zero_()
    return model
