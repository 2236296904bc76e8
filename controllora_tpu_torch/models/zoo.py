"""Model zoo: the SD1.5, SD2.1, SDXL and SDXL-refiner stacks and their reduced smoke
variants, with seeded random weights (counterpart of ``controllora_tpu/models/zoo.py``;
the configurations are the JAX package's, field for field).

There are no pretrained weights in the repository, so full-width runs use random
weights made from an explicit ``torch.Generator``: every floating parameter of rank
>= 2 is N(0, 1/fan_in) with fan_in = prod(shape[1:]), 1-D norm weights are 1 and
biases 0. Modules are built on the meta device and materialised on ``device``, so
no default initialisation runs first.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from controllora_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    DualCLIPTextEncoder,
)
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

# SD2.1 (stabilityai/stable-diffusion-2-1 {unet,text_encoder}/config.json): dim_head
# 64 at every level, Linear transformer projections, the OpenCLIP ViT-H tower (as
# shipped, already cut to its penultimate layer) with gelu MLPs. v-prediction is a
# scheduler setting, not an architecture field.
SD21_UNET = UNetConfig(sample_size=96, cross_attention_dim=1024,
                       attention_head_dim=(5, 10, 20, 20), use_linear_projection=True)
SD21_CLIP = CLIPTextConfig(vocab_size=49408, hidden_size=1024, num_layers=23, num_heads=16,
                           intermediate_size=4096, hidden_act="gelu")

# SD2-shaped smoke variant: per-level heads (dim_head 16), linear projections, gelu
SMOKE2_UNET = UNetConfig(block_out_channels=(32, 64, 96, 96), layers_per_block=1,
                         attention_head_dim=(2, 4, 6, 6), use_linear_projection=True,
                         cross_attention_dim=96)
SMOKE2_CLIP = CLIPTextConfig(vocab_size=49408, hidden_size=96, num_layers=2, num_heads=4,
                             intermediate_size=192, hidden_act="gelu")

# SDXL base (stabilityai/stable-diffusion-xl-base-1.0 {unet,text_encoder,
# text_encoder_2,vae}/config.json): 3 levels, attention-free level 0, transformer
# depth (1, 2, 10), dim_head 64, dual towers (768 + 1280 -> 2048-d context, both
# penultimate) and text_time (pooled 1280 + 6 x 256 size ids -> 2816).
SDXL_UNET = UNetConfig(
    sample_size=128,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280),
    transformer_layers_per_block=(1, 2, 10),
    attention_head_dim=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)
SDXL_CLIP1 = CLIPTextConfig(penultimate=True)  # ViT-L tower, context only
SDXL_CLIP2 = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                            intermediate_size=5120, hidden_act="gelu", penultimate=True,
                            projection_dim=1280)
SDXL_VAE = VAEConfig(scaling_factor=0.13025)

# SDXL-shaped smoke variant: attention-free level 0, depth (1, 1, 2), dual 32-d
# towers (context 64), text_time with 8-d size embeddings
SMOKEXL_UNET = UNetConfig(
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(32, 64, 96),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1, 2),
    attention_head_dim=(2, 4, 6),
    cross_attention_dim=64,
    use_linear_projection=True,
    norm_num_groups=16,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8,
)
SMOKEXL_CLIP1 = CLIPTextConfig(vocab_size=49408, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64, penultimate=True)
SMOKEXL_CLIP2 = CLIPTextConfig(vocab_size=49408, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64, hidden_act="gelu",
                               penultimate=True, projection_dim=32)

# SDXL refiner (stabilityai/stable-diffusion-xl-refiner-1.0 unet/config.json): 4
# levels with attention in the middle two only, depth 4, dim_head 64, the ViT-bigG
# tower alone (1280-d context) and 5 ids (orig_h, orig_w, crop_top, crop_left,
# aesthetic score): 1280 + 5 x 256 = 2560.
SDXL_REFINER_UNET = UNetConfig(
    sample_size=128,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(384, 768, 1536, 1536),
    transformer_layers_per_block=4,
    attention_head_dim=(6, 12, 24, 24),
    cross_attention_dim=1280,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2560,
)

# refiner-shaped smoke variant: attention-free end levels, one projection tower,
# 5 ids (32 + 5 x 8 = 72)
SMOKEREF_UNET = UNetConfig(
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(32, 64, 96, 96),
    layers_per_block=1,
    transformer_layers_per_block=2,
    attention_head_dim=(2, 4, 6, 6),
    cross_attention_dim=32,
    use_linear_projection=True,
    norm_num_groups=16,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 5 * 8,
)

# variant -> (UNet, VAE, text encoder) configs; a pair of text configs is SDXL's
# dual encoder
VARIANTS = {
    "sd15": (UNetConfig(), VAEConfig(), CLIPTextConfig()),
    "sd21": (SD21_UNET, VAEConfig(), SD21_CLIP),
    "sdxl": (SDXL_UNET, SDXL_VAE, (SDXL_CLIP1, SDXL_CLIP2)),
    "sdxl-refiner": (SDXL_REFINER_UNET, SDXL_VAE, SDXL_CLIP2),
    "smoke": (SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP),
    "smoke2": (SMOKE2_UNET, SMOKE_VAE, SMOKE2_CLIP),
    "smokexl": (SMOKEXL_UNET, SMOKE_VAE, (SMOKEXL_CLIP1, SMOKEXL_CLIP2)),
    "smokeref": (SMOKEREF_UNET, SMOKE_VAE, SMOKEXL_CLIP2),
}
# the base models the serving and sampling CLIs build, and those they build in bf16
# (scripts/serve.py :97-98, scripts/sample.py :142); the smoke stacks and the refiner
# variants are fp32
BASE_VARIANTS = ("sd15", "sd21", "sdxl", "smoke", "smoke2", "smokexl")
BF16_VARIANTS = ("sd15", "sd21", "sdxl")


def model_dtype(variant: str) -> torch.dtype:
    """The dtype the CLIs build ``variant`` in."""
    return torch.bfloat16 if variant in BF16_VARIANTS else torch.float32


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
                 ) -> Tuple[UNet2DConditionModel, AutoencoderKL,
                            Union[CLIPTextModel, DualCLIPTextEncoder]]:
    """(unet, vae, text_encoder) on ``device`` in ``dtype``. With a generator the
    weights are random and seeded (the generator must live on ``device``); without
    one they are uninitialised, for ``utils/convert.py`` to fill. SDXL's text
    encoder is the ``DualCLIPTextEncoder``; the refiner's is tower 2 alone, whose
    projection head makes it return (context, pooled) as well."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown model variant {variant!r}; known: {sorted(VARIANTS)}")
    ucfg, vcfg, ccfg = VARIANTS[variant]
    device = torch.device(device)
    text_cls = DualCLIPTextEncoder if isinstance(ccfg, tuple) else CLIPTextModel
    return (materialize(UNet2DConditionModel, ucfg, device, generator, dtype),
            materialize(AutoencoderKL, vcfg, device, generator, dtype),
            materialize(text_cls, ccfg, device, generator, dtype))


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
