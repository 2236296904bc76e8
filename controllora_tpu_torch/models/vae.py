"""SD1.5 VAE decoder in PyTorch (counterpart of ``controllora_tpu/models/vae.py``).

Parameter names follow diffusers' AutoencoderKL (the 0.13 AttentionBlock naming
``group_norm``/``query``/``key``/``value``/``proj_attn``). The mid-block attention is
one head with D = 512 over L = (H/8)*(W/8) tokens; at 512² (L = 4096) on a CUDA
tensor it runs on the flash kernel K2. Decoding is one plain batched call: the JAX
package's ``decode_per_image`` works around an XLA scheduling problem. The Encoder
(and ``quant_conv``) come with the training slice; ``utils/convert.py`` drops their
keys when it loads a full VAE state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.models.unet import GroupNorm, conv3, from_tokens, to_tokens
from controllora_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD1.5 VAE architecture (runwayml/stable-diffusion-v1-5 vae/config.json)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, 1e-6)
        self.conv1 = conv3(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, 1e-6)
        self.conv2 = conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head mid-block self-attention (diffusers AttentionBlock)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x):
        _, _, hh, ww = x.shape
        h = to_tokens(self.group_norm(x))
        h = dot_product_attention(self.query(h), self.key(h), self.value(h), heads=1)
        return x + from_tokens(self.proj_attn(h), hh, ww)


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        groups = cfg.norm_num_groups
        ch = cfg.block_out_channels[-1]
        self.conv_in = conv3(cfg.latent_channels, ch)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([VAEResnet(ch, ch, groups),
                                                VAEResnet(ch, ch, groups)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch, groups)])
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        for bi, out_ch in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList([
                VAEResnet(ch if li == 0 else out_ch, out_ch, groups)
                for li in range(cfg.layers_per_block + 1)
            ])
            ch = out_ch
            if bi != len(rev) - 1:
                up = nn.Module()
                up.conv = conv3(out_ch, out_ch)
                block.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm(groups, ch, 1e-6)
        self.conv_out = conv3(ch, cfg.out_channels)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0,
                                                           mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Decode half of the SD VAE: ``post_quant_conv`` + ``decoder``."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> image (B, 3, 8h, 8w) in [-1, 1], in the
        module's dtype."""
        z = (z / self.config.scaling_factor).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
