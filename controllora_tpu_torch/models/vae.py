"""The SD VAE in PyTorch (counterpart of ``controllora_tpu/models/vae.py``); SDXL's
differs by its ``scaling_factor`` only.

Parameter names follow diffusers' AutoencoderKL (the 0.13 AttentionBlock naming
``group_norm``/``query``/``key``/``value``/``proj_attn``). The mid-block attentions
of the encoder and the decoder are one head with D = 512 over L = (H/8)*(W/8)
tokens; from 512² (L = 4096) on a CUDA tensor they run on the flash kernel K2 (the
VAE is frozen: training encodes without a graph); ``decode``'s ``attention_backend``
"xla" keeps them on the plain version. Decoding is one plain batched call:
the JAX package's ``decode_per_image`` works around an XLA scheduling problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    def forward(self, x, backend="auto"):
        _, _, hh, ww = x.shape
        h = to_tokens(self.group_norm(x))
        h = dot_product_attention(self.query(h), self.key(h), self.value(h), 1, backend)
        return x + from_tokens(self.proj_attn(h), hh, ww)


class Encoder(nn.Module):
    """Image (B, 3, H, W) -> posterior moments (B, 2 * latent, H/8, W/8)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        groups = cfg.norm_num_groups
        ch = cfg.block_out_channels[0]
        self.conv_in = conv3(cfg.in_channels, ch)
        self.down_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(cfg.block_out_channels):
            block = nn.Module()
            block.resnets = nn.ModuleList([
                VAEResnet(ch if li == 0 else out_ch, out_ch, groups)
                for li in range(cfg.layers_per_block)
            ])
            ch = out_ch
            if bi != len(cfg.block_out_channels) - 1:
                down = nn.Module()
                down.conv = nn.Conv2d(out_ch, out_ch, 3, stride=2)
                block.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(block)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([VAEResnet(ch, ch, groups),
                                                VAEResnet(ch, ch, groups)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch, groups)])
        self.conv_norm_out = GroupNorm(groups, ch, 1e-6)
        self.conv_out = conv3(ch, 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                # diffusers encoder downsample: asymmetric (0, 1) pad, stride-2 conv
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


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

    def forward(self, z, backend="auto"):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h, backend)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0,
                                                           mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """The SD VAE: ``encoder`` + ``quant_conv`` and ``post_quant_conv`` + ``decoder``."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        latent = config.latent_channels
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * latent, 2 * latent, 1)
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(latent, latent, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8, W/8) in
        the module's dtype; logvar clipped to [-30, 20]."""
        x = x.to(self.quant_conv.weight.dtype)
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latents: a posterior sample mean + std * noise when ``noise`` is
        given or drawn from ``generator``, else the posterior mean; times
        ``scaling_factor``."""
        mean, logvar = self.encode_moments(x)
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, z: torch.Tensor, attention_backend: str = "auto") -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> image (B, 3, 8h, 8w) in [-1, 1], in the
        module's dtype."""
        z = (z / self.config.scaling_factor).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z), attention_backend)
