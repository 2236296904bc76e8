"""ControlLoRA hint encoder + per-bucket attention adapters in PyTorch (counterpart of
``controllora_tpu/models/control_lora.py``).

State-dict keys follow the reference ControlLoRA (``conv_in``, ``down_blocks.0.<k>``,
``down_blocks.<i>``, ``pre_lora_layers.<i>``, ``lora_layers.<i>.<j>.to_q_lora.down``),
which is what ``utils/torch_compat.control_lora_to_torch`` writes.

The module is trainable as it is: the adapter factors ``build_adapters`` hands out
are views of its ``Parameter``s, so gradients through the threaded UNet reach them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.models import unet as unet_lib
from controllora_tpu_torch.models.lora import AdapterSpec, AdapterStack, AttnAdapter
from controllora_tpu_torch.models.unet import GroupNorm, UNetConfig, conv3, to_tokens


class ConvBlock2D(nn.Module):
    """GroupNorm -> SiLU -> Conv(k) -> GroupNorm -> SiLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(min(groups, in_channels), in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, kernel_size,
                               padding=kernel_size // 2)
        self.norm2 = GroupNorm(min(groups, out_channels), out_channels, eps)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        return F.silu(self.norm2(h))


class _Downsampler(nn.Module):
    """Stride-2 conv after an asymmetric (0, 1) pad (diffusers Downsample2D with
    padding=0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class SimpleDownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 kernel_size: int = 3, groups: int = 32, add_downsample: bool = True):
        super().__init__()
        self.convnets = nn.ModuleList([
            ConvBlock2D(in_channels if i == 0 else out_channels, out_channels,
                        kernel_size, groups)
            for i in range(num_layers)
        ])
        if add_downsample:
            self.downsamplers = nn.ModuleList([_Downsampler(out_channels)])

    def forward(self, x):
        for block in self.convnets:
            x = block(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class HintEncoder(nn.Module):
    """conv_in -> 4-block pyramid (/8) -> per bucket [extra /2 block + pre-LoRA conv]."""

    def __init__(self, config: ControlLoRAConfig):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_out_channels
        self.conv_in = conv3(cfg.in_channels, chans[0])
        pyramid = []
        ch = chans[0]
        for i, out in enumerate(chans):
            pyramid.append(SimpleDownEncoderBlock2D(
                ch, out, cfg.layers_per_block, groups=cfg.norm_num_groups,
                add_downsample=i != len(chans) - 1))
            ch = out
        self.down_blocks = nn.ModuleList([nn.Sequential(*pyramid)])
        self.pre_lora_layers = nn.ModuleList()
        for i in range(cfg.num_buckets):
            if i > 0:
                out = cfg.lora_block_in_channels[i]
                self.down_blocks.append(SimpleDownEncoderBlock2D(
                    ch, out, cfg.lora_pre_down_layers_per_block,
                    groups=cfg.norm_num_groups, add_downsample=True))
                ch = out
            if not cfg.lora_pre_conv_skipped:
                self.pre_lora_layers.append(SimpleDownEncoderBlock2D(
                    ch, cfg.bucket_control_channels(i), cfg.lora_pre_conv_layers_per_block,
                    kernel_size=cfg.lora_pre_conv_layers_kernel_size,
                    groups=cfg.norm_num_groups, add_downsample=False))

    def apply(self, guide: torch.Tensor, dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, ...]:
        """guide (B, 3, H, W) in [-1, 1] -> per-bucket control states (B, L_i, C_i),
        fp32, tokens row-major over (h, w).

        ``dtype`` is the convolutions' compute dtype (flax ``ControlLoRA(dtype=)``):
        their weights are cast for this call only, the norms keep theirs, and
        gradients flow back through the cast to the master weights. None computes
        in the weights' own dtype."""
        if dtype is None:
            return self(guide)
        casts = {f"{name}.{p}": t.to(dtype)
                 for name, m in self.named_modules() if isinstance(m, nn.Conv2d)
                 for p, t in m.named_parameters(recurse=False)}
        return functional_call(self, casts, (guide,))

    def forward(self, guide: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dtype = self.conv_in.weight.dtype
        h = self.down_blocks[0](self.conv_in(guide.to(dtype)))
        controls = []
        for i in range(self.config.num_buckets):
            if i > 0:
                h = self.down_blocks[i](h)
            c = h if self.config.lora_pre_conv_skipped else self.pre_lora_layers[i](h)
            controls.append(to_tokens(c).float())
        return tuple(controls)


def config_for_unet(config: ControlLoRAConfig, unet_config: UNetConfig) -> ControlLoRAConfig:
    """``config`` re-derived for a UNet family (JAX ``scripts/train.py`` :164-181):
    one bucket a level, each as wide as its level, the hint encoder's per-bucket
    channels cut to the number of levels, and one adapter slot for each of the
    UNet's attention layers (``derive_cross_attention_dims``). A level without
    attention (SDXL's level 0) gets an adapter-free bucket. SD1.5 keeps the
    reference configs' layout; SD2.1 keeps its 32 slots with a 1024-d context; SDXL
    has 140."""
    n = len(unet_config.block_out_channels)
    return dataclasses.replace(
        config,
        lora_block_out_channels=unet_config.block_out_channels,
        lora_block_in_channels=config.lora_block_in_channels[:n],
        lora_control_channels=config.lora_control_channels[:n],
        lora_cross_attention_dims=unet_lib.derive_cross_attention_dims(unet_config),
    )


def adapter_spec_for(cfg: ControlLoRAConfig, bucket: int) -> AdapterSpec:
    """Spec of a main control adapter in a bucket. ``control_self_add`` stays False
    for v1: the executed reference constructor never enables it (JAX
    ``control_lora.py`` :173-182, pinned by its parity suite)."""
    if cfg.control_version == 2:
        return AdapterSpec(kind="control_v2", post_add=False, concat_hidden=True,
                           control_self_add=False, key_skipped=True,
                           value_skipped=True, output_skipped=False)
    return AdapterSpec(
        kind="control_v1",
        post_add=cfg.lora_post_add,
        concat_hidden=cfg.lora_concat_hidden,
        control_self_add=False,
        key_skipped=cfg.lora_key_states_skipped,
        value_skipped=cfg.lora_value_states_skipped,
        output_skipped=cfg.lora_output_states_skipped,
    )


class LoRALinear(nn.Module):
    """x @ down @ up as two bias-free Linear layers (reference LoRALinearLayer)."""

    def __init__(self, in_dim: int, out_dim: int, rank: int):
        super().__init__()
        self.down = nn.Linear(in_dim, rank, bias=False)
        self.up = nn.Linear(rank, out_dim, bias=False)


# module name in the reference state dict -> JAX pytree key
_LORA_PROJ = {"to_q_lora": "to_q", "to_k_lora": "to_k", "to_v_lora": "to_v",
              "to_out_lora": "to_out", "to_control": "to_control",
              "to_control_out": "to_control_out"}


def _adapter_layers(hidden: int, cross: Optional[int], rank: int, spec: AdapterSpec,
                    control_rank: int, control_channels: int) -> nn.Module:
    """One adapter slot (JAX ``init_adapter_params``)."""
    m = nn.Module()
    kv_in = hidden if spec.post_add else (cross or hidden)
    m.to_q_lora = LoRALinear(hidden, hidden, rank)
    if not spec.key_skipped:
        m.to_k_lora = LoRALinear(kv_in, hidden, rank)
    if not spec.value_skipped:
        m.to_v_lora = LoRALinear(kv_in, hidden, rank)
    if spec.is_control or not spec.output_skipped:
        m.to_out_lora = LoRALinear(hidden, hidden, rank)
    if spec.is_control:
        in_dim = control_channels + (hidden if spec.concat_hidden else 0)
        m.to_control = LoRALinear(in_dim, hidden, control_rank)
        if spec.kind == "control_v2":
            m.to_control_out = LoRALinear(in_dim, hidden, control_rank)
    return m


class ControlLoRA(HintEncoder):
    """Hint encoder plus the per-bucket adapter slots (``lora_layers``)."""

    def __init__(self, config: ControlLoRAConfig):
        super().__init__(config)
        self.lora_layers = nn.ModuleList()
        for i in range(config.num_buckets):
            spec = adapter_spec_for(config, i)
            self.lora_layers.append(nn.ModuleList([
                _adapter_layers(config.lora_block_out_channels[i], cross,
                                config.lora_rank, spec, config.effective_control_rank,
                                config.bucket_control_channels(i))
                for cross in config.lora_cross_attention_dims[i]
            ]))

    @staticmethod
    def slot_params(slot: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
        """A slot's factors in the JAX layout {proj: {"down": (in, r), "up": (r, out)}}."""
        return {_LORA_PROJ[name]: {"down": m.down.weight.t(), "up": m.up.weight.t()}
                for name, m in slot.named_children()}

    def build_adapters(self, control_states: Sequence[torch.Tensor],
                       unet_config: UNetConfig = UNetConfig()) -> Dict[str, AdapterStack]:
        """Assign bucket adapters to the UNet's attention layers in processor-name
        order; running out of slots in a bucket is an error."""
        cfg = self.config
        n_blocks = len(unet_config.block_out_channels)
        cursors: List[int] = [0] * cfg.num_buckets
        adapters: Dict[str, AdapterStack] = {}
        for name in unet_lib.attention_processor_names(unet_config):
            bucket = unet_lib.processor_bucket(name, n_blocks)
            j = cursors[bucket]
            if j >= len(self.lora_layers[bucket]):
                raise ValueError(
                    f"ControlLoRA config provides only {j} adapter slot(s) for bucket "
                    f"{bucket} but UNet layer {name!r} needs slot {j + 1}")
            cursors[bucket] += 1
            adapters[name] = AdapterStack(main=AttnAdapter(
                params=self.slot_params(self.lora_layers[bucket][j]),
                control=control_states[bucket],
                spec=adapter_spec_for(cfg, bucket),
            ))
        return adapters

    def adapters_for(self, guide: torch.Tensor, unet_config: UNetConfig = UNetConfig(),
                     dtype: Optional[torch.dtype] = None) -> Dict[str, AdapterStack]:
        """Encode the guide (convolutions in ``dtype``, see ``apply``) and build the
        adapter dict for the UNet."""
        return self.build_adapters(self.apply(guide, dtype), unet_config)
