"""Configuration system.

The port's own copy of ``controllora_tpu/config.py`` (numpy only):
the port imports nothing of the JAX package. tests/test_torch_standalone.py
holds the two equal.

Mirrors the reference's diffusers-style JSON config surface so that the 8 reference config
files (reference configs/*.json, captured by `register_to_config` at reference
models.py:619-666) load verbatim, while exposing a typed dataclass for the JAX build.

Config invariants validated here reproduce reference models.py:674-678:
  * ``lora_block_in_channels[0] == block_out_channels[-1]``
  * ``lora_pre_conv_skipped`` forces ``lora_control_channels = lora_block_in_channels`` and
    ``lora_control_self_add = False``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple


def _tuplify(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class ControlLoRAConfig:
    """Architecture config of the ControlLoRA adapter (hint encoder + attention adapters).

    Field names match the reference JSON schema exactly (reference models.py:620-666).
    """

    in_channels: int = 3
    down_block_types: Tuple[str, ...] = (
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (32, 64, 128, 256)
    layers_per_block: int = 1
    act_fn: str = "silu"
    norm_num_groups: int = 32
    lora_pre_down_block_types: Tuple[Optional[str], ...] = (
        None,
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
    )
    lora_pre_down_layers_per_block: int = 1
    lora_pre_conv_skipped: bool = False
    lora_pre_conv_types: Tuple[str, ...] = (
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
        "SimpleDownEncoderBlock2D",
    )
    lora_pre_conv_layers_per_block: int = 1
    lora_pre_conv_layers_kernel_size: int = 1
    lora_block_in_channels: Tuple[int, ...] = (256, 256, 256, 256)
    lora_block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    lora_cross_attention_dims: Tuple[Tuple[Optional[int], ...], ...] = (
        (None, 768, None, 768, None, 768, None, 768, None, 768),
        (None, 768, None, 768, None, 768, None, 768, None, 768),
        (None, 768, None, 768, None, 768, None, 768, None, 768),
        (None, 768),
    )
    lora_rank: int = 4
    lora_control_rank: Optional[int] = None
    lora_post_add: bool = False
    lora_concat_hidden: bool = False
    lora_control_channels: Tuple[Optional[int], ...] = (None, None, None, None)
    lora_control_self_add: bool = True
    lora_key_states_skipped: bool = False
    lora_value_states_skipped: bool = False
    lora_output_states_skipped: bool = False
    lora_control_version: int = 1

    def __post_init__(self):
        object.__setattr__(self, "down_block_types", _tuplify(self.down_block_types))
        object.__setattr__(self, "block_out_channels", _tuplify(self.block_out_channels))
        object.__setattr__(
            self, "lora_pre_down_block_types", _tuplify(self.lora_pre_down_block_types)
        )
        object.__setattr__(self, "lora_pre_conv_types", _tuplify(self.lora_pre_conv_types))
        object.__setattr__(
            self, "lora_block_in_channels", _tuplify(self.lora_block_in_channels)
        )
        object.__setattr__(
            self, "lora_block_out_channels", _tuplify(self.lora_block_out_channels)
        )
        object.__setattr__(
            self, "lora_cross_attention_dims", _tuplify(self.lora_cross_attention_dims)
        )
        lcc = _tuplify(self.lora_control_channels)
        # Reference invariants (models.py:674-678).
        if self.lora_block_in_channels[0] != self.block_out_channels[-1]:
            raise ValueError(
                "lora_block_in_channels[0] must equal block_out_channels[-1] "
                f"(got {self.lora_block_in_channels[0]} vs {self.block_out_channels[-1]})"
            )
        if self.lora_pre_conv_skipped:
            lcc = self.lora_block_in_channels
            object.__setattr__(self, "lora_control_self_add", False)
        # Pad control channels to the number of buckets (the reference's danbooru-sketch
        # config lists only 3 entries for 4 buckets; torch indexing never reaches [3] only
        # because lora_pre_conv_skipped overrides the whole tuple first).
        if len(lcc) < len(self.lora_block_out_channels):
            lcc = tuple(lcc) + (None,) * (len(self.lora_block_out_channels) - len(lcc))
        object.__setattr__(self, "lora_control_channels", lcc)

    # ------------------------------------------------------------------ properties

    @property
    def num_buckets(self) -> int:
        return len(self.lora_block_out_channels)

    @property
    def control_version(self) -> int:
        return self.lora_control_version

    def bucket_control_channels(self, i: int) -> int:
        """Channel width of the control feature map delivered to bucket ``i``."""
        c = self.lora_control_channels[i]
        return self.lora_block_out_channels[i] if c is None else c

    @property
    def effective_control_rank(self) -> int:
        return self.lora_rank if self.lora_control_rank is None else self.lora_control_rank

    # ------------------------------------------------------------------ JSON round-trip

    _JSON_FIELDS = (
        "in_channels",
        "down_block_types",
        "block_out_channels",
        "layers_per_block",
        "act_fn",
        "norm_num_groups",
        "lora_pre_down_block_types",
        "lora_pre_down_layers_per_block",
        "lora_pre_conv_skipped",
        "lora_pre_conv_types",
        "lora_pre_conv_layers_per_block",
        "lora_pre_conv_layers_kernel_size",
        "lora_block_in_channels",
        "lora_block_out_channels",
        "lora_cross_attention_dims",
        "lora_rank",
        "lora_control_rank",
        "lora_post_add",
        "lora_concat_hidden",
        "lora_control_channels",
        "lora_control_self_add",
        "lora_key_states_skipped",
        "lora_value_states_skipped",
        "lora_output_states_skipped",
        "lora_control_version",
    )

    @classmethod
    def from_dict(cls, d: dict) -> "ControlLoRAConfig":
        kwargs = {k: v for k, v in d.items() if k in cls._JSON_FIELDS}
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "ControlLoRAConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # Alias matching the reference API (`ControlLoRA.from_config`, reference
    # train_text_to_image_control_lora.py:427).
    from_config = from_json

    def to_dict(self) -> dict:
        def _listify(x):
            if isinstance(x, tuple):
                return [_listify(v) for v in x]
            return x

        d = {k: _listify(getattr(self, k)) for k in self._JSON_FIELDS}
        d["_class_name"] = "ControlLoRA"
        return d

    def save_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    save_config = save_json


# ---------------------------------------------------------------------------- presets
# Built programmatically (not copied JSON) to reproduce the reference's 8 config variants
# (reference configs/: base, fill50k, mpii-pose, diffusiondb-canny = v1 defaults; post-add;
# danbooru-sketch; *-v2).


def _v2_kwargs():
    return dict(
        lora_control_version=2,
        lora_concat_hidden=True,
        lora_control_channels=(256, 256, 256),
        lora_control_self_add=False,
        lora_key_states_skipped=True,
        lora_value_states_skipped=True,
        lora_output_states_skipped=False,
        lora_pre_conv_skipped=True,
    )


_PRESETS = {
    "base": dict(),
    "fill50k": dict(),
    "mpii-pose": dict(),
    "diffusiondb-canny": dict(),
    "post-add": dict(lora_post_add=True),
    "danbooru-sketch": dict(
        lora_pre_conv_skipped=True,
        lora_concat_hidden=True,
        lora_control_channels=(256, 256, 256),
        lora_control_self_add=False,
        lora_control_rank=256,
    ),
    "diffusiondb-canny-v2": _v2_kwargs(),
    "mpii-pose-v2": _v2_kwargs(),
}


def preset_names() -> List[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> ControlLoRAConfig:
    """Build a named config variant matching the reference's configs/<name>.json."""
    if name.endswith(".json"):
        return ControlLoRAConfig.from_json(name)
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {preset_names()}")
    return ControlLoRAConfig(**_PRESETS[name])


def load_config(path_or_name: str) -> ControlLoRAConfig:
    """Load from a JSON file path (reference format) or a preset name."""
    if os.path.exists(path_or_name):
        return ControlLoRAConfig.from_json(path_or_name)
    return get_preset(path_or_name)
