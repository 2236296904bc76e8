"""Adapter data types (counterpart of ``controllora_tpu/models/lora.py`` :59-112).

An adapter's parameters travel as the JAX package's pytree layout, a dict
``{proj: {"down": (in, r), "up": (r, out)}}`` of tensors, so the folding algebra
(``ops/folding.py``) reads exactly like its JAX counterpart. The threaded
``adapt_*`` chains are not ported yet: the serving path folds every adapter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from controllora_tpu_torch.ops.attention import tile_batch


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Static flags of one attention adapter (reference processor constructor args)."""

    kind: str = "lora"  # lora | control_v1 | control_v2
    post_add: bool = False
    concat_hidden: bool = False
    control_self_add: bool = True
    key_skipped: bool = False
    value_skipped: bool = False
    output_skipped: bool = False

    @property
    def is_control(self) -> bool:
        return self.kind in ("control_v1", "control_v2")


@dataclasses.dataclass
class AttnAdapter:
    """One adapter: its factor pairs and, for control adapters, its control states
    (Bc, L, Cc), flattened row-major over (h, w)."""

    params: Dict[str, Dict[str, torch.Tensor]]
    control: Optional[torch.Tensor] = None
    spec: AdapterSpec = dataclasses.field(default_factory=AdapterSpec)


@dataclasses.dataclass
class AdapterStack:
    """The adapter chain installed on one attention layer."""

    main: Optional[AttnAdapter] = None
    pre: Tuple[AttnAdapter, ...] = ()
    post: Tuple[AttnAdapter, ...] = ()


def _match_batch(c: torch.Tensor, b: int) -> torch.Tensor:
    """TILE the control batch to the hidden batch: guide i pairs with hidden rows i
    and n + i of the block [u1..un || c1..cn] CFG layout (never interleave)."""
    return tile_batch(c, b)


def is_foldable(adapters: Dict[str, Any]) -> bool:
    """Every stack has a main adapter and no pre/post chain (JAX pipeline :795-797)."""
    return bool(adapters) and all(
        s.main is not None and not s.pre and not s.post for s in adapters.values()
    )
