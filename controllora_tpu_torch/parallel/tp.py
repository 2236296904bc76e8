"""Tensor-parallel serving of the UNet's transformer blocks (counterpart of
``controllora_tpu/parallel/tp.py``): the 'model' mesh axis, Megatron style.

Per transformer sub-layer, the activations entering and leaving stay replicated:

* attention: ``to_q``/``to_k``/``to_v`` are column-sharded (their output features are
  head-major, so a contiguous 1/tp slice is a block of whole heads, and each rank
  runs attention, K1 on the card, on heads / tp heads); ``to_out.0`` is row-sharded,
  each rank holds a partial projection and one SUM all-reduce completes it. The
  constants that must appear once (``to_out.0``'s bias, the folded ``out_bias``) are
  divided by tp first.
* GEGLU: ``net.0.proj`` is column-sharded with its [a || gate] features re-blocked
  per rank (a rank's ``a`` and ``gate`` slices must match); ``net.2`` is row-sharded
  with the all-reduce, its bias divided.

Everything else replicates. Adapters fold into the weights and per-position biases
before the weights shard, so the q/k/v biases shard with their features.

The roles are the JAX package's names on its (in, out) kernels; a torch
``nn.Linear.weight`` is (out, in), so "col" slices a weight's ROWS (and its bias) and
"row" slices its COLUMNS.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from controllora_tpu_torch.ops.folding import FoldedBias


def _role(name: str) -> str:
    """Sharding role of a UNet parameter, by its state-dict name: "col", "row",
    "geglu_col", "scaled" (a bias divided by tp) or "rep"."""
    parts = name.split(".")
    leaf = parts[-1]
    if len(parts) >= 3 and parts[-3].startswith("attn") and parts[-2] in ("to_q", "to_k",
                                                                         "to_v"):
        return "col" if leaf == "weight" else "rep"
    if len(parts) >= 4 and parts[-4].startswith("attn") and parts[-3:-1] == ["to_out", "0"]:
        return "row" if leaf == "weight" else "scaled"
    if parts[-5:-1] == ["ff", "net", "0", "proj"]:
        return "geglu_col"
    if parts[-4:-1] == ["ff", "net", "2"]:
        return "row" if leaf == "weight" else "scaled"
    return "rep"


def _geglu_permute(x: torch.Tensor, tp: int) -> torch.Tensor:
    """Re-block GEGLU's [a(F) || gate(F)] features (dim 0 of the weight and the bias)
    into per-rank [a_r || gate_r] pairs, so that a contiguous 1/tp slice carries
    matching halves."""
    f2 = x.shape[0]
    assert f2 % (2 * tp) == 0, f"GEGLU width {f2} not divisible by 2*tp={2 * tp}"
    f = f2 // 2
    y = x.reshape((2, tp, f // tp) + tuple(x.shape[1:]))
    return y.transpose(0, 1).reshape(x.shape)


def tp_prepare_params(params: Dict[str, torch.Tensor], tp: int) -> Dict[str, torch.Tensor]:
    """The global pass before slicing: GEGLU features re-blocked per rank, the
    row-parallel biases divided by tp (the ranks' partial sums then add up to exactly
    W x + b)."""
    out = {}
    for name, t in params.items():
        role = _role(name)
        if role == "geglu_col":
            t = _geglu_permute(t, tp)
        elif role == "scaled":
            t = t / tp
        out[name] = t
    return out


def tp_shard_params(params: Dict[str, torch.Tensor], tp: int, rank: int
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of prepared parameters (the JAX ``tp_param_specs`` slicing
    in torch's layout): "col" and "geglu_col" keep a contiguous 1/tp of the output
    features (weight rows, bias), "row" a 1/tp of a weight's input columns; the rest
    is shared as it is."""
    out = {}
    for name, t in params.items():
        role = _role(name)
        if role in ("col", "geglu_col"):
            w = t.shape[0] // tp
            t = t[rank * w:(rank + 1) * w].contiguous()
        elif role == "row":
            w = t.shape[1] // tp
            t = t[:, rank * w:(rank + 1) * w].contiguous()
        out[name] = t
    return out


def tp_prepare_biases(biases: Optional[Dict[str, FoldedBias]], tp: int):
    """Folded per-position biases: ``out_bias`` is added before the all-reduce of the
    row-parallel out projection, so it is divided by tp; q/k/v biases are unchanged
    here (they shard with their features)."""
    if not biases:
        return biases
    return {name: FoldedBias(fb.q_bias, fb.k_bias, fb.v_bias,
                             None if fb.out_bias is None else fb.out_bias / tp)
            for name, fb in biases.items()}


def tp_shard_biases(biases: Optional[Dict[str, FoldedBias]], tp: int, rank: int):
    """Rank ``rank``'s folded biases: q/k/v biases keep their 1/tp slice of the last
    (feature) dimension, contiguous as K1's tensor maps need; ``out_bias`` replicates."""
    if not biases:
        return biases

    def col(b):
        if b is None:
            return None
        w = b.shape[-1] // tp
        return b[..., rank * w:(rank + 1) * w].contiguous()

    return {name: FoldedBias(col(fb.q_bias), col(fb.k_bias), col(fb.v_bias), fb.out_bias)
            for name, fb in biases.items()}


def validate_tp(config, tp: int) -> None:
    """Fail fast on UNet configs whose heads or GEGLU widths the sharding cannot split
    (the JAX rule and messages: only levels that materialise attention count, so
    SDXL's 5-head level 0 does not; the mid block uses the last entry)."""
    hd = config.attention_head_dim
    n = len(config.block_out_channels)
    per_block = tuple(hd) if isinstance(hd, (tuple, list)) else ((hd,) * n)
    for i, heads in enumerate(per_block):
        has_attn = (
            config.down_block_types[i] == "CrossAttnDownBlock2D"
            or config.up_block_types[n - 1 - i] == "CrossAttnUpBlock2D"
            or i == n - 1
        )
        if has_attn and heads % tp:
            raise ValueError(
                f"tensor-parallel serving shards attention by whole heads: "
                f"heads={heads} (level {i}) not divisible by model-axis size {tp}"
            )
    for ch in config.block_out_channels:
        if (4 * ch) % tp:  # GEGLU inner = dim * 4
            raise ValueError(
                f"GEGLU inner width {4 * ch} not divisible by model-axis size {tp}"
            )
