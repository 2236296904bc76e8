"""LoRA and ControlLoRA adapter math (counterpart of ``controllora_tpu/models/lora.py``).

An adapter's parameters travel as the JAX package's pytree layout, a dict
``{proj: {"down": (in, r), "up": (r, out)}}`` of tensors, so the folding algebra
(``ops/folding.py``) and the threaded ``adapt_*`` chains below read exactly like their
JAX counterparts. Serving folds every adapter; training threads them.

Reference quirks kept deliberately (as the JAX module keeps them):
  * pre/post-chain value LoRAs are applied WITHOUT the ``scale`` factor;
  * the main control adapter's out-LoRA is applied unconditionally (the skip flag
    only decides whether its parameters exist);
  * a control batch n under the CFG hidden batch 2n is TILED, never interleaved;
    batch-1 control broadcasts.
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


def stack_order(stack: AdapterStack) -> Tuple[AttnAdapter, ...]:
    """pre..., main, post... (the reference's chain order)."""
    main = (stack.main,) if stack.main is not None else ()
    return (*stack.pre, *main, *stack.post)


def _match_batch(c: torch.Tensor, b: int) -> torch.Tensor:
    """TILE the control batch to the hidden batch: guide i pairs with hidden rows i
    and n + i of the block [u1..un || c1..cn] CFG layout (never interleave)."""
    return tile_batch(c, b)


def cast_adapters(adapters: Dict[str, AdapterStack], dtype: torch.dtype
                  ) -> Dict[str, AdapterStack]:
    """Every factor and control map of an adapter dict cast to ``dtype`` (the JAX
    trainer's ``adapter_compute_dtype`` tree map); gradients flow through the cast."""

    def cast(a: AttnAdapter) -> AttnAdapter:
        params = {proj: {k: t.to(dtype) for k, t in pair.items()}
                  for proj, pair in a.params.items()}
        control = None if a.control is None else a.control.to(dtype)
        return dataclasses.replace(a, params=params, control=control)

    return {name: AdapterStack(main=None if s.main is None else cast(s.main),
                               pre=tuple(map(cast, s.pre)), post=tuple(map(cast, s.post)))
            for name, s in adapters.items()}


def map_controls(stack: AdapterStack, fn) -> AdapterStack:
    """``stack`` with ``fn`` applied to the control state of every adapter that
    carries one (main, pre and post); the factors stay as they are."""

    def adapt(a: Optional[AttnAdapter]) -> Optional[AttnAdapter]:
        if a is None or a.control is None:
            return a
        return dataclasses.replace(a, control=fn(a.control))

    return AdapterStack(main=adapt(stack.main), pre=tuple(map(adapt, stack.pre)),
                        post=tuple(map(adapt, stack.post)))


def is_foldable(adapters: Dict[str, Any]) -> bool:
    """Every stack has a main adapter and no pre/post chain (JAX pipeline :795-797)."""
    return bool(adapters) and all(
        s.main is not None and not s.pre and not s.post for s in adapters.values()
    )


# ---------------------------------------------------------------------------- math


def lora_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x @ down @ up, computed in the params' dtype (fp32 adapters over bf16
    activations) and cast back to x.dtype."""
    dt = p["down"].dtype
    return ((x.to(dt) @ p["down"]) @ p["up"]).to(x.dtype)


def process_control_states(adapter: AttnAdapter, hidden: torch.Tensor, scale,
                           which: str = "to_control") -> torch.Tensor:
    """The control residual term: hidden (B, L, H), adapter.control (Bc, L, Cc)."""
    spec = adapter.spec
    c = adapter.control.to(hidden.dtype)
    if c.shape[0] not in (1, hidden.shape[0]):
        c = _match_batch(c, hidden.shape[0])
    x = c
    if spec.concat_hidden:
        c = _match_batch(c, hidden.shape[0])
        x = torch.cat([hidden, c], dim=-1)
    proj = scale * lora_apply(adapter.params[which], x)
    if spec.control_self_add:
        return c + proj
    return proj


# Each helper folds the (pre, main, post) chain for one projection in the
# reference's order, with its flags.


def adapt_query(stack: AdapterStack, query: torch.Tensor, hidden: torch.Tensor, scale):
    """q-projection chain (v1 adds the control residual to the LoRA input)."""

    def chain_side(q, adapters, include_control: bool):
        for a in adapters:
            lora_in = q if a.spec.post_add else hidden
            if include_control and a.spec.kind == "control_v1":
                lora_in = lora_in + process_control_states(a, hidden, scale)
            q = q + scale * lora_apply(a.params["to_q"], lora_in)
        return q

    main = stack.main
    if main is None:
        return chain_side(query, (*stack.pre, *stack.post), True)
    v2 = main.spec.kind == "control_v2"
    query = chain_side(query, stack.pre, not v2)
    lora_in = query if main.spec.post_add else hidden
    if main.spec.kind == "control_v1":
        lora_in = lora_in + process_control_states(main, hidden, scale)
    query = query + scale * lora_apply(main.params["to_q"], lora_in)
    return chain_side(query, stack.post, not v2)


def adapt_key(stack: AdapterStack, key: torch.Tensor, ctx: torch.Tensor, scale):
    """k-projection chain."""
    for a in stack_order(stack):
        if not a.spec.key_skipped:
            key = key + scale * lora_apply(a.params["to_k"], key if a.spec.post_add else ctx)
    return key


def adapt_value(stack: AdapterStack, value: torch.Tensor, ctx: torch.Tensor, scale):
    """v-projection chain; pre/post value LoRAs take no ``scale`` (reference quirk)."""
    for a in stack_order(stack):
        if not a.spec.value_skipped:
            s = scale if a is stack.main else 1.0
            value = value + s * lora_apply(a.params["to_v"],
                                           value if a.spec.post_add else ctx)
    return value


def _adapt_hidden_v2(stack: AdapterStack, hidden: torch.Tensor, scale, which: str):
    for a in stack_order(stack):
        if a.spec.kind == "control_v2":
            hidden = hidden + process_control_states(a, hidden, scale, which)
    return hidden


def adapt_hidden_pre_q(stack: AdapterStack, hidden: torch.Tensor, scale):
    """v2 only: control residual added to the hidden states before the q projection."""
    return _adapt_hidden_v2(stack, hidden, scale, "to_control")


def adapt_hidden_post_attn(stack: AdapterStack, hidden: torch.Tensor, scale):
    """v2 only: second control residual after attention, before the out projection."""
    return _adapt_hidden_v2(stack, hidden, scale, "to_control_out")


def adapt_output(stack: AdapterStack, out: torch.Tensor, attn_hidden: torch.Tensor, scale):
    """out-projection chain. The main CONTROL adapter's out-LoRA is unconditional
    (reference quirk); plain-LoRA mains and pre/post adapters honour the skip flag."""
    for a in stack_order(stack):
        main_control = a is stack.main and a.spec.is_control
        if main_control or not a.spec.output_skipped:
            out = out + scale * lora_apply(a.params["to_out"],
                                           out if a.spec.post_add else attn_hidden)
    return out



# ---------------------------------------------------------------------------- init


def init_lora_params(generator: torch.Generator, in_dim: int, out_dim: int, rank: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """A LoRA factor pair as diffusers' LoRALinearLayer starts it: down ~ N(0, 1/rank),
    up = 0, so a fresh adapter is the identity perturbation. fp32, drawn from
    ``generator`` (which must live on ``device``)."""
    down = torch.randn((in_dim, rank), generator=generator, device=device) / rank
    return {"down": down, "up": torch.zeros((rank, out_dim), device=device)}


def init_adapter_params(generator: torch.Generator, hidden_size: int,
                        cross_attention_dim: Optional[int], rank: int, spec: AdapterSpec,
                        control_rank: Optional[int] = None,
                        control_channels: Optional[int] = None,
                        device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One adapter's factor pairs (the JAX ``init_adapter_params`` layout), drawn in
    the order to_q, to_k, to_v, to_out, to_control, to_control_out."""
    kv_in = hidden_size if spec.post_add else (cross_attention_dim or hidden_size)

    def pair(i, o, r=rank):
        return init_lora_params(generator, i, o, r, device)

    p = {"to_q": pair(hidden_size, hidden_size)}
    if not spec.key_skipped:
        p["to_k"] = pair(kv_in, hidden_size)
    if not spec.value_skipped:
        p["to_v"] = pair(kv_in, hidden_size)
    if spec.is_control or not spec.output_skipped:
        p["to_out"] = pair(hidden_size, hidden_size)
    if spec.is_control:
        crank = control_rank if control_rank is not None else rank
        cch = control_channels if control_channels is not None else hidden_size
        in_dim = cch + (hidden_size if spec.concat_hidden else 0)
        p["to_control"] = pair(in_dim, hidden_size, crank)
        if spec.kind == "control_v2":
            p["to_control_out"] = pair(in_dim, hidden_size, crank)
    return p


def make_plain_lora_adapters(generator: torch.Generator, rank: int = 4, unet_config=None,
                             post_add: bool = False, device=None) -> Dict[str, AttnAdapter]:
    """One plain LoRA adapter per UNet attention layer: the DreamBooth-LoRA model
    (reference train_dreambooth_lora.py:706-722, rank = --lora_rank), as
    {processor name: AttnAdapter} for threading, folding or ``merge_extra_loras``."""
    from controllora_tpu_torch.models import unet as unet_lib

    cfg = unet_config or unet_lib.UNetConfig()
    spec = AdapterSpec(kind="lora", post_add=post_add)
    return {name: AttnAdapter(params=init_adapter_params(
                generator, unet_lib.processor_hidden_size(name, cfg),
                unet_lib.processor_cross_dim(name, cfg), rank, spec, device=device),
                spec=spec)
            for name in unet_lib.attention_processor_names(cfg)}
