"""UNet2DConditionModel of SD1.5, SD2.1, SDXL and the SDXL refiner in PyTorch
(counterpart of ``controllora_tpu/models/unet.py``).

NCHW inside; parameter names follow diffusers' state-dict keys, so
``load_state_dict(strict=True)`` takes ``utils/torch_compat.flax_to_torch_unet``
output (and diffusers safetensors) as they are. GroupNorm, LayerNorm and the GEGLU
gelu compute in fp32 whatever the weight dtype.

Attention layers run one of three paths, keyed by diffusers processor name:
  * adapter-free;
  * FOLDED (serving): the adapters are pre-folded into the projection weights
    (``ops/folding.py``) and only per-position biases (``FoldedBias``) ride the
    forward; self-attention with L >= 2048 on a CUDA tensor goes to the biased flash
    kernel K1;
  * THREADED (training): each layer runs its ``AdapterStack`` chain
    (``models/lora.py`` ``adapt_*``), so gradients reach the adapter factors; long
    self-attention on the card goes through ``FlashAttention`` (K2, K3 + K4).

Two serving accelerations, both off by default (``forward``):
  * ToMe (``ops/tome.py``): each self-attention on a long enough grid runs on merged
    tokens; the folded path's per-position biases and a threaded stack's control
    states merge with the same map (JAX ``unet.py`` :348-416).
  * DeepCache: a "full" eval also returns the feature entering the last up block; a
    "shallow" eval recomputes only the level-0 ops around a cached one
    (JAX ``unet.py`` :532-733).
The families differ by ``UNetConfig`` only: per-level heads and transformer depth,
attention-free levels (``DownBlock2D``/``UpBlock2D``), Linear ``proj_in``/``proj_out``
on the flattened tokens (SD2.x, SDXL) and SDXL's ``text_time`` micro-conditioning
(``add_embedding``, fed ``added_text_embeds`` and ``added_time_ids``).
A tensor-parallel instance (``tp_size`` > 1, ``parallel/tp.py``) holds each
transformer block's 1/tp slice: heads / tp local heads, a GEGLU inner of
4 * dim / tp, and a SUM all-reduce over ``tp_group`` after ``to_out.0`` and after
``net.2`` (JAX ``unet.py`` :216-345). It takes the sharded folded weights through
``functional_call``; a threaded ``AdapterStack`` cannot shard by heads and is refused.
``attention_backend`` (``ops/attention.py`` names) picks the attention route for a
whole eval: ``"xla"`` keeps every attention on its plain version, so an fp32 eval on
the card can stand as the reference of a bf16 one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.models.lora import (
    AdapterStack,
    _match_batch,
    adapt_hidden_post_attn,
    adapt_hidden_pre_q,
    adapt_key,
    adapt_output,
    adapt_query,
    adapt_value,
    map_controls,
)
from controllora_tpu_torch.ops import tome as tome_ops
from controllora_tpu_torch.ops.attention import dot_product_attention, use_flash
from controllora_tpu_torch.ops.folding import FoldedBias


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD1.5 architecture (runwayml/stable-diffusion-v1-5 unet/config.json) by
    default; ``models/zoo.py`` holds the other families'."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # number of heads (diffusers naming quirk): an int, or one per down block
    attention_head_dim: Any = 8
    # SD2.x/SDXL: Linear proj_in/proj_out on the flattened tokens instead of 1x1 convs
    use_linear_projection: bool = False
    # transformer depth per down block (int or tuple; up blocks mirror in reverse,
    # mid uses the last). SDXL: (1, 2, 10)
    transformer_layers_per_block: Any = 1
    # SDXL micro-conditioning: "text_time" feeds [pooled text || sinusoidal
    # embeddings of the size ids] through add_embedding into the time embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    # add_embedding's input width (pooled_dim + n_ids * addition_time_embed_dim);
    # a mismatch in forward is an error. SDXL: 2816, the refiner: 2560
    projection_class_embeddings_input_dim: Optional[int] = None
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0


# ---------------------------------------------------------------------------- helpers


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding), fp32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in fp32 and cast back (bf16-safe). Calls the aten op
    directly: ``F.group_norm`` refuses groups holding a single value, which the hint
    encoder's deepest stage produces for small guides."""

    def forward(self, x):
        y = torch.group_norm(x.float(), self.num_groups, self.weight.float(),
                             self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 and cast back."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major over (h, w) like the JAX NHWC reshape."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _tp_sum(out: torch.Tensor, group) -> torch.Tensor:
    """Complete a row-parallel projection: the fp32 sum of the ranks' partial outputs
    (JAX ``psum`` over the model axis), back in the activation dtype."""
    total = out.to(torch.float32, copy=True)
    dist.all_reduce(total, dist.ReduceOp.SUM, group=group)
    return total.to(out.dtype)


def _fit(bias: Optional[torch.Tensor], batch: int, dtype) -> Optional[torch.Tensor]:
    """Per-image biases (batch n under the 2n CFG batch) tile to the block
    [uncond || cond] layout; batch-1 biases broadcast."""
    if bias is None:
        return None
    if bias.shape[0] != 1:
        bias = _match_batch(bias, batch)
    return bias.to(dtype)


# ---------------------------------------------------------------------------- blocks


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = conv3(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3(channels, channels, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    """One attention layer: adapter-free, folded (a ``FoldedBias``, JAX ``unet.py``
    :233-292) or threaded (an ``AdapterStack``, JAX :294-321). With ``tp_size`` > 1 it
    holds heads / tp_size heads and all-reduces its out projection over ``tp_group``."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, tp_size: int = 1,
                 tp_group=None):
        super().__init__()
        self.heads = heads // tp_size
        self.tp_size, self.tp_group = tp_size, tp_group
        inner = self.heads * dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, hidden, ctx=None, stack=None, lora_scale=1.0, backend="auto"):
        if isinstance(stack, AdapterStack):
            if self.tp_size > 1:
                raise ValueError(
                    "tensor-parallel serving supports folded adapter stacks only "
                    "(fold_adapters runs before the params shard); got an unfolded "
                    "AdapterStack — pre/post chains cannot shard by heads")
            return self._threaded(hidden, ctx, stack, lora_scale, backend)
        out = self._projected(hidden, ctx, stack, backend)
        return _tp_sum(out, self.tp_group) if self.tp_size > 1 else out

    def _projected(self, hidden, ctx, bias, backend):
        q = self.to_q(hidden)
        ctx_in = hidden if ctx is None else ctx
        k = self.to_k(ctx_in)
        v = self.to_v(ctx_in)
        if bias is None:
            attn = dot_product_attention(q, k, v, self.heads, backend)
            return self.to_out[0](attn)
        b_h, L = hidden.shape[:2]
        if ctx is None and use_flash(L, L, q.device, backend):
            from controllora_tpu_torch.ops.flash_attention import biased_attention

            # K1 tiles the bias batch over the CFG batch inside the kernel
            attn = biased_attention(
                q, k, v, self.heads,
                *(None if t is None else t.to(q.dtype).contiguous()
                  for t in (bias.q_bias, bias.k_bias, bias.v_bias)),
            )
        else:
            if bias.q_bias is not None:
                q = q + _fit(bias.q_bias, b_h, q.dtype)
            if bias.k_bias is not None:
                k = k + _fit(bias.k_bias, b_h, k.dtype)
            if bias.v_bias is not None:
                v = v + _fit(bias.v_bias, b_h, v.dtype)
            attn = dot_product_attention(q, k, v, self.heads, backend)
        out = self.to_out[0](attn)
        if bias.out_bias is not None:
            out = out + _fit(bias.out_bias, b_h, out.dtype)
        return out

    def _threaded(self, hidden, ctx, stack: AdapterStack, scale, backend):
        hidden = adapt_hidden_pre_q(stack, hidden, scale)
        q = adapt_query(stack, self.to_q(hidden), hidden, scale)
        ctx_in = hidden if ctx is None else ctx
        k = adapt_key(stack, self.to_k(ctx_in), ctx_in, scale)
        v = adapt_value(stack, self.to_v(ctx_in), ctx_in, scale)
        attn = dot_product_attention(q, k, v, self.heads, backend)
        attn = adapt_hidden_post_attn(stack, attn, scale)
        return adapt_output(stack, self.to_out[0](attn), attn, scale)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate.float(), approximate="none").to(a.dtype)


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.1`` is diffusers' (parameter-free) dropout slot. With
    ``tp_size`` > 1: the rank's 1/tp_size of the inner features, ``net.2``'s partial
    output all-reduced over ``tp_group``."""

    def __init__(self, dim: int, mult: int = 4, tp_size: int = 1, tp_group=None):
        super().__init__()
        inner = dim * mult // tp_size
        self.tp_size, self.tp_group = tp_size, tp_group
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        out = self.net[2](self.net[0](x))
        return _tp_sum(out, self.tp_group) if self.tp_size > 1 else out


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int,
                 proc_prefix: str, tp_size: int = 1, tp_group=None):
        super().__init__()
        tp = dict(tp_size=tp_size, tp_group=tp_group)
        self.proc_prefix = proc_prefix
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, **tp)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim, **tp)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, **tp)

    def forward(self, x, ctx, stacks=None, lora_scale=1.0, tome=None, choice=None,
                grid=None, backend="auto"):
        def stack_for(attn):
            return stacks.get(f"{self.proc_prefix}.{attn}.processor") if stacks else None

        h = self.norm1(x)
        if tome is not None:
            # tomesd's placement: match on the block input, attend over the merged
            # tokens, unmerge before the residual add
            merge, unmerge, _ = tome_ops.build_merge(x, grid[0], grid[1], tome, choice)
            stack1 = _merge_stack_tokens(stack_for("attn1"), merge, x.shape[0])
            x = x + unmerge(self.attn1(merge(h), None, stack1, lora_scale, backend))
        else:
            x = x + self.attn1(h, None, stack_for("attn1"), lora_scale, backend)
        x = x + self.attn2(self.norm2(x), ctx, stack_for("attn2"), lora_scale, backend)
        return x + self.ff(self.norm3(x))


def _merge_stack_tokens(stack, merge, b_h: int):
    """A ToMe merge map applied to every per-token tensor riding a layer's adapters
    (JAX ``unet.py`` :348-382): the per-position biases of a folded layer, or the
    control states the adapters of a threaded ``AdapterStack`` carry (main, pre and
    post). Merging is linear, so it commutes with the adapter math. Per-image tensors
    (batch n under the 2n CFG batch) tile first; batch-1 ones broadcast."""
    if stack is None:
        return None

    def fit(t):
        return None if t is None else merge(_match_batch(t, b_h) if t.shape[0] != 1 else t)

    if isinstance(stack, FoldedBias):
        return FoldedBias(fit(stack.q_bias), fit(stack.k_bias), fit(stack.v_bias),
                          fit(stack.out_bias))
    return map_controls(stack, fit)


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, cross_attention_dim: int,
                 depth: int, groups: int, proc_prefix: str, linear_projection: bool = False,
                 tp_size: int = 1, tp_group=None):
        super().__init__()
        inner = heads * dim_head
        self.proc_prefix = proc_prefix
        self.linear_projection = linear_projection
        self.norm = GroupNorm(groups, channels, 1e-6)
        # SD2.x/SDXL: Linear on the tokens (a 2-D weight); SD1.x: a 1x1 conv
        self.proj_in = (nn.Linear(channels, inner) if linear_projection
                        else nn.Conv2d(channels, inner, 1))
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  f"{proc_prefix}.transformer_blocks.{i}", tp_size,
                                  tp_group)
            for i in range(depth)
        ])
        self.proj_out = (nn.Linear(inner, channels) if linear_projection
                         else nn.Conv2d(inner, channels, 1))

    def forward(self, x, ctx, stacks=None, lora_scale=1.0, tome=None, tome_step=None,
                backend="auto"):
        """``tome``: a ToMeConfig, applied where ``maybe_tome`` admits this grid;
        ``tome_step``: (seed, timestep, index) of the denoising step, which with the
        processor prefix and the block index seeds ``window_choice``."""
        _, _, hh, ww = x.shape
        residual = x
        if self.linear_projection:
            h = self.proj_in(to_tokens(self.norm(x)))
        else:
            h = to_tokens(self.proj_in(self.norm(x)))
        block_tome = tome if tome_ops.maybe_tome(tome, hh, ww) else None
        for i, block in enumerate(self.transformer_blocks):
            choice = None
            if block_tome is not None:
                # looked up on the module at call time, so a test can substitute the
                # JAX package's draws
                choice = tome_ops.window_choice(*tome_step, self.proc_prefix, i,
                                                hh // tome_ops.WINDOW, ww // tome_ops.WINDOW)
            h = block(h, ctx, stacks, lora_scale, block_tome, choice, (hh, ww), backend)
        if self.linear_projection:
            return from_tokens(self.proj_out(h), hh, ww) + residual
        return self.proj_out(from_tokens(h, hh, ww)) + residual


class _Block(nn.Module):
    """A down/up block: resnets, optional attentions, optional resampler (diffusers
    key layout ``resnets.i``, ``attentions.i``, ``downsamplers.0``/``upsamplers.0``)."""

    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def attention(self, i):
        return self.attentions[i] if hasattr(self, "attentions") else None


def _per_block(value, n: int) -> Tuple[int, ...]:
    return tuple(value) if isinstance(value, (tuple, list)) else (value,) * n


# ---------------------------------------------------------------------------- UNet


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(), tp_size: int = 1, tp_group=None):
        """``tp_size`` > 1: a tensor-parallel instance, the transformer blocks' slice of
        one rank of the 'model' axis, all-reducing over ``tp_group``."""
        super().__init__()
        self.config = cfg = config
        self.tp_size = tp_size
        n = len(cfg.block_out_channels)
        heads = _per_block(cfg.attention_head_dim, n)
        depths = _per_block(cfg.transformer_layers_per_block, n)
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        groups, eps, xdim = cfg.norm_num_groups, cfg.norm_eps, cfg.cross_attention_dim

        def transformer(ch, bi, prefix):
            return Transformer2DModel(ch, heads[bi], ch // heads[bi], xdim, depths[bi],
                                      groups, prefix, cfg.use_linear_projection, tp_size,
                                      tp_group)

        self.conv_in = conv3(cfg.in_channels, ch0)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch0, temb_dim)
        self.time_embedding.linear_2 = nn.Linear(temb_dim, temb_dim)
        if cfg.addition_embed_type == "text_time":
            if cfg.projection_class_embeddings_input_dim is None:
                raise ValueError("addition_embed_type='text_time' needs "
                                 "projection_class_embeddings_input_dim")
            self.add_embedding = nn.Module()
            self.add_embedding.linear_1 = nn.Linear(
                cfg.projection_class_embeddings_input_dim, temb_dim)
            self.add_embedding.linear_2 = nn.Linear(temb_dim, temb_dim)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"unknown addition_embed_type {cfg.addition_embed_type!r}")

        self.down_blocks = nn.ModuleList()
        out_ch = ch0
        skip_channels = [ch0]
        for bi, btype in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[bi]
            resnets, attns = [], []
            for li in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(in_ch if li == 0 else out_ch, out_ch,
                                             temb_dim, groups, eps))
                if btype == "CrossAttnDownBlock2D":
                    attns.append(transformer(out_ch, bi, f"down_blocks.{bi}.attentions.{li}"))
                skip_channels.append(out_ch)
            final = bi == n - 1
            self.down_blocks.append(_Block(resnets, attns,
                                           None if final else Downsample2D(out_ch)))
            if not final:
                skip_channels.append(out_ch)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid_ch, mid_ch, temb_dim, groups, eps),
             ResnetBlock2D(mid_ch, mid_ch, temb_dim, groups, eps)],
            [transformer(mid_ch, n - 1, "mid_block.attentions.0")],
        )

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        h_ch = mid_ch
        for bi, btype in enumerate(cfg.up_block_types):
            out_ch = rev[bi]
            resnets, attns = [], []
            for li in range(cfg.layers_per_block + 1):
                cat_ch = h_ch + skip_channels.pop()
                resnets.append(ResnetBlock2D(cat_ch, out_ch, temb_dim, groups, eps))
                h_ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(transformer(out_ch, n - 1 - bi,
                                             f"up_blocks.{bi}.attentions.{li}"))
            final = bi == n - 1
            self.up_blocks.append(_Block(resnets, attns,
                                         upsample=None if final else Upsample2D(out_ch)))

        self.conv_norm_out = GroupNorm(groups, ch0, eps)
        self.conv_out = conv3(ch0, cfg.out_channels)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                biases: Optional[Dict[str, Any]] = None,
                adapters: Optional[Dict[str, AdapterStack]] = None,
                lora_scale: float = 1.0,
                remat: Optional[Callable[..., torch.Tensor]] = None,
                tome: Optional[tome_ops.ToMeConfig] = None,
                tome_step: Optional[Tuple[int, Any, int]] = None,
                deepcache: Optional[str] = None,
                deepcache_feat: Optional[torch.Tensor] = None,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None,
                attention_backend: str = "auto"):
        """sample (B, 4, H, W) NCHW, timesteps (B,) or scalar, context (B, 77, D);
        ``biases``: {processor name: FoldedBias} of the folded adapters, or
        ``adapters``: {processor name: AdapterStack} threaded at ``lora_scale``; at
        most one of the two. ``remat(layer, *inputs)``, when given, runs each resnet
        and each attention block (the trainer passes a ``torch.utils.checkpoint``
        wrapper, so that the backward recomputes one block at a time). Returns the
        fp32 model output (B, 4, H, W).

        ``tome``: token merging (``ops/tome.py``) in the self-attentions whose grid
        ``maybe_tome`` admits; ``tome_step`` (seed, timestep, index) of the denoising
        step seeds the window draws and is required with ``tome``.

        ``deepcache`` (DeepCache, Ma et al. 2023): "full" also returns the feature
        entering the last up block, as ``(eps, cache)``; "shallow" skips everything
        below level 0 (down blocks 1.., mid, up blocks ..-2) and takes
        ``deepcache_feat`` for that feature. The shallow path runs exactly the level-0
        modules of the full path, so ``shallow(cache_of(full(x))) == full(x)``.

        ``added_text_embeds`` (B, pooled_dim) and ``added_time_ids`` (B, n_ids): the
        ``text_time`` conditioning, required by such a UNet (SDXL: 6 size ids, the
        refiner: 5). ``attention_backend``: ``dot_product_attention``'s ``backend``
        for every attention of the eval (``"xla"``: the plain versions only)."""
        if biases is not None and adapters is not None:
            raise ValueError("pass folded `biases` or threaded `adapters`, not both")
        if deepcache not in (None, "full", "shallow"):
            raise ValueError(f"deepcache must be None|'full'|'shallow', got {deepcache!r}")
        if tome is not None and tome_step is None:
            raise ValueError("tome requires tome_step=(seed, timestep, index)")
        shallow = deepcache == "shallow"
        if shallow and deepcache_feat is None:
            raise ValueError("deepcache='shallow' requires deepcache_feat")
        stacks = adapters if adapters is not None else biases
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(t_emb)))
        if cfg.addition_embed_type == "text_time":
            temb = temb + self._text_time(added_text_embeds, added_time_ids, dtype)
        ctx = encoder_hidden_states.to(dtype)

        def run(layer, *inputs):
            return layer(*inputs) if remat is None else remat(layer, *inputs)

        attn_args = (ctx, stacks, lora_scale, tome, tome_step, attention_backend)
        h = self.conv_in(sample.to(dtype))
        skips: List[torch.Tensor] = [h]
        for bi, block in enumerate(self.down_blocks):
            if shallow and bi > 0:
                break  # the deep levels come from the cache
            for li, resnet in enumerate(block.resnets):
                h = run(resnet, h, temb)
                attn = block.attention(li)
                if attn is not None:
                    h = run(attn, h, *attn_args)
                skips.append(h)
            if hasattr(block, "downsamplers") and not shallow:
                h = block.downsamplers[0](h)
                skips.append(h)

        if not shallow:
            h = run(self.mid_block.resnets[0], h, temb)
            h = run(self.mid_block.attentions[0], h, *attn_args)
            h = run(self.mid_block.resnets[1], h, temb)

        cache = None
        last = len(self.up_blocks) - 1
        for bi, block in enumerate(self.up_blocks):
            if shallow and bi < last:
                continue
            if bi == last:
                if shallow:
                    h = deepcache_feat.to(dtype)
                elif deepcache == "full":
                    cache = h
            for li, resnet in enumerate(block.resnets):
                h = run(resnet, torch.cat([h, skips.pop()], dim=1), temb)
                attn = block.attention(li)
                if attn is not None:
                    h = run(attn, h, *attn_args)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h))).float()
        return (h, cache) if deepcache == "full" else h

    def _text_time(self, pooled, time_ids, dtype):
        """SDXL micro-conditioning (JAX ``unet.py`` :575-608): each size id gets the
        timestep's sinusoidal embedding, flattened after the pooled text vector
        (fp32), then add_embedding maps it into the time embedding."""
        cfg = self.config
        if pooled is None or time_ids is None:
            raise ValueError("addition_embed_type='text_time' requires added_text_embeds "
                             "(pooled text, (B, pooled_dim)) and added_time_ids ((B, n_ids))")
        b = time_ids.shape[0]
        id_emb = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                    cfg.flip_sin_to_cos, cfg.freq_shift).reshape(b, -1)
        aug = torch.cat([pooled.float(), id_emb], dim=-1)
        want = cfg.projection_class_embeddings_input_dim
        if aug.shape[-1] != want:
            raise ValueError(
                f"text_time embedding input is {aug.shape[-1]}-d (pooled {pooled.shape[-1]} "
                f"+ {time_ids.shape[-1]}*{cfg.addition_time_embed_dim}) but "
                f"projection_class_embeddings_input_dim={want}")
        emb = self.add_embedding
        return emb.linear_2(F.silu(emb.linear_1(aug.to(dtype))))


def deepcache_feat_shape(config: UNetConfig, batch: int, lh: int, lw: int) -> Tuple[int, ...]:
    """Shape of the DeepCache feature, the input of the last up block: (batch, the
    second block width, lh, lw), NCHW (the JAX package's is the NHWC (batch, lh, lw,
    width))."""
    chans = config.block_out_channels
    return (batch, chans[1] if len(chans) > 1 else chans[0], lh, lw)


# ------------------------------------------------------------------ processor inventory


def attention_processor_names(config: UNetConfig = UNetConfig()) -> List[str]:
    """Diffusers processor names in ``unet.attn_processors`` order (down, mid, up;
    attn1 then attn2 per transformer block)."""
    depths = _per_block(config.transformer_layers_per_block, len(config.block_out_channels))
    names = []
    for bi, btype in enumerate(config.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for li in range(config.layers_per_block):
                for ti in range(depths[bi]):
                    for a in ("attn1", "attn2"):
                        names.append(f"down_blocks.{bi}.attentions.{li}"
                                     f".transformer_blocks.{ti}.{a}.processor")
    for ti in range(depths[-1]):
        for a in ("attn1", "attn2"):
            names.append(f"mid_block.attentions.0.transformer_blocks.{ti}.{a}.processor")
    rev_depths = list(reversed(depths))
    for bi, btype in enumerate(config.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for li in range(config.layers_per_block + 1):
                for ti in range(rev_depths[bi]):
                    for a in ("attn1", "attn2"):
                        names.append(f"up_blocks.{bi}.attentions.{li}"
                                     f".transformer_blocks.{ti}.{a}.processor")
    return names


def processor_bucket(name: str, n_blocks: int) -> int:
    """Resolution bucket (control_id) of a processor name."""
    if name.startswith("mid_block"):
        return n_blocks - 1
    if name.startswith("up_blocks"):
        block_id = int(name[len("up_blocks."):].split(".")[0])
        return n_blocks - 1 - block_id
    if name.startswith("down_blocks"):
        return int(name[len("down_blocks."):].split(".")[0])
    raise ValueError(name)


def processor_cross_dim(name: str, config: UNetConfig = UNetConfig()) -> Optional[int]:
    return None if ".attn1." in name else config.cross_attention_dim


def processor_hidden_size(name: str, config: UNetConfig = UNetConfig()) -> int:
    """Channel width at a processor's location."""
    if name.startswith("mid_block"):
        return config.block_out_channels[-1]
    if name.startswith("down_blocks"):
        return config.block_out_channels[int(name[len("down_blocks."):].split(".")[0])]
    bi = int(name[len("up_blocks."):].split(".")[0])
    return list(reversed(config.block_out_channels))[bi]


def derive_cross_attention_dims(config: UNetConfig = UNetConfig()):
    """Per-bucket ``lora_cross_attention_dims`` matching this UNet exactly."""
    n_blocks = len(config.block_out_channels)
    buckets = [[] for _ in range(n_blocks)]
    for name in attention_processor_names(config):
        buckets[processor_bucket(name, n_blocks)].append(processor_cross_dim(name, config))
    return tuple(tuple(b) for b in buckets)
