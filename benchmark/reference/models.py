"""Plain PyTorch Stable Diffusion stack with a ControlLoRA, the benchmark's reference.

It restates the published architectures (diffusers' UNet2DConditionModel,
AutoencoderKL, transformers' CLIPTextModel and the ControlLoRA reference processors)
in plain ``torch`` operations, computed in the parameters' dtype (float32 for the
reference), with every attention as two matmuls and a softmax. It imports nothing of
the system under test: the harness hands both sides the same seeded weights by
parameter name, and the names follow diffusers' and transformers' state-dict keys.

The ControlLoRA adapters run threaded, as the reference processors define them (the
v1 processor with ``lora_control_self_add`` off, no ``post_add``, no
``concat_hidden``): the hint encoder turns the guide into one control state a bucket,
and each attention layer adds ``s * lora(to_q, h + s * lora(to_control, c))`` to its
query and ``s * lora(to_{k,v,out}, .)`` to its key, value and output projections.
Serving folds these into weights and biases; the fold is an identity of this math.

Configurations are plain dicts with the ``configs/*.json`` keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _per_block(value, n: int) -> Tuple[int, ...]:
    return tuple(value) if isinstance(value, (tuple, list)) else (value,) * n


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


def tile(x: torch.Tensor, b: int) -> torch.Tensor:
    """A per-image tensor (batch n) under the CFG batch [u1..un || c1..cn] (batch 2n)."""
    return x if x.shape[0] == b else x.repeat((b // x.shape[0],) + (1,) * (x.dim() - 1))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, L, heads * d) projections."""
    b, lq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    probs = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2)) * d ** -0.5,
                          dim=-1)
    return torch.matmul(probs, split(v)).transpose(1, 2).reshape(b, lq, inner)


def conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


# ---------------------------------------------------------------------------- UNet


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = conv3(cin, cout)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, cross: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(cross or dim, dim, bias=False)
        self.to_v = nn.Linear(cross or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, h, ctx=None, adapter=None, scale: float = 1.0):
        kv_in = h if ctx is None else ctx
        q, k, v = self.to_q(h), self.to_k(kv_in), self.to_v(kv_in)
        if adapter is not None:
            lora, control = adapter
            c = tile(control, h.shape[0])
            q_in = h + scale * lora["to_control"](c)
            q = q + scale * lora["to_q"](q_in)
            k = k + scale * lora["to_k"](kv_in)
            v = v + scale * lora["to_v"](kv_in)
        a = attention(q, k, v, self.heads)
        out = self.to_out[0](a)
        if adapter is not None:
            out = out + scale * adapter[0]["to_out"](a)
        return out


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross: int, name: str):
        super().__init__()
        self.name = name
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, cross)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x, ctx, adapters, scale):
        def adapter(which):
            return adapters.get(f"{self.name}.{which}.processor") if adapters else None

        x = x + self.attn1(self.norm1(x), None, adapter("attn1"), scale)
        x = x + self.attn2(self.norm2(x), ctx, adapter("attn2"), scale)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, cross: int, depth: int, groups: int, name: str,
                 linear: bool):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, ch, 1e-6)
        self.proj_in = nn.Linear(ch, ch) if linear else nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(ch, heads, cross, f"{name}.transformer_blocks.{i}")
            for i in range(depth)])
        self.proj_out = nn.Linear(ch, ch) if linear else nn.Conv2d(ch, ch, 1)

    def forward(self, x, ctx, adapters, scale):
        _, _, hh, ww = x.shape
        if self.linear:
            h = self.proj_in(to_tokens(self.norm(x)))
        else:
            h = to_tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            h = block(h, ctx, adapters, scale)
        if self.linear:
            return from_tokens(self.proj_out(h), hh, ww) + x
        return self.proj_out(from_tokens(h, hh, ww)) + x


class Block(nn.Module):
    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])

    def attention(self, i):
        return self.attentions[i] if hasattr(self, "attentions") else None


class Resample(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = conv3(ch, ch, stride)


class UNet(nn.Module):
    """diffusers UNet2DConditionModel (SD1.x, SD2.x, SDXL layouts)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        chans = cfg["block_out_channels"]
        n = len(chans)
        heads = _per_block(cfg["attention_head_dim"], n)
        depths = _per_block(cfg["transformer_layers_per_block"], n)
        ch0, temb = chans[0], chans[0] * 4
        groups, eps, cross = cfg["norm_num_groups"], cfg["norm_eps"], cfg["cross_attention_dim"]
        linear = cfg["use_linear_projection"]

        def transformer(ch, bi, name):
            return Transformer2D(ch, heads[bi], cross, depths[bi], groups, name, linear)

        self.conv_in = conv3(cfg["in_channels"], ch0)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch0, temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        if cfg["addition_embed_type"] == "text_time":
            self.add_embedding = nn.Module()
            self.add_embedding.linear_1 = nn.Linear(cfg["projection_class_embeddings_input_dim"],
                                                    temb)
            self.add_embedding.linear_2 = nn.Linear(temb, temb)
        self.down_blocks = nn.ModuleList()
        out = ch0
        skips = [ch0]
        for bi, kind in enumerate(cfg["down_block_types"]):
            cin, out = out, chans[bi]
            resnets, attns = [], []
            for li in range(cfg["layers_per_block"]):
                resnets.append(Resnet(cin if li == 0 else out, out, temb, groups, eps))
                if kind == "CrossAttnDownBlock2D":
                    attns.append(transformer(out, bi, f"down_blocks.{bi}.attentions.{li}"))
                skips.append(out)
            last = bi == n - 1
            self.down_blocks.append(Block(resnets, attns, None if last else Resample(out, 2)))
            if not last:
                skips.append(out)
        mid = chans[-1]
        self.mid_block = Block([Resnet(mid, mid, temb, groups, eps),
                                Resnet(mid, mid, temb, groups, eps)],
                               [transformer(mid, n - 1, "mid_block.attentions.0")])
        self.up_blocks = nn.ModuleList()
        h_ch = mid
        for bi, kind in enumerate(cfg["up_block_types"]):
            out = list(reversed(chans))[bi]
            resnets, attns = [], []
            for li in range(cfg["layers_per_block"] + 1):
                resnets.append(Resnet(h_ch + skips.pop(), out, temb, groups, eps))
                h_ch = out
                if kind == "CrossAttnUpBlock2D":
                    attns.append(transformer(out, n - 1 - bi, f"up_blocks.{bi}.attentions.{li}"))
            last = bi == n - 1
            self.up_blocks.append(Block(resnets, attns, up=None if last else Resample(out, 1)))
        self.conv_norm_out = nn.GroupNorm(groups, ch0, eps)
        self.conv_out = conv3(ch0, cfg["out_channels"])

    def forward(self, x, t, ctx, adapters=None, scale: float = 1.0, text_embeds=None,
                time_ids=None):
        cfg = self.cfg
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(
            timestep_embedding(t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"],
                               cfg["freq_shift"]).to(x.dtype))))
        if cfg["addition_embed_type"] == "text_time":
            b = time_ids.shape[0]
            ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"],
                                     cfg["flip_sin_to_cos"], cfg["freq_shift"]).reshape(b, -1)
            aug = torch.cat([text_embeds, ids.to(text_embeds.dtype)], dim=-1)
            emb = self.add_embedding
            temb = temb + emb.linear_2(F.silu(emb.linear_1(aug)))
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            for li, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if block.attention(li) is not None:
                    h = block.attention(li)(h, ctx, adapters, scale)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx, adapters, scale)
        h = self.mid_block.resnets[1](h, temb)
        for block in self.up_blocks:
            for li, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if block.attention(li) is not None:
                    h = block.attention(li)(h, ctx, adapters, scale)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def processor_names(cfg: dict) -> List[str]:
    """The attention processors in diffusers' ``attn_processors`` order."""
    n = len(cfg["block_out_channels"])
    depths = _per_block(cfg["transformer_layers_per_block"], n)
    names = []

    def block(prefix, depth):
        for ti in range(depth):
            for a in ("attn1", "attn2"):
                names.append(f"{prefix}.transformer_blocks.{ti}.{a}.processor")

    for bi, kind in enumerate(cfg["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            for li in range(cfg["layers_per_block"]):
                block(f"down_blocks.{bi}.attentions.{li}", depths[bi])
    block("mid_block.attentions.0", depths[-1])
    for bi, kind in enumerate(cfg["up_block_types"]):
        if kind == "CrossAttnUpBlock2D":
            for li in range(cfg["layers_per_block"] + 1):
                block(f"up_blocks.{bi}.attentions.{li}", list(reversed(depths))[bi])
    return names


def processor_level(name: str, n_levels: int) -> int:
    """The resolution level (and ControlLoRA bucket) of a processor."""
    if name.startswith("mid_block"):
        return n_levels - 1
    index = int(name.split(".")[1])
    return index if name.startswith("down_blocks") else n_levels - 1 - index


# ---------------------------------------------------------------------------- VAE


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, 1e-6)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        _, _, hh, ww = x.shape
        h = to_tokens(self.group_norm(x))
        h = attention(self.query(h), self.key(h), self.value(h), 1)
        return x + from_tokens(self.proj_attn(h), hh, ww)


def _vae_resnet(cin, cout, groups):
    return Resnet(cin, cout, None, groups, 1e-6)


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        groups, chans = cfg["norm_num_groups"], cfg["block_out_channels"]
        ch = chans[0]
        self.conv_in = conv3(cfg["in_channels"], ch)
        self.down_blocks = nn.ModuleList()
        for bi, out in enumerate(chans):
            block = nn.Module()
            block.resnets = nn.ModuleList([_vae_resnet(ch if li == 0 else out, out, groups)
                                           for li in range(cfg["layers_per_block"])])
            ch = out
            if bi != len(chans) - 1:
                down = nn.Module()
                down.conv = nn.Conv2d(out, out, 3, stride=2)
                block.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(block)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([_vae_resnet(ch, ch, groups),
                                                _vae_resnet(ch, ch, groups)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch, groups)])
        self.conv_norm_out = nn.GroupNorm(groups, ch, 1e-6)
        self.conv_out = conv3(ch, 2 * cfg["latent_channels"])

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        groups, chans = cfg["norm_num_groups"], list(reversed(cfg["block_out_channels"]))
        ch = chans[0]
        self.conv_in = conv3(cfg["latent_channels"], ch)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([_vae_resnet(ch, ch, groups),
                                                _vae_resnet(ch, ch, groups)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch, groups)])
        self.up_blocks = nn.ModuleList()
        for bi, out in enumerate(chans):
            block = nn.Module()
            block.resnets = nn.ModuleList([_vae_resnet(ch if li == 0 else out, out, groups)
                                           for li in range(cfg["layers_per_block"] + 1)])
            ch = out
            if bi != len(chans) - 1:
                block.upsamplers = nn.ModuleList([Resample(out, 1)])
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(groups, ch, 1e-6)
        self.conv_out = conv3(ch, cfg["out_channels"])

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        latent = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * latent, 2 * latent, 1)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(latent, latent, 1)

    def encode(self, x, noise):
        """Scaled latents of a posterior sample mean + std * noise."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        return (mean + std * noise) * self.cfg["scaling_factor"]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.cfg["scaling_factor"]))


# ---------------------------------------------------------------------------- CLIP


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.gelu = cfg["hidden_act"]
        self.heads = cfg["num_heads"]
        self.layer_norm1 = nn.LayerNorm(d, eps)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d, eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg["intermediate_size"])
        self.mlp.fc2 = nn.Linear(cfg["intermediate_size"], d)

    def forward(self, x, mask):
        a = self.self_attn
        h = self.layer_norm1(x)
        b, l, d = h.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)

        logits = torch.matmul(split(a.q_proj(h) * hd ** -0.5), split(a.k_proj(h)).transpose(-1, -2))
        o = torch.matmul(torch.softmax(logits + mask, dim=-1), split(a.v_proj(h)))
        x = x + a.out_proj(o.transpose(1, 2).reshape(b, l, d))
        m = self.mlp.fc1(self.layer_norm2(x))
        m = m * torch.sigmoid(1.702 * m) if self.gelu == "quick_gelu" else F.gelu(m)
        return x + self.mlp.fc2(m)


class CLIPText(nn.Module):
    """transformers CLIPTextModel(WithProjection); ``penultimate`` reads the hidden
    state entering the last layer; a projection head adds the EOS-pooled vector."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                                        cfg["hidden_size"])
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])
        if cfg["projection_dim"] is not None:
            self.text_projection = nn.Linear(cfg["hidden_size"], cfg["projection_dim"],
                                             bias=False)

    def forward(self, ids):
        cfg, tm = self.cfg, self.text_model
        b, l = ids.shape
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(l, device=ids.device))[None]
        mask = torch.triu(torch.full((l, l), -1e9, dtype=x.dtype, device=ids.device), 1)
        ctx = None
        for i, layer in enumerate(tm.encoder.layers):
            if cfg["penultimate"] and i == cfg["num_layers"] - 1:
                ctx = x
                if cfg["projection_dim"] is None:
                    return ctx, None
            x = layer(x, mask)
        x = tm.final_layer_norm(x)
        ctx = x if ctx is None else ctx
        if cfg["projection_dim"] is None:
            return ctx, None
        pooled = x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
        return ctx, self.text_projection(pooled)


class DualText(nn.Module):
    """SDXL's two towers ``te1`` and ``te2``: contexts concatenated, tower 2's pooled
    vector; tower 2 reads ids padded with 0."""

    def __init__(self, cfg):
        super().__init__()
        self.te1, self.te2 = CLIPText(cfg[0]), CLIPText(cfg[1])

    def forward(self, ids, ids_pad0):
        c1, _ = self.te1(ids)
        c2, pooled = self.te2(ids_pad0)
        return torch.cat([c1, c2], dim=-1), pooled


def text_encoder(cfg) -> nn.Module:
    """One tower (a dict) or SDXL's pair (a list of two)."""
    return DualText(cfg) if isinstance(cfg, (list, tuple)) else CLIPText(cfg)


def encode_text(encoder: nn.Module, ids: torch.Tensor, ids_pad0: torch.Tensor):
    """(context, pooled or None) of token ids (EOS padded) and the same ids 0 padded."""
    if isinstance(encoder, DualText):
        return encoder(ids, ids_pad0)
    return encoder(ids)


# ---------------------------------------------------------------------------- ControlLoRA


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(min(groups, cin), cin, 1e-6)
        self.conv1 = nn.Conv2d(cin, cout, k, padding=k // 2)
        self.norm2 = nn.GroupNorm(min(groups, cout), cout, 1e-6)

    def forward(self, x):
        return F.silu(self.norm2(self.conv1(F.silu(self.norm1(x)))))


class DownEncoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, k, groups, down):
        super().__init__()
        self.convnets = nn.ModuleList([ConvBlock(cin if i == 0 else cout, cout, k, groups)
                                       for i in range(layers)])
        if down:
            self.downsamplers = nn.ModuleList([nn.Module()])
            self.downsamplers[0].conv = nn.Conv2d(cout, cout, 3, stride=2)

    def forward(self, x):
        for block in self.convnets:
            x = block(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class LoRA(nn.Module):
    def __init__(self, cin: int, cout: int, rank: int):
        super().__init__()
        self.down = nn.Linear(cin, rank, bias=False)
        self.up = nn.Linear(rank, cout, bias=False)

    def forward(self, x):
        return self.up(self.down(x))


class ControlLoRA(nn.Module):
    """The hint encoder (conv_in, a /8 pyramid, a /2 block and a 1x1 block a bucket)
    and one adapter slot per UNet attention layer, bucket by bucket (ControlLoRA v1)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if (cfg["lora_control_version"] != 1 or cfg["lora_post_add"] or cfg["lora_concat_hidden"]
                or cfg["lora_pre_conv_skipped"] or cfg["lora_key_states_skipped"]
                or cfg["lora_value_states_skipped"] or cfg["lora_control_rank"] is not None):
            raise ValueError("the reference states the ControlLoRA v1 processor without "
                             "post_add, concat_hidden, skips or a control rank")
        self.cfg = cfg
        g, chans = cfg["norm_num_groups"], cfg["block_out_channels"]
        self.conv_in = conv3(cfg["in_channels"], chans[0])
        pyramid, ch = [], chans[0]
        for i, out in enumerate(chans):
            pyramid.append(DownEncoderBlock(ch, out, cfg["layers_per_block"], 3, g,
                                            i != len(chans) - 1))
            ch = out
        self.down_blocks = nn.ModuleList([nn.Sequential(*pyramid)])
        self.pre_lora_layers = nn.ModuleList()
        out_chans = cfg["lora_block_out_channels"]
        for i in range(len(out_chans)):
            if i > 0:
                out = cfg["lora_block_in_channels"][i]
                self.down_blocks.append(DownEncoderBlock(
                    ch, out, cfg["lora_pre_down_layers_per_block"], 3, g, True))
                ch = out
            control = cfg["lora_control_channels"][i] or out_chans[i]
            self.pre_lora_layers.append(DownEncoderBlock(
                ch, control, cfg["lora_pre_conv_layers_per_block"],
                cfg["lora_pre_conv_layers_kernel_size"], g, False))
        rank = cfg["lora_rank"]
        self.lora_layers = nn.ModuleList()
        for i, hidden in enumerate(out_chans):
            control = cfg["lora_control_channels"][i] or hidden
            slots = nn.ModuleList()
            for cross in cfg["lora_cross_attention_dims"][i]:
                slot = nn.Module()
                slot.to_q_lora = LoRA(hidden, hidden, rank)
                slot.to_k_lora = LoRA(cross or hidden, hidden, rank)
                slot.to_v_lora = LoRA(cross or hidden, hidden, rank)
                slot.to_out_lora = LoRA(hidden, hidden, rank)
                slot.to_control = LoRA(control, hidden, rank)
                slots.append(slot)
            self.lora_layers.append(slots)

    def controls(self, guide: torch.Tensor) -> List[torch.Tensor]:
        """Guide (B, 3, H, W) in [-1, 1] -> one (B, L_i, C_i) control state a bucket."""
        h = self.down_blocks[0](self.conv_in(guide))
        out = []
        for i in range(len(self.pre_lora_layers)):
            if i > 0:
                h = self.down_blocks[i](h)
            out.append(to_tokens(self.pre_lora_layers[i](h)))
        return out

    def adapters(self, controls: Sequence[torch.Tensor], unet_cfg: dict) -> Dict[str, tuple]:
        """{processor name: (LoRA modules by projection, control state)}: the slots of a
        bucket go to its attention layers in processor order."""
        n = len(unet_cfg["block_out_channels"])
        cursor = [0] * n
        out = {}
        for name in processor_names(unet_cfg):
            level = processor_level(name, n)
            slot = self.lora_layers[level][cursor[level]]
            cursor[level] += 1
            out[name] = ({"to_q": slot.to_q_lora, "to_k": slot.to_k_lora,
                          "to_v": slot.to_v_lora, "to_out": slot.to_out_lora,
                          "to_control": slot.to_control}, controls[level])
        return out
