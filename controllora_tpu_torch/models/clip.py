"""CLIP text encoders in PyTorch (counterpart of ``controllora_tpu/models/clip.py``):
SD1.5's ViT-L/14, SD2.x's OpenCLIP ViT-H (gelu MLPs), and SDXL's towers, read at
their penultimate layer, the second with an EOS-pooled projection; SDXL's
``DualCLIPTextEncoder`` concatenates the two.

Parameter names follow transformers' CLIPTextModel (``text_model.encoder.layers.i``)
and CLIPTextModelWithProjection (``text_projection``, outside ``text_model``), the
layout ``utils/torch_compat.flax_to_torch_clip`` writes; the dual encoder holds its
towers as ``te1`` and ``te2``, the JAX tree's names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.models.unet import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # "quick_gelu" (SD1.x CLIP ViT-L) or "gelu" (OpenCLIP towers of SD2.x and SDXL)
    hidden_act: str = "quick_gelu"
    # SDXL: the context is the hidden state entering the last layer (no final norm)
    penultimate: bool = False
    # OpenCLIP pooled head (SDXL text_encoder_2): the final-normed EOS token through a
    # bias-free Linear(hidden, projection_dim); forward then returns (context, pooled)
    projection_dim: Optional[int] = None


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return lambda x: F.gelu(x.float(), approximate="none").to(x.dtype)
    raise ValueError(f"unknown hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, causal_mask):
        b, l, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)

        q = self.q_proj(x) * hd**-0.5
        logits = torch.matmul(split(q).float(), split(self.k_proj(x)).float().transpose(-1, -2))
        probs = torch.softmax(logits + causal_mask, dim=-1)
        v = split(self.v_proj(x))
        out = torch.matmul(probs.to(v.dtype), v).transpose(1, 2).reshape(b, l, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = cfg = config
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                                        cfg.hidden_size)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                           for _ in range(cfg.num_layers)])
        tm.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        """(B, 77) token ids -> (B, 77, hidden) context, fp32: the last hidden state
        after the final norm, or with ``penultimate`` the one entering the last
        layer. With ``projection_dim``: (context, (B, projection_dim) pooled fp32)."""
        cfg, tm = self.config, self.text_model
        b, l = input_ids.shape
        pos = torch.arange(l, device=input_ids.device)[None]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        causal_mask = torch.triu(
            torch.full((l, l), -1e9, dtype=torch.float32, device=input_ids.device), 1)
        ctx = None
        for i, layer in enumerate(tm.encoder.layers):
            if cfg.penultimate and i == cfg.num_layers - 1:
                ctx = x.float()
                if cfg.projection_dim is None:
                    return ctx  # nothing reads the last layer
            x = layer(x, causal_mask)
        x = tm.final_layer_norm(x.float())
        ctx = x if ctx is None else ctx
        if cfg.projection_dim is None:
            return ctx
        # EOS pooling: EOS is the highest id of the CLIP vocab, so the argmax is its
        # first position (transformers' CLIPTextModelWithProjection)
        eos = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos].to(self.text_projection.weight.dtype)
        return ctx, self.text_projection(pooled).float()


class DualCLIPTextEncoder(nn.Module):
    """SDXL's two towers (JAX ``clip.py`` :112-190): CLIP ViT-L and OpenCLIP
    ViT-bigG, both read at their penultimate layer and concatenated into the
    (B, 77, 768 + 1280 = 2048) context; tower 2's EOS-pooled projection is the
    ``text_time`` vector. Tower 2's ids pad with 0 where tower 1's pad with EOS
    (SDXL's tokenizer_2), and the pad positions reach the context, so the pipeline
    passes both; ``input_ids2`` defaults to ``input_ids``. ``config`` is the pair
    (tower 1's, tower 2's)."""

    def __init__(self, config: Tuple[CLIPTextConfig, CLIPTextConfig]):
        super().__init__()
        self.config = config
        config1, config2 = config
        if config2.projection_dim is None:
            raise ValueError("the dual encoder's second tower needs projection_dim")
        self.te1 = CLIPTextModel(config1)
        self.te2 = CLIPTextModel(config2)

    @property
    def context_dim(self) -> int:
        return self.te1.config.hidden_size + self.te2.config.hidden_size

    @property
    def pooled_dim(self) -> int:
        return self.te2.config.projection_dim

    def forward(self, input_ids: torch.Tensor, input_ids2: Optional[torch.Tensor] = None):
        """(B, 77) ids [+ tower 2's ids] -> ((B, 77, h1 + h2) context, (B, proj)
        pooled), fp32."""
        c1 = self.te1(input_ids)
        c2, pooled = self.te2(input_ids if input_ids2 is None else input_ids2)
        return torch.cat([c1, c2], dim=-1), pooled
