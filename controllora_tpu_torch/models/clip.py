"""CLIP ViT-L/14 text encoder in PyTorch (counterpart of ``controllora_tpu/models/clip.py``).

Parameter names follow transformers' CLIPTextModel (``text_model.encoder.layers.i``),
the layout ``utils/torch_compat.flax_to_torch_clip`` writes. The SDXL dual tower
and pooled projection are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
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


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


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
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


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

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, hidden) last hidden state, fp32."""
        tm = self.text_model
        b, l = input_ids.shape
        pos = torch.arange(l, device=input_ids.device)[None]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        causal_mask = torch.triu(
            torch.full((l, l), -1e9, dtype=torch.float32, device=input_ids.device), 1)
        for layer in tm.encoder.layers:
            x = layer(x, causal_mask)
        return tm.final_layer_norm(x.float())
