"""Multi-head attention primitive (counterpart of ``controllora_tpu/ops/attention.py``).

The default path is plain ``torch.matmul`` with fp32 logits and softmax, as the JAX
package computes it outside any kernel. ``backend`` takes the JAX names and rules
(``_use_flash``): ``"flash"`` and ``"flash_stock"`` take the flash route on any
device, ``"xla"`` never does, and ``"auto"`` takes it for long self-attention on a
CUDA tensor (q_len == kv_len >= 2048). The flash route runs the hand-written kernels
through ``FlashAttention`` (``ops/flash_attention.py``: K2 forward, K3 + K4
backward), or through ``stock_flash_attention`` (``ops/flash_stock.py``: K5, jax's
stock TPU flash ported) when the backend is ``"flash_stock"`` or the environment sets
``CONTROLLORA_FLASH_IMPL=stock``, read at call time as the JAX package reads it.
Either way gradients flow through it, as through the JAX ``custom_vjp``.
"""

from __future__ import annotations

import os

import torch

FLASH_MIN_LEN = 2048
BACKENDS = ("auto", "xla", "flash", "flash_stock")


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, heads, L, D)."""
    b, l, hd = x.shape
    return x.reshape(b, l, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, D) -> (B, L, H*D)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def tile_batch(x: torch.Tensor, b: int) -> torch.Tensor:
    """TILE a batch-n tensor to batch b: row i pairs with rows i, n + i, ... of the
    block [u1..un || c1..cn] CFG layout (never interleave)."""
    if x.shape[0] != b:
        x = x.repeat((b // x.shape[0],) + (1,) * (x.dim() - 1))
    return x


def use_flash(q_len: int, kv_len: int, device: torch.device, backend: str = "auto") -> bool:
    """Long self-attention on the card takes the flash kernel; cross attention
    (kv = 77) and short sequences stay on the matmul path. ``"flash"`` and
    ``"flash_stock"`` force the flash route, ``"xla"`` refuses it."""
    if backend in ("flash", "flash_stock"):
        return True
    if backend != "auto":
        return False
    return device.type == "cuda" and q_len == kv_len and q_len >= FLASH_MIN_LEN


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    heads: int,
    backend: str = "auto",
) -> torch.Tensor:
    """Attention over (B, L, inner) projections; returns (B, Lq, inner) in
    query.dtype. Logits and softmax are fp32 whatever the input dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known: {BACKENDS}")
    q = split_heads(query, heads)
    k = split_heads(key, heads)
    v = split_heads(value, heads)
    scale = q.shape[-1] ** -0.5
    if use_flash(query.shape[1], key.shape[1], query.device, backend):
        if backend == "flash_stock" or os.environ.get("CONTROLLORA_FLASH_IMPL") == "stock":
            from controllora_tpu_torch.ops.flash_stock import stock_flash_attention

            return merge_heads(stock_flash_attention(q, k, v, scale)).to(query.dtype)
        from controllora_tpu_torch.ops.flash_attention import FlashAttention

        return FlashAttention.apply(query, key, value, heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return merge_heads(out).to(query.dtype)
