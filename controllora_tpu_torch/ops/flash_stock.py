"""K5: jax's stock TPU flash attention on Hopper: wrappers, plain versions, autograd.

Counterpart of ``controllora_tpu/ops/attention.py::_flash_stock``, which runs jax's
bundled ``jax/experimental/pallas/ops/tpu/flash_attention.py``: the forward
(``_flash_attention_kernel``), dK/dV (``_flash_attention_dkv_kernel``) and dQ
(``_flash_attention_dq_kernel``), tied together by a ``custom_vjp``. Here:

  * ``stock_flash_fwd`` -> ``k5_stock_flash_fwd``: O and the residuals m (row max of
    the scaled logits) and l (the normalizer at that max), each (B, H, L) fp32;
  * ``stock_flash_bwd_dkv`` -> ``k5_stock_flash_bwd_dkv`` and ``stock_flash_bwd_dq``
    -> ``k5_stock_flash_bwd_dq``, from P = exp(S * scale - m) / l and
    di = rowsum(dO * O);
  * ``FlashStockAttention`` (``torch.autograd.Function``) ties them together, and
    ``stock_flash_attention`` is the entry point with ``_flash_stock``'s block rule.

On bf16 the forward runs on K1/K2's wgmma kernel (``csrc/flash_attn_fwd.cu``, which
writes m and l in place of LSE), the backward on K3's and K4's
(``csrc/flash_attn_bwd.cu``, which form LSE = m + log l as they read a row); on fp32
all three run on the fp32 kernels of K1-K4 (``csrc/flash_attn_fp32.cu``), which do the
same (``flash_attention.kernel_dtype`` picks the route). All take (B, H, L, D)
tensors by their strides, so the head-split views of the (B, L, H*D) projections go in
without a copy: they read them through TMA tensor maps (``head_geometry`` in bf16,
``vector_geometry`` in fp32, whose dQ kernel copies 16-byte units with ``cp.async``),
and write O, dQ by q's strides and dK, dV by k's.
The softmax scale is a runtime argument. Lengths are whole blocks: ``pick_block``
(copied from ``controllora_tpu/ops/pallas_attention.py``) picks the block as
``_flash_stock`` does, and the same exception types are raised where jax's kernel
refuses a shape.

Device rule: a tensor on the CPU takes the plain PyTorch version beside each kernel;
a CUDA tensor launches the kernel of its dtype or raises. ``LAUNCHES`` counts kernel
launches ("k5_fwd", "k5_dkv", "k5_dq") whatever the dtype, ``FP32_LAUNCHES`` those of
the fp32 route alone; only the CUDA branch of each wrapper increments them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from controllora_tpu_torch.ops.flash_attention import (BWD_LIMIT_REASON, MAX_BWD_HEAD_DIM,
                                                       MAX_HEAD_DIM, build_kernels,
                                                       count_launch, entry, head_geometry,
                                                       kernel_dtype, vector_geometry)

MIN_BLOCK_SIZE = 128  # the stock kernel's smallest block (jax NUM_LANES)

LAUNCHES: Dict[str, int] = {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}
FP32_LAUNCHES: Dict[str, int] = {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FP32_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------- shapes


def pick_block(length: int, cap: int = 1024,
               head_dim: Optional[int] = None) -> Optional[int]:
    """Largest power-of-two block (64..1024, at most ``cap``; at most 512 for heads
    wider than 256) that tiles ``length`` exactly, or None."""
    if head_dim is not None and head_dim > 256:
        cap = min(cap, 512)
    for b in (1024, 512, 256, 128, 64):
        if b <= cap and b <= length and length % b == 0:
            return b
    return None


def stock_block(q_len: int, kv_len: int, head_dim: int) -> int:
    """The block ``_flash_stock`` gives the stock kernel, with the checks of both:
    ValueError where no block tiles the length (``_flash_stock``) or the KV length
    (``_verify_block``). Where the KV loop takes more than one step, the stock kernel
    raises NotImplementedError for a block under 128 and for a head wider than 128
    that is not a multiple of 128; a single step takes both."""
    blk = pick_block(q_len, cap=512)
    if blk is None:
        raise ValueError(f"flash_stock backend needs a power-of-two-tileable length, "
                         f"got L={q_len}")
    if blk > kv_len or kv_len % blk:
        raise ValueError(f"kv_seq_len={kv_len} should be divisible by block={blk}")
    if blk < kv_len and blk % MIN_BLOCK_SIZE:
        raise NotImplementedError(f"block_k={blk} should be a multiple of {MIN_BLOCK_SIZE}")
    if blk < kv_len and head_dim > MIN_BLOCK_SIZE and head_dim % MIN_BLOCK_SIZE:
        raise NotImplementedError(
            f"head_dim={head_dim} should be a multiple of {MIN_BLOCK_SIZE} if larger")
    return blk


def _check_cuda(q, k, v, max_d: int, q_side=(), k_side=(),
                why: str = "") -> Tuple[int, int, int, int, int]:
    """Validate what the K5 kernels of the inputs' dtype take; returns (B, H, Lq, Lk,
    D). q_side tensors must share q's strides, k_side tensors (and v) k's; `why` is the
    reason for `max_d` a refusal gives."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d % 8 or d > max_d:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= {max_d}"
                         + (f": {why}" if why else ""))
    groups = ((q, (("q", q),) + tuple(q_side)), (k, (("k", k), ("v", v)) + tuple(k_side)))
    dtype = kernel_dtype(*(named for _, group in groups for named in group))
    geometry = head_geometry if dtype == torch.bfloat16 else vector_geometry
    for ref, group in groups:
        for name, t in group:
            if t.device.type != "cuda" or t.device != q.device:
                raise ValueError(f"{name} must be on {q.device}, got {t.device}")
            if t.shape != ref.shape or t.stride() != ref.stride():
                raise ValueError(f"{name} {tuple(t.shape)} {t.stride()} must have the shape "
                                 f"and strides of {tuple(ref.shape)} {ref.stride()}")
            geometry(t, name)
    return b, h, lq, k.shape[2], d


def _check_rows(b, h, lq, device, **rows) -> None:
    for name, t in rows.items():
        if t.shape != (b, h, lq) or t.dtype != torch.float32 or t.device != device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 ({b}, {h}, {lq}) on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")


def _strides(q, k):
    return (*q.stride()[:3], *k.stride()[:3])


def _launch(name: str, fn_name: str, *args) -> None:
    """Launch `fn_name` on the route of the first argument's dtype (q's)."""
    dtype = args[0].dtype
    fn = entry(build_kernels(), fn_name, dtype)
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args), stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    count_launch(LAUNCHES, FP32_LAUNCHES, name, dtype)


# ---------------------------------------------------------------------------- plain


def stock_flash_fwd_plain(q, k, v, sm_scale: float):
    """Plain version of the K5 forward in fp32: (O in q.dtype, m, l), m and l
    (B, H, Lq) fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p, v.float()) / l[..., None]
    return o.to(q.dtype), m, l


def _bwd_terms(q, k, v, do, m, l, di, sm_scale: float):
    """P = exp(S * scale - m) / l and dS = P * (dP - di) * scale, in fp32, as the
    stock backward kernels compute them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - m[..., None]) / l[..., None]
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None]) * sm_scale


def stock_flash_bwd_dkv_plain(q, k, v, do, m, l, di, sm_scale: float):
    """Plain version of K5 dK/dV: (dK, dV) in k.dtype / v.dtype."""
    p, ds = _bwd_terms(q, k, v, do, m, l, di, sm_scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def stock_flash_bwd_dq_plain(q, k, v, do, m, l, di, sm_scale: float):
    """Plain version of K5 dQ: dQ in q.dtype."""
    _, ds = _bwd_terms(q, k, v, do, m, l, di, sm_scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


# ---------------------------------------------------------------------------- wrappers


def stock_flash_fwd(q, k, v, sm_scale: float):
    """K5 forward over (B, H, L, D): (O with q's strides, m, l). CPU tensors take the
    plain version; CUDA tensors launch the kernel of their dtype (bf16 or fp32) or
    raise."""
    if q.device.type == "cpu":
        return stock_flash_fwd_plain(q, k, v, sm_scale)
    b, h, lq, lk, d = _check_cuda(q, k, v, MAX_HEAD_DIM)
    o = torch.empty_like(q)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("k5_fwd", "k5_stock_flash_fwd", q, k, v, o, m, l, b, h, lq, lk, d,
            *_strides(q, k), float(sm_scale))
    return o, m, l


def stock_flash_bwd_dkv(q, k, v, do, m, l, di, sm_scale: float):
    """K5 dK, dV (with k's strides) from dO, the forward's m and l, and
    di = rowsum(dO * O), each (B, H, Lq) fp32. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return stock_flash_bwd_dkv_plain(q, k, v, do, m, l, di, sm_scale)
    b, h, lq, lk, d = _check_cuda(q, k, v, MAX_BWD_HEAD_DIM, (("dout", do),),
                                  why=BWD_LIMIT_REASON)
    _check_rows(b, h, lq, q.device, m=m, l=l, di=di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("k5_dkv", "k5_stock_flash_bwd_dkv", q, k, v, do, m, l, di, dk, dv, b, h, lq,
            lk, d, *_strides(q, k), float(sm_scale))
    return dk, dv


def stock_flash_bwd_dq(q, k, v, do, m, l, di, sm_scale: float):
    """K5 dQ (with q's strides). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return stock_flash_bwd_dq_plain(q, k, v, do, m, l, di, sm_scale)
    b, h, lq, lk, d = _check_cuda(q, k, v, MAX_BWD_HEAD_DIM, (("dout", do),),
                                  why=BWD_LIMIT_REASON)
    _check_rows(b, h, lq, q.device, m=m, l=l, di=di)
    dq = torch.empty_like(q)
    _launch("k5_dq", "k5_stock_flash_bwd_dq", q, k, v, do, m, l, di, dq, b, h, lq, lk, d,
            *_strides(q, k), float(sm_scale))
    return dq


def _like(ref, x):
    """x in ref's memory layout (a copy only where the strides differ): the kernels
    take dO with the strides of q, and autograd hands the gradient in any layout."""
    return x if x.stride() == ref.stride() else torch.empty_like(ref).copy_(x)


class FlashStockAttention(torch.autograd.Function):
    """Differentiable K5 over (B, H, L, D): the K5 forward, and dK/dV + dQ as the
    backward (jax's stock ``_flash_attention`` ``custom_vjp``). Saves q, k, v, O, m
    and l; di = rowsum(dO * O) is one fp32 torch reduction, as the stock
    ``_flash_attention_bwd`` computes it outside its kernels. The backward builds no
    graph, so a second-order gradient raises."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        o, m, l = stock_flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = _like(q, do)
        di = (o.float() * do.float()).sum(dim=-1)
        dk, dv = stock_flash_bwd_dkv(q, k, v, do, m, l, di, ctx.sm_scale)
        dq = stock_flash_bwd_dq(q, k, v, do, m, l, di, ctx.sm_scale)
        return dq, dk, dv, None


def stock_flash_attention(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v over (B, H, L, D) through K5 (differentiable), with
    the length rules of ``_flash_stock`` (``stock_block``)."""
    stock_block(q.shape[2], k.shape[2], q.shape[3])
    return FlashStockAttention.apply(q, k, v, sm_scale)

