"""Hand-written Hopper flash attention (K1, K2): build, wrappers, plain versions.

Counterparts of the JAX package's two forward Pallas kernels:

  * K1 ``biased_attention`` <- ``controllora_tpu/ops/pallas_attention.py``
    (``_attn_kernel`` via ``flash_attention_fwd`` and ``biased_attention``): attention
    over (q + q_bias, k + k_bias, v + v_bias), the folded-adapter UNet self-attention;
  * K2 ``flash_attention`` <- ``controllora_tpu/ops/pallas_attention_vjp.py``
    (``_fwd_kernel`` via ``_fwd``): the same attention without biases, also returning
    LSE = logsumexp of each scaled logit row.

Both kernels live in ``csrc/flash_attn_fwd.cu`` (see its header for the design) and
take the projections in the (B, L, H*D) layout the attention layers produce, so no
head split or padding copy is made. The JAX block-size policy (``pick_block``,
``serving_blocks``) does not carry over: each kernel sizes its own tiles.

Device rule: a tensor on the CPU takes the plain PyTorch version beside each kernel;
a CUDA tensor launches the kernel or raises. The source is compiled with ``nvcc`` for
``sm_90a`` at the first CUDA call, into ``csrc/_build/`` (keyed by the source hash),
and bound with ``ctypes``.

``LAUNCHES`` counts kernel launches per kernel ("k1", "k2"); only the CUDA branch of
each wrapper increments it, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from controllora_tpu_torch.ops.attention import merge_heads, split_heads, tile_batch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "flash_attn_fwd.cu"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 512

LAUNCHES: Dict[str, int] = {"k1": 0, "k2": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------- build


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attn_fwd_{tag}.so"


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside the library as ``<name>.log``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                                   "build the flash-attention kernels")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            so.with_name(so.name + ".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k1_biased_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p,
                                            i, i, i, i, i, f, p]
        lib.k1_biased_flash_fwd.restype = i
        lib.k2_flash_fwd_lse.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
        lib.k2_flash_fwd_lse.restype = i
        _lib = lib
        return lib


# ---------------------------------------------------------------------------- checks


def _check_cuda_inputs(q, k, v, heads: int, biases=()) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels take; returns (B, H, Lq, Lk, D)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, L, H*D)")
    b, lq, inner = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != inner:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if heads < 1 or inner % heads:
        raise ValueError(f"width {inner} does not split into {heads} heads")
    d = inner // heads
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(biases):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 for the kernel, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return b, heads, lq, k.shape[1], d


def _check_bias(name, bias, batch: int, length: int, inner: int) -> int:
    if bias is None:
        return 1
    if bias.dim() != 3 or bias.shape[1:] != (length, inner) or batch % bias.shape[0]:
        raise ValueError(f"{name} {tuple(bias.shape)} must be (Bc, {length}, {inner}) "
                         f"with Bc dividing the batch {batch}")
    return bias.shape[0]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------- plain


def attention_lse_plain(q, k, v, heads: int):
    """Plain version of K2: fp32 logits and softmax over (B, L, H*D) projections.
    Returns (O (B, Lq, H*D) in q.dtype, LSE (B*H, Lq) fp32)."""
    qh, kh, vh = (split_heads(x.float(), heads) for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * qh.shape[-1] ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), vh)
    b, h, lq, _ = qh.shape
    return merge_heads(o).to(q.dtype), lse.reshape(b * h, lq)


def biased_attention_plain(q, k, v, heads: int, q_bias=None, k_bias=None, v_bias=None):
    """Plain version of K1: attention in fp32 over (q + q_bias, k + k_bias,
    v + v_bias), biases tiled over the batch. The sums are taken in the input dtype,
    as the JAX caller adds them (bf16 on the serving path; the kernel rounds them
    the same way)."""
    b = q.shape[0]

    def add(x, bias):
        return (x if bias is None else x + tile_batch(bias, b).to(x.dtype)).float()

    o, _ = attention_lse_plain(add(q, q_bias), add(k, k_bias), add(v, v_bias), heads)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------- wrappers


def flash_attention(q, k, v, heads: int):
    """K2: softmax(q k^T / sqrt(D)) v over (B, L, H*D) projections.

    Returns (O (B, Lq, H*D) in q.dtype, LSE (B*H, Lq) fp32). CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 only) or raise."""
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v, heads)
    b, h, lq, lk, d = _check_cuda_inputs(q, k, v, heads)
    lib = build_kernels()
    o = torch.empty_like(q)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k2_flash_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d,
                                   d**-0.5, stream)
    if err:
        raise RuntimeError(f"k2_flash_fwd_lse launch failed: cudaError {err}")
    LAUNCHES["k2"] += 1
    return o, lse


def biased_attention(q, k, v, heads: int, q_bias=None, k_bias=None, v_bias=None):
    """K1: attention over (q + q_bias, k + k_bias, v + v_bias), (B, L, H*D) layout.

    Biases are (Bc, L, H*D) with Bc dividing B; batch b reads bias row b % Bc, i.e.
    the bias batch is TILED over the [uncond || cond] CFG batch (JAX
    ``unet.py`` folded-path ``fit``). The bias adds happen inside the kernel's loads.
    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return biased_attention_plain(q, k, v, heads, q_bias, k_bias, v_bias)
    biases = (("q_bias", q_bias), ("k_bias", k_bias), ("v_bias", v_bias))
    b, h, lq, lk, d = _check_cuda_inputs(q, k, v, heads, biases)
    inner = h * d
    qbb = _check_bias("q_bias", q_bias, b, lq, inner)
    kbb = _check_bias("k_bias", k_bias, b, lk, inner)
    vbb = _check_bias("v_bias", v_bias, b, lk, inner)
    lib = build_kernels()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k1_biased_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      _ptr(q_bias), _ptr(k_bias), _ptr(v_bias),
                                      qbb, kbb, vbb, o.data_ptr(), b, h, lq, lk, d,
                                      d**-0.5, stream)
    if err:
        raise RuntimeError(f"k1_biased_flash_fwd launch failed: cudaError {err}")
    LAUNCHES["k1"] += 1
    return o
