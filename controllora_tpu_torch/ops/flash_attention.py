"""Hand-written Hopper flash attention (K1-K4): build, wrappers, plain versions.

Counterparts of the JAX package's flash-attention Pallas kernels:

  * K1 ``biased_attention`` <- ``controllora_tpu/ops/pallas_attention.py``
    (``_attn_kernel`` via ``flash_attention_fwd`` and ``biased_attention``): attention
    over (q + q_bias, k + k_bias, v + v_bias), the folded-adapter UNet self-attention;
  * K2 ``flash_attention`` <- ``controllora_tpu/ops/pallas_attention_vjp.py``
    (``_fwd_kernel`` via ``_fwd``): the same attention without biases, also returning
    LSE = logsumexp of each scaled logit row;
  * K3 ``flash_bwd_dkv`` <- ``pallas_attention_vjp.py`` (``_bwd_dkv_kernel`` via
    ``_bwd``): dK and dV of that attention;
  * K4 ``flash_bwd_dq`` <- ``pallas_attention_vjp.py`` (``_bwd_dq_kernel`` via
    ``_bwd``): dQ.

``FlashAttention`` ties K2 to K3 + K4 as one ``torch.autograd.Function``, the
counterpart of the JAX ``flash_attention`` ``custom_vjp``.

Each kernel has two routes, picked by the inputs' dtype (``kernel_dtype``): bf16
and fp32, the dtypes the JAX package's stacks give its kernels. On bf16, K1 and K2
run in ``csrc/flash_attn_fwd.cu`` (wgmma, a TMA-fed K/V ring, softmax in registers;
``csrc/hopper.cuh``), K3 and K4 in ``csrc/flash_attn_bwd.cu`` (wgmma: K3's kernel
keeps 128 keys a block and streams query tiles through a TMA ring, K4's keeps 128
queries and streams key tiles; K5's backward runs on the same two kernels; see the
headers for the design). They read the projections through TMA tensor maps
(``tma_geometry``, one case of ``head_geometry``). On fp32 all five run in
``csrc/flash_attn_fp32.cu``, with fp32-accurate products, as the JAX kernels multiply
fp32 blocks with fp32 results: the forward and dK/dV as 3xTF32 on wgmma (each operand
split into two tf32 parts, three tensor-core products a product) fed by a TMA ring,
each tile split and transposed in shared memory by the kernel, dQ as fp32 FMA on the CUDA
cores with ``cp.async`` copies (both need ``vector_geometry``). Both routes take the
projections in the (B, L, H*D) layout the attention layers produce, so no head split or
padding copy is made.
The JAX block-size policy (``pick_block``, ``serving_blocks``) does not carry over:
each kernel sizes its own tiles (``fwd_tiles`` reports K1/K2's), and bf16 heads wider
than 80 split the key range where the query tiles alone leave SMs idle
(``kv_splits``; the fp32 forward never splits).

Device rule: a tensor on the CPU takes the plain PyTorch version beside each kernel;
a CUDA tensor launches the kernel of its dtype or raises. Every ``csrc/*.cu`` is
compiled with ``nvcc`` for ``sm_90a`` at the first CUDA call (one ``nvcc`` per
source, all started together, then one link) into one library in ``csrc/_build/``,
keyed by the hash of all the sources, and bound with ``ctypes``.

``LAUNCHES`` counts kernel launches per kernel ("k1".."k4") whatever the dtype, and
``FP32_LAUNCHES`` those of the fp32 route alone; only the CUDA branch of each wrapper
increments them, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from controllora_tpu_torch.ops.attention import merge_heads, split_heads, tile_batch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 512  # the forward's (K1, K2, K5): bf16 D <= 48, 64, 80, 512; fp32 8-80, 512
MAX_BWD_HEAD_DIM = 80  # the backward's (K3, K4, K5): bf16 DS 48, 64, 80; fp32 8-80
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the two routes of every kernel

LAUNCHES: Dict[str, int] = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
FP32_LAUNCHES: Dict[str, int] = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FP32_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(counts: Dict[str, int], fp32_counts: Dict[str, int], name: str,
                 dtype: torch.dtype) -> None:
    """One launch of kernel `name`: counted in `counts`, and in `fp32_counts` too on
    the fp32 route."""
    counts[name] += 1
    if dtype == torch.float32:
        fp32_counts[name] += 1


# ---------------------------------------------------------------------------- build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):  # kernels and their shared headers
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libflash_attn_{digest.hexdigest()[:16]}.so"


def _spawn(nvcc: str, out: Path, args) -> Tuple[Path, subprocess.Popen]:
    return out, subprocess.Popen([nvcc, *args, "-o", str(out)], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _run(procs: List[Tuple[Path, subprocess.Popen]]) -> None:
    """Wait for every compiler process; keep each report as ``<output>.log``."""
    failed = []
    for out, proc in procs:
        stdout, stderr = proc.communicate()
        out.with_name(out.name + ".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{out.name} ({proc.returncode}):\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library: one ``nvcc -c``
    per ``csrc/*.cu``, all started together, then one ``nvcc -shared`` link.

    The compiler's reports (``-Xptxas -v``: registers, shared memory, spills) are
    kept beside each object as ``<name>.o.log``."""
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
            stem = f"{so.stem}.{os.getpid()}"
            srcs = sources()
            objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in srcs]
            _run([_spawn(nvcc, obj, (*NVCC_FLAGS, "-c", str(src)))
                  for src, obj in zip(srcs, objs)])
            tmp = so.with_name(f"{stem}.so.tmp")
            _run([_spawn(nvcc, tmp, (*ARCH, "-shared", *map(str, objs)))])
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, biases, bias batches, sums, o, o_part, lse_part, B, H, Lq, Lk, D,
        # scale, splits, stream
        lib.k1_biased_flash_fwd.argtypes = [p] * 6 + [i] * 3 + [p] * 6 + [i] * 5 + [f, i, p]
        lib.k1_biased_flash_fwd.restype = i
        # q, k, v, o, lse, o_part, lse_part, B, H, Lq, Lk, D, scale, splits, stream
        lib.k2_flash_fwd_lse.argtypes = [p] * 7 + [i] * 5 + [f, i, p]
        lib.k2_flash_fwd_lse.restype = i
        lib.k3_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.k3_flash_bwd_dkv.restype = i
        lib.k4_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.k4_flash_bwd_dq.restype = i
        lib.flash_fwd_tiles.argtypes = [i, p, p, p]
        lib.flash_fwd_tiles.restype = i
        strides = [ctypes.c_longlong] * 6  # (b, h, l) element strides of q, then of k
        lib.k5_stock_flash_fwd.argtypes = [p] * 6 + [i] * 5 + strides + [f, p]
        lib.k5_stock_flash_fwd.restype = i
        lib.k5_stock_flash_bwd_dkv.argtypes = [p] * 9 + [i] * 5 + strides + [f, p]
        lib.k5_stock_flash_bwd_dkv.restype = i
        lib.k5_stock_flash_bwd_dq.argtypes = [p] * 8 + [i] * 5 + strides + [f, p]
        lib.k5_stock_flash_bwd_dq.restype = i
        for name in ("k1_biased_flash_fwd", "k2_flash_fwd_lse", "k3_flash_bwd_dkv",
                     "k4_flash_bwd_dq", "flash_fwd_tiles", "k5_stock_flash_fwd",
                     "k5_stock_flash_bwd_dkv", "k5_stock_flash_bwd_dq"):
            fp32 = getattr(lib, name + "_f32")  # csrc/flash_attn_fp32.cu, same arguments
            fp32.argtypes = getattr(lib, name).argtypes
            fp32.restype = i
        _lib = lib
        return lib


# ---------------------------------------------------------------------------- checks


def head_geometry(x, name: str = "x") -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The 4-D view (D, H, L, B), innermost first, through which a tensor map reads a
    (B, H, L, D) tensor by its strides (``encode_heads`` in csrc/hopper.cuh), and the
    byte strides of its dims 1-3 (those of H, L and B). The copy engine needs a
    contiguous last dim, a 16-byte aligned base and strides that are multiples of 16
    bytes (D and every stride a multiple of 8 in bf16); raises ValueError otherwise."""
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, H, L, D), got {tuple(x.shape)}")
    b, h, length, d = x.shape
    size = x.element_size()
    sb, sh, sl, sd = x.stride()
    if sd != 1 and d > 1:
        raise ValueError(f"{name} {tuple(x.shape)} with strides {x.stride()} needs a "
                         "contiguous last dim")
    strides = (sh * size, sl * size, sb * size)
    if x.data_ptr() % 16 or (d * size) % 16 or any(st % 16 for st in strides):
        raise ValueError(f"{name}: a tensor map needs a 16-byte aligned base (offset "
                         f"{x.data_ptr() % 16}), D a multiple of {16 // size} and 16-byte "
                         f"multiple strides, got D {d}, strides {strides}")
    return (d, h, length, b), strides


def tma_geometry(x, heads: int, name: str = "x") -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``head_geometry`` of a contiguous (B, L, H*D) projection, read as its head-split
    view: dims (D, H, L, B) and byte strides (2D, 2HD, 2LHD) in bf16."""
    if not x.is_contiguous():
        raise ValueError(f"{name} {tuple(x.shape)} with strides {x.stride()} is not "
                         "contiguous")
    return head_geometry(split_heads(x, heads), name)


def vector_geometry(x, name: str = "x") -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """What the fp32 kernels need of a (B, H, L, D) fp32 tensor, which they read by its
    strides: the forward and dK/dV through TMA tensor maps (``encode_heads`` with fp32 in
    csrc/hopper.cuh), dQ by 16-byte ``cp.async`` copies. Both move 16-byte units, and the
    copy engine takes only a 16-byte aligned base and row strides that are multiples of
    16 bytes: so a contiguous last dim, a 16-byte aligned base, and D and every element
    stride a multiple of 4. Returns the dims (D, H, L, B) and the element strides of H,
    L and B; raises ValueError otherwise."""
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, H, L, D), got {tuple(x.shape)}")
    b, h, length, d = x.shape
    sb, sh, sl, sd = x.stride()
    if sd != 1 and d > 1:
        raise ValueError(f"{name} {tuple(x.shape)} with strides {x.stride()} needs a "
                         "contiguous last dim")
    if x.data_ptr() % 16 or d % 4 or any(st % 4 for st in (sh, sl, sb)):
        raise ValueError(f"{name}: the fp32 kernels copy 16-byte units (TMA, cp.async), "
                         f"so they need a 16-byte aligned base (offset {x.data_ptr() % 16}) "
                         f"and D and every element stride a multiple of 4, got D {d}, "
                         f"strides {(sh, sl, sb)}")
    return (d, h, length, b), (sh, sl, sb)


def kernel_dtype(*named) -> torch.dtype:
    """The route the kernels take for these (name, tensor) inputs (None tensors are
    skipped): bf16 launches the bf16 kernels, fp32 those of csrc/flash_attn_fp32.cu.
    Any other dtype, or inputs of two dtypes, raise TypeError naming both routes."""
    given = [(name, t.dtype) for name, t in named if t is not None]
    dtypes = {dtype for _, dtype in given}
    if len(dtypes) == 1 and given[0][1] in KERNEL_DTYPES:
        return given[0][1]
    listing = ", ".join(f"{name} {dtype}" for name, dtype in given)
    raise TypeError(f"the flash kernels take bfloat16 or float32 inputs, all of one "
                    f"dtype; got {listing}")


def entry(lib: ctypes.CDLL, name: str, dtype: torch.dtype):
    """The library's entry point `name` for the route of `dtype`: the bf16 kernel, or
    its fp32 namesake (``<name>_f32``), which takes the same arguments."""
    return getattr(lib, name if dtype == torch.bfloat16 else name + "_f32")


def fwd_tiles(d: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int]:
    """(query rows a block, keys a tile, most key splits) of the K1/K2 instance that
    takes head dim `d` on the route of `dtype`, as csrc/flash_attn_fwd.cu (bf16) or
    csrc/flash_attn_fp32.cu (fp32: 128 rows up to D 80, 64 above, 64-key tiles, never a
    split) set them (``flash_fwd_tiles``)."""
    lib = build_kernels()
    vals = [ctypes.c_int() for _ in range(3)]
    err = entry(lib, "flash_fwd_tiles", dtype)(d, *(ctypes.byref(x) for x in vals))
    if err:
        raise ValueError(f"no K1/K2 instance takes head dim {d} (cudaError {err})")
    return tuple(x.value for x in vals)


def kv_splits(bh: int, lq: int, lk: int, tiles: Tuple[int, int, int], sms: int) -> int:
    """How many blocks share one query tile's key range in K1/K2, for the instance's
    `tiles` (``fwd_tiles``). Where the B*H*ceil(Lq/rows) blocks fill fewer than the
    card's `sms`, each tile's keys go to up to sms // blocks blocks (at most the
    instance's limit, each with at least four key tiles, none empty), and a combine
    kernel merges their (O, LSE). Returns 1 for no split."""
    rows, keys, max_splits = tiles
    blocks = bh * -(-lq // rows)
    n_tiles = -(-lk // keys)
    splits = max(1, min(max_splits, sms // blocks, n_tiles // 4))
    while splits > 1 and (splits - 1) * -(-n_tiles // splits) >= n_tiles:
        splits -= 1
    return splits


def _check_cuda_inputs(q, k, v, heads: int, biases=()) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels of the inputs' dtype take; returns (B, H, Lq, Lk, D)."""
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
    named = (("q", q), ("k", k), ("v", v)) + tuple(biases)
    dtype = kernel_dtype(*named)
    for name, t in named:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if dtype == torch.bfloat16:
            tma_geometry(t, heads, name)
        elif not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()} is not "
                             "contiguous")
        else:
            vector_geometry(split_heads(t, heads), name)
    return b, heads, lq, k.shape[1], d


def _check_bias(name, bias, batch: int, length: int, inner: int) -> int:
    if bias is None:
        return 1
    if bias.dim() != 3 or bias.shape[1:] != (length, inner) or batch % bias.shape[0]:
        raise ValueError(f"{name} {tuple(bias.shape)} must be (Bc, {length}, {inner}) "
                         f"with Bc dividing the batch {batch}")
    return bias.shape[0]


def _check_bwd_inputs(q, k, v, do, lse, dcap, heads: int) -> Tuple[int, int, int, int, int]:
    """Validate what K3/K4 take; returns (B, H, Lq, Lk, D)."""
    b, h, lq, lk, d = _check_cuda_inputs(q, k, v, heads, (("dout", do),))
    if do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} must match q {tuple(q.shape)}")
    if d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_BWD_HEAD_DIM}: the backward kernels "
                         f"K3/K4 take head dims up to {MAX_BWD_HEAD_DIM}")
    for name, t in (("lse", lse), ("dcap", dcap)):
        if t.shape != (b * h, lq) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 ({b * h}, {lq}) on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    return b, h, lq, lk, d


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


def attention_dcap(o, do, heads: int):
    """Dcap = rowsum(dO * O) per head in fp32, (B*H, Lq): the term the JAX ``_bwd``
    computes outside its kernels (one reduction, no kernel of its own)."""
    b, lq, inner = o.shape
    prod = (do.float() * o.float()).reshape(b, lq, heads, inner // heads).sum(-1)
    return prod.permute(0, 2, 1).reshape(b * heads, lq).contiguous()


def _bwd_terms(q, k, v, do, lse, dcap, heads: int, scale: Optional[float]):
    """The shared part of the plain K3/K4, line by line as the JAX ``_bwd`` kernels
    compute it, in fp32: P = exp(S * scale - LSE), dP = dO V^T, dS = P (dP - Dcap).
    The scale defaults to D^-1/2."""
    qh, kh, vh, doh = (split_heads(x.float(), heads) for x in (q, k, v, do))
    b, h, lq, d = qh.shape
    scale = d**-0.5 if scale is None else scale
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(b, h, lq, 1))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - dcap.reshape(b, h, lq, 1))
    return qh, kh, doh, p, ds, scale


def flash_bwd_dkv_plain(q, k, v, do, lse, dcap, heads: int, scale: Optional[float] = None):
    """Plain version of K3: (dK, dV) in k.dtype / v.dtype, (B, Lk, H*D). With K5's
    residuals (LSE = m + log l) and its scale it is K5's dK/dV, as the kernel runs it."""
    qh, _, doh, p, ds, scale = _bwd_terms(q, k, v, do, lse, dcap, heads, scale)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return merge_heads(dk).to(k.dtype), merge_heads(dv).to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, dcap, heads: int, scale: Optional[float] = None):
    """Plain version of K4: dQ in q.dtype, (B, Lq, H*D); with K5's residuals, K5's dQ."""
    _, kh, _, _, ds, scale = _bwd_terms(q, k, v, do, lse, dcap, heads, scale)
    return merge_heads(torch.matmul(ds, kh) * scale).to(q.dtype)


# ---------------------------------------------------------------------------- wrappers


def _split_scratch(q, b, h, lq, lk, d):
    """(splits, o_part, lse_part): the key-split plan of q's route and its fp32
    scratch."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = kv_splits(b * h, lq, lk, fwd_tiles(d, q.dtype), sms)
    if splits == 1:
        return 1, None, None
    o_part = torch.empty((splits, b * h, lq, d), dtype=torch.float32, device=q.device)
    return splits, o_part, torch.empty((splits, b * h, lq), dtype=torch.float32,
                                       device=q.device)


def flash_attention(q, k, v, heads: int):
    """K2: softmax(q k^T / sqrt(D)) v over (B, L, H*D) projections.

    Returns (O (B, Lq, H*D) in q.dtype, LSE (B*H, Lq) fp32). CPU tensors take the
    plain version; CUDA tensors launch the kernel of their dtype (bf16 or fp32) or
    raise."""
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v, heads)
    b, h, lq, lk, d = _check_cuda_inputs(q, k, v, heads)
    lib = build_kernels()
    o = torch.empty_like(q)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    splits, o_part, lse_part = _split_scratch(q, b, h, lq, lk, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(lib, "k2_flash_fwd_lse", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _ptr(o_part), _ptr(lse_part), b, h, lq, lk, d, d**-0.5, splits, stream)
    if err:
        raise RuntimeError(f"k2_flash_fwd_lse ({q.dtype}) launch failed: cudaError {err}")
    count_launch(LAUNCHES, FP32_LAUNCHES, "k2", q.dtype)
    return o, lse


def biased_attention(q, k, v, heads: int, q_bias=None, k_bias=None, v_bias=None):
    """K1: attention over (q + q_bias, k + k_bias, v + v_bias), (B, L, H*D) layout.

    Biases are (Bc, L, H*D) with Bc dividing B; batch b reads bias row b % Bc, i.e.
    the bias batch is TILED over the [uncond || cond] CFG batch (JAX
    ``unet.py`` folded-path ``fit``). The kernel's pre-pass writes each biased sum
    once, in the input dtype (rounded to bf16 on bf16), into scratch allocated here.
    CPU tensors take the plain version; CUDA tensors launch the kernel of their dtype
    or raise."""
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
    sums = [None if bias is None else torch.empty_like(x)
            for x, bias in ((q, q_bias), (k, k_bias), (v, v_bias))]
    splits, o_part, lse_part = _split_scratch(q, b, h, lq, lk, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(lib, "k1_biased_flash_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_bias), _ptr(k_bias),
            _ptr(v_bias), qbb, kbb, vbb, *map(_ptr, sums), o.data_ptr(), _ptr(o_part),
            _ptr(lse_part), b, h, lq, lk, d, d**-0.5, splits, stream)
    if err:
        raise RuntimeError(f"k1_biased_flash_fwd ({q.dtype}) launch failed: cudaError {err}")
    count_launch(LAUNCHES, FP32_LAUNCHES, "k1", q.dtype)
    return o


def flash_bwd_dkv(q, k, v, do, lse, dcap, heads: int):
    """K3: (dK, dV) of softmax(q k^T / sqrt(D)) v over (B, L, H*D) projections, from
    dO, K2's LSE and Dcap (``attention_dcap``), both (B*H, Lq) fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, dcap, heads)
    b, h, lq, lk, d = _check_bwd_inputs(q, k, v, do, lse, dcap, heads)
    lib = build_kernels()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(lib, "k3_flash_bwd_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, lq, lk, d, d**-0.5, stream)
    if err:
        raise RuntimeError(f"k3_flash_bwd_dkv ({q.dtype}) launch failed: cudaError {err}")
    count_launch(LAUNCHES, FP32_LAUNCHES, "k3", q.dtype)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, dcap, heads: int):
    """K4: dQ of the same attention, (B, Lq, H*D). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, dcap, heads)
    b, h, lq, lk, d = _check_bwd_inputs(q, k, v, do, lse, dcap, heads)
    lib = build_kernels()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(lib, "k4_flash_bwd_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dcap.data_ptr(), dq.data_ptr(), b, h, lq, lk, d, d**-0.5, stream)
    if err:
        raise RuntimeError(f"k4_flash_bwd_dq ({q.dtype}) launch failed: cudaError {err}")
    count_launch(LAUNCHES, FP32_LAUNCHES, "k4", q.dtype)
    return dq


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over (B, L, H*D) projections: forward K2,
    backward K3 + K4 (the JAX ``flash_attention`` ``custom_vjp``). Saves q, k, v, O
    and LSE; the gradients come back in the inputs' dtypes and layout. Under
    ``no_grad``/``inference_mode`` no graph is kept. The backward kernels build no
    graph either, so a second-order gradient (``create_graph=True``) raises."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int):
        o, lse = flash_attention(q, k, v, heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dcap = attention_dcap(o, do, ctx.heads)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dcap, ctx.heads)
        dq = flash_bwd_dq(q, k, v, do, lse, dcap, ctx.heads)
        return dq, dk, dv, None
