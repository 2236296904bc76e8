"""The hand-written flash kernels K1-K5 against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip. On the card:
    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -m gpu -q
Each kernel runs on bf16 inputs (the bf16 route) and on fp32 inputs (the fp32 route,
csrc/flash_attn_fp32.cu). The plain version runs in fp32 (TF32 off) on the same
values (and the same sums with the biases) and its output stays fp32. On bf16 the
bounds (O 1e-2, LSE 1e-3, gradients 1e-2 * max(1, max|ref|)) cover the kernels' bf16
rounding of P (and dS) and of their own outputs; K1 has no LSE to check, so its O is
also held to 2e-2 * max|ref|: at long L, O shrinks as 1/sqrt(L) toward 1e-2 itself.
On fp32 every output is held to 1e-4 * max(1, max|ref|), LSE and m to 1e-4 and l to
1e-4 relative: every fp32 kernel multiplies as 3xTF32 (about 2^-21 of each product;
tests/test_torch_tf32_split.py); a single TF32 product, about three decimal digits,
would miss these.
"""

import numpy as np
import pytest
import torch

from controllora_tpu_torch.ops import flash_attention as fa
from controllora_tpu_torch.ops import flash_stock as fs
from controllora_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launch_counts()
    fs.reset_launch_counts()
    with torch.enable_grad():  # whatever an earlier test left (see test_torch_flash_stock.py)
        yield torch.device("cuda")


BF16, FP32 = torch.bfloat16, torch.float32


def randn(shape, seed, device, dtype=BF16):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def fp32_close(out, ref):
    """The fp32 route's bound: max|out - ref| within 1e-4 * max(1, max|ref|)."""
    err = (out.float() - ref).abs().max().item()
    return out.dtype == FP32 and err <= 1e-4 * max(1.0, ref.abs().max().item())


def k1_reference(q, k, v, heads, qb, kb, vb):
    """The plain version on the same bf16 sums, biases TILED over the batch (row i
    reads bias row i % Bc), kept in fp32 (no output rounding)."""
    b = q.shape[0]
    qe, ke, ve = ((x if xb is None else x + xb.repeat(b // xb.shape[0], 1, 1)).float()
                  for x, xb in ((q, qb), (k, kb), (v, vb)))
    return fa.attention_lse_plain(qe, ke, ve, heads)[0]


def k1_close(out, ref):
    """K1's max|dO| within 1e-2 and within 2e-2 * max|ref| (bf16), or fp32_close."""
    if out.dtype == FP32:
        return fp32_close(out, ref)
    err = (out.float() - ref).abs().max().item()
    return err <= min(1e-2, 2e-2 * ref.abs().max().item())


# the fp32 route at the fp32 stacks' K1 shapes: the smoke stacks at 512² (D 8 and 16),
# SD1.5 and the refiner (D 40, 64) guided, ragged L, per-image biases, the wide design
K1_FP32 = [(2, 4, 4096, 8, 1, FP32), (2, 2, 4096, 16, 1, FP32), (2, 8, 4096, 40, 1, FP32),
           (2, 12, 4096, 64, 1, FP32), (2, 8, 4225, 40, 1, FP32), (8, 8, 1024, 40, 4, FP32),
           (4, 4, 333, 80, 2, FP32), (2, 2, 77, 160, 1, FP32), (1, 1, 1000, 512, 1, FP32),
           (2, 3, 33, 32, 1, FP32)]


@pytest.mark.parametrize("b,heads,l,d,bc,dtype", [shape + (BF16,) for shape in [
                                            (2, 8, 1024, 40, 1), (2, 4, 333, 80, 1),
                                            (1, 1, 1000, 512, 1), (2, 2, 77, 160, 1),
                                            (8, 8, 1024, 40, 4), (4, 4, 333, 80, 2),
                                            (2, 8, 33, 40, 1), (8, 2, 700, 64, 2),
                                            (8, 8, 4096, 40, 4), (8, 8, 4096, 40, 1),
                                            (2, 8, 4225, 40, 1), (2, 1, 700, 512, 1),
                                            (2, 8, 2048, 40, 2), (8, 8, 2048, 40, 8),
                                            (2, 5, 9216, 64, 1), (8, 10, 2304, 64, 4),
                                            (2, 10, 4096, 64, 1), (2, 12, 4096, 64, 1),
                                            (2, 8, 16384, 40, 1), (2, 8, 4096, 80, 1)]]
                         + K1_FP32)
def test_k1_matches_plain(cuda, b, heads, l, d, bc, dtype):
    """bc is the bias batch: per-image biases (bc = n under the 2n CFG batch) must
    TILE, so batch row i reads bias row i % bc; every bias row differs. L shorter
    than a tile (33), ragged (333, 700, 4225), the render's 4096 and ToMe's merged
    2048, whose biases are merged per CFG row (bc = b); D 40, 64, 80, 160 and 512
    (the wide design); the other families' head dim 64 renders: SD2.1 at 768²
    (levels 0 and 1, the second at batch 4), SDXL at 1024² and the refiner's UNet;
    SD1.5's 1024² hires pass (levels 0 and 1: L 16384 at D 40, L 4096 at D 80). Then
    the fp32 route (K1_FP32), counted in FP32_LAUNCHES as well."""
    q, k, v = (randn((b, l, heads * d), s, cuda, dtype) for s in range(3))
    qb, kb, vb = (0.25 * randn((bc, l, heads * d), s, cuda, dtype) for s in range(3, 6))
    out = fa.biased_attention(q, k, v, heads, qb, kb, vb)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["k1"] == 1 and fa.FP32_LAUNCHES["k1"] == (dtype == FP32)
    assert out.dtype == dtype
    assert k1_close(out, k1_reference(q, k, v, heads, qb, kb, vb))


@pytest.mark.parametrize("missing", ["q", "k", "v", "all"])
def test_k1_with_a_bias_left_out(cuda, missing):
    """Each bias may be None (the kernel's pre-pass skips it): batch 8 under bias
    batch 2, and all three None."""
    b, heads, l, d = 8, 4, 300, 40
    q, k, v = (randn((b, l, heads * d), s, cuda) for s in range(3))
    biases = {n: 0.25 * randn((2, l, heads * d), s, cuda) for s, n in enumerate("qkv", 3)}
    for n in ("qkv" if missing == "all" else missing):
        biases[n] = None
    out = fa.biased_attention(q, k, v, heads, biases["q"], biases["k"], biases["v"])
    torch.cuda.synchronize()
    ref = k1_reference(q, k, v, heads, biases["q"], biases["k"], biases["v"])
    assert k1_close(out, ref)


# the fp32 route at the fp32 stacks' K2 shapes: SD1.5 training under --mixed_precision
# no (batch 8) and its VAE encoder, the smoke VAE at 512² (D 32), the refiner unguided
# and its 1024² VAE decode; ragged and short shapes; q scaled x4 (q_mul), a peaked
# softmax whose TF32-grade products would show
K2_FP32 = [(8, 8, 4096, 40, 1, FP32), (8, 8, 4096, 40, 4, FP32), (8, 1, 4096, 512, 1, FP32),
           (1, 1, 4096, 32, 1, FP32), (2, 12, 4096, 64, 1, FP32), (1, 1, 16384, 512, 1, FP32),
           (2, 8, 4225, 40, 1, FP32), (2, 2, 4096, 16, 4, FP32), (2, 8, 33, 40, 1, FP32),
           (1, 4, 333, 80, 1, FP32), (2, 2, 4225, 160, 1, FP32), (1, 1, 700, 512, 4, FP32)]


@pytest.mark.parametrize("b,heads,l,d,q_mul,dtype", [shape + (1, BF16) for shape in [
                                         (2, 8, 1024, 40), (1, 1, 700, 512),
                                         (1, 2, 129, 64), (8, 8, 4096, 40),
                                         (8, 1, 4096, 512), (1, 1, 4096, 512),
                                         (2, 8, 33, 40), (1, 4, 333, 80), (2, 2, 4225, 160),
                                         (1, 8, 700, 64), (2, 8, 2048, 40),
                                         (1, 1, 9216, 512), (1, 1, 16384, 512),
                                         (2, 12, 4096, 64), (1, 8, 4096, 40)]] + K2_FP32)
def test_k2_matches_plain(cuda, b, heads, l, d, q_mul, dtype):
    """Ragged and short shapes, the serving VAE (1, 1, 4096, 512, split keys), then
    the training path's at 512², batch 8: the UNet self-attention and the VAE
    encoder's mid-attention, and at batch 1 (the canned train_canny task); the VAE decode of SD2.1 at 768² and of SDXL at 1024²
    (also the VAE encoder of a 1024² img2img pass); the refiner's unguided level 1 at
    1024², which a base -> refiner ensemble runs on K2. Then the fp32 route (K2_FP32),
    counted in FP32_LAUNCHES as well."""
    q, k, v = (randn((b, l, heads * d), s, cuda, dtype) for s in range(3))
    q = q * q_mul
    o, lse = fa.flash_attention(q, k, v, heads)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), heads)
    assert fa.LAUNCHES["k2"] == 1 and fa.FP32_LAUNCHES["k2"] == (dtype == FP32)
    if dtype == FP32:
        assert fp32_close(o, o_ref)
        assert (lse - lse_ref).abs().max().item() <= 1e-4
        return
    assert (o.float() - o_ref).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("l", [4096, 1000])
def test_k2_key_split_equals_one_pass(cuda, l, monkeypatch):
    """At batch 1 and D 512 the plan splits the key range (2 splits at L 4096, 8 at
    1000); the combined result agrees with the one-pass kernel's (the plan forced to
    1) within the bf16 rounding of O, and their LSE within fp32 rounding."""
    q, k, v = (randn((1, l, 512), s, cuda) for s in range(3))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.kv_splits(1, l, l, fa.fwd_tiles(512), sms) > 1
    o_split, lse_split = fa.flash_attention(q, k, v, 1)
    monkeypatch.setattr(fa, "kv_splits", lambda *args: 1)
    o_one, lse_one = fa.flash_attention(q, k, v, 1)
    torch.cuda.synchronize()
    assert (o_split.float() - o_one.float()).abs().max().item() <= 8e-3
    assert (lse_split - lse_one).abs().max().item() <= 1e-4
    o_ref, _ = fa.attention_lse_plain(q.float(), k.float(), v.float(), 1)
    assert (o_split.float() - o_ref).abs().max().item() <= 1e-2


@pytest.mark.parametrize("d", [8, 40, 64, 80, 88, 96, 128, 160, 168, 512])
def test_fwd_tiles_of_each_instance(cuda, d):
    """The library reports the tiles the split plan reads: 128 query rows and 64-key
    tiles up to D 80, 192 rows (three consumer warpgroups) and 64-key tiles at D 88-160
    (the DS 160 instance), 64 rows and 32-key tiles in the wide design (D 168-512), and
    key splits (up to 8) above D 80 only."""
    want = (128, 64, 1) if d <= 80 else (192, 64, 8) if d <= 160 else (64, 32, 8)
    assert fa.fwd_tiles(d) == want


@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 80, 88, 160, 168, 512])
def test_fwd_tiles_of_each_fp32_instance(cuda, d):
    """The fp32 forward's tiles (3xTF32 on wgmma): 128 query rows a block (two consumer
    warpgroups of 64) up to D 80, 64 in the two wide instances above (D 88-160 and
    168-512), 64-key tiles in all; it never splits the key range, so kv_splits plans 1
    even at batch 1."""
    rows, keys, max_splits = fa.fwd_tiles(d, FP32)
    assert (rows, keys, max_splits) == ((128, 64, 1) if d <= 80 else (64, 64, 1))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.kv_splits(1, 4096, 4096, (rows, keys, max_splits), sms) == 1


def bf16_o_close(out, ref, q_mul):
    """A bf16 output against its fp32 plain version: max|d| within 1e-2 and 2e-2 *
    max|ref| (K1's bound, k1_close, held for K2 and K5 too), or with q scaled (a peaked
    softmax, where O takes the value of a single key's v and reaches |O| ~ 4) within
    1e-2 beyond the output's own rounding, 2^-8 |ref| (half a bf16 ulp): there the plain
    version rounded to bf16 is itself up to 1.5e-2 from its fp32 value, and on an H100
    the kernels' error was that rounding, on every instance (D 512's too)."""
    err = (out.float() - ref).abs()
    if q_mul == 1:
        return err.max().item() <= min(1e-2, 2e-2 * ref.abs().max().item())
    return bool((err <= 1e-2 + 2**-8 * ref.abs()).all())


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("q_mul", [1, 4])
@pytest.mark.parametrize("l", [2116, 333])
@pytest.mark.parametrize("d", [88, 96, 128, 152, 160])
def test_fwd_head_dims_88_to_160(cuda, d, l, q_mul, dtype):
    """The forward's instances at D 88-160 (bf16: DS 160 on wgmma; fp32:
    flash_fwd_d160_3xtf32_kernel), zero filled to 160, at ragged L (SD1.5's 1472²
    level 2, and a short one), q as drawn and scaled x4: K1 with biases of batch 1
    under batch 2, K2's O and LSE, and the K5 forward's O, m and l at a negative
    scale, each against its plain version in fp32 on the same values."""
    b, heads = 2, 2
    q, k, v = (randn((b, l, heads * d), s, cuda, dtype) for s in range(3))
    q = q * q_mul
    qb, kb, vb = (0.25 * randn((1, l, heads * d), s, cuda, dtype) for s in range(3, 6))
    out = fa.biased_attention(q, k, v, heads, qb, kb, vb)
    o, lse = fa.flash_attention(q, k, v, heads)
    qh, kh, vh = (split_heads(x, heads) for x in (q, k, v))
    o5, m, lsum = fs.stock_flash_fwd(qh, kh, vh, -(d**-0.5))
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"k1": 1, "k2": 1, "k3": 0, "k4": 0}
    assert fs.LAUNCHES["k5_fwd"] == 1 and fs.FP32_LAUNCHES["k5_fwd"] == (dtype == FP32)
    o_ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), heads)
    o5_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(qh.float(), kh.float(), vh.float(),
                                                    -(d**-0.5))
    outputs = (("K1", out, k1_reference(q, k, v, heads, qb, kb, vb)), ("K2", o, o_ref),
               ("K5", o5, o5_ref))
    for name, x, ref in outputs:
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        assert fp32_close(x, ref) if dtype == FP32 else bf16_o_close(x, ref, q_mul), name
    # LSE and m to 1e-4 (fp32) or 1e-3 (bf16; m relative where |m| > 1), l relative
    tol = 1e-4 if dtype == FP32 else 1e-3
    m_scale = 1.0 if dtype == FP32 else m_ref.abs().clamp(min=1)
    assert (lse - lse_ref).abs().max().item() <= tol
    assert ((m - m_ref).abs() / m_scale).max().item() <= tol
    assert ((lsum - l_ref).abs() / l_ref).max().item() <= tol


@pytest.mark.parametrize("l", [300, 4225])
@pytest.mark.parametrize("d", [8, 16, 32, 40, 48, 64, 80, 160, 512])
def test_fp32_instances_at_ragged_lengths(cuda, d, l):
    """Every instance of the fp32 forward, dK/dV and dQ kernels (3xTF32 on wgmma) at a
    length that is not a whole number of their tiles (128 or 64 query rows, 64-key
    tiles; 64 or 128 keys and 32-query tiles in dK/dV; 128 queries and 64-key tiles, or
    64 queries and 32-key tiles, in dQ; at D 160 64 stationary rows and 16-row tiles in
    both): K2's O and LSE, the K5 forward's O, m and l at
    the stock scale negated, and K3's and K5's dK, dV and K4's and K5's dQ (up to D
    160), each against its plain version at the fp32 bounds. D 48 runs on the D 64
    instance."""
    b, heads = 1, 2
    q, k, v, do = (randn((b, l, heads * d), s, cuda, FP32) for s in range(4))
    o, lse = fa.flash_attention(q, k, v, heads)
    o_ref, lse_ref = fa.attention_lse_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert fp32_close(o, o_ref) and (lse - lse_ref).abs().max().item() <= 1e-4
    qh, kh, vh, doh = (split_heads(x, heads) for x in (q, k, v, do))
    scale = -(d**-0.5)
    o5, m, lsum = fs.stock_flash_fwd(qh, kh, vh, scale)
    o5_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(qh, kh, vh, scale)
    assert fp32_close(o5, o5_ref) and (m - m_ref).abs().max().item() <= 1e-4
    assert ((lsum - l_ref).abs() / l_ref).max().item() <= 1e-4
    if d > fa.MAX_BWD_HEAD_DIM:
        return
    dcap = fa.attention_dcap(o, do, heads)
    grads = fa.flash_bwd_dkv(q, k, v, do, lse, dcap, heads)
    refs = fa.flash_bwd_dkv_plain(q, k, v, do, lse, dcap, heads)
    di = (o5 * doh).sum(-1)
    grads += fs.stock_flash_bwd_dkv(qh, kh, vh, doh, m, lsum, di, scale)
    refs += fs.stock_flash_bwd_dkv_plain(qh, kh, vh, doh, m, lsum, di, scale)
    grads += (fa.flash_bwd_dq(q, k, v, do, lse, dcap, heads),
              fs.stock_flash_bwd_dq(qh, kh, vh, doh, m, lsum, di, scale))
    refs += (fa.flash_bwd_dq_plain(q, k, v, do, lse, dcap, heads),
             fs.stock_flash_bwd_dq_plain(qh, kh, vh, doh, m, lsum, di, scale))
    torch.cuda.synchronize()
    for name, out, ref in zip(("K3 dK", "K3 dV", "K5 dK", "K5 dV", "K4 dQ", "K5 dQ"), grads,
                              refs):
        assert out.dtype == FP32 and torch.isfinite(out).all(), name
        assert (out - ref).abs().max().item() <= bound(ref, FP32), name
    assert fa.FP32_LAUNCHES == {"k1": 0, "k2": 1, "k3": 1, "k4": 1}
    assert fs.FP32_LAUNCHES == {"k5_fwd": 1, "k5_dkv": 1, "k5_dq": 1}


# the fp32 backward's D 160 instances (flash_bwd_dkv_d160_3xtf32_kernel,
# flash_bwd_dq_d160_3xtf32_kernel) at each head dim they take, zero filled to 160
FP32_BWD_D160 = {"k3": "flash_bwd_dkv_d160_3xtf32_kernel",
                 "k4": "flash_bwd_dq_d160_3xtf32_kernel"}


@pytest.mark.parametrize("q_mul", [1, 4])
@pytest.mark.parametrize("l", [2116, 333])
@pytest.mark.parametrize("d", [88, 96, 128, 152, 160])
def test_fp32_bwd_head_dims_88_to_160(cuda, d, l, q_mul):
    """The fp32 backward at D 88-160 (3xTF32 on wgmma, zero filled to 160) at ragged L
    (SD1.5's 1472² level 2, and a short one), 2 heads, q as drawn and scaled x4: K3's dK
    and dV and K4's dQ from K2's LSE, and K5's dK, dV and dQ from the K5 forward's m and
    l at the stock scale negated, each within 1e-4 * max(1, max|ref|) of its plain
    version."""
    b, heads = 1, 2
    q, k, v, do = (randn((b, l, heads * d), s, cuda, FP32) for s in range(4))
    q = q * q_mul
    o, lse = fa.flash_attention(q, k, v, heads)
    dcap = fa.attention_dcap(o, do, heads)
    qh, kh, vh, doh = (split_heads(x, heads) for x in (q, k, v, do))
    scale = -(d**-0.5)
    o5, m, lsum = fs.stock_flash_fwd(qh, kh, vh, scale)
    di = (o5 * doh).sum(-1)
    grads = (*fa.flash_bwd_dkv(q, k, v, do, lse, dcap, heads),
             fa.flash_bwd_dq(q, k, v, do, lse, dcap, heads),
             *fs.stock_flash_bwd_dkv(qh, kh, vh, doh, m, lsum, di, scale),
             fs.stock_flash_bwd_dq(qh, kh, vh, doh, m, lsum, di, scale))
    torch.cuda.synchronize()
    assert fa.FP32_LAUNCHES == {"k1": 0, "k2": 1, "k3": 1, "k4": 1}
    assert fs.FP32_LAUNCHES == {"k5_fwd": 1, "k5_dkv": 1, "k5_dq": 1}
    refs = (*fa.flash_bwd_dkv_plain(q, k, v, do, lse, dcap, heads),
            fa.flash_bwd_dq_plain(q, k, v, do, lse, dcap, heads),
            *fs.stock_flash_bwd_dkv_plain(qh, kh, vh, doh, m, lsum, di, scale),
            fs.stock_flash_bwd_dq_plain(qh, kh, vh, doh, m, lsum, di, scale))
    for name, out, ref in zip(("K3 dK", "K3 dV", "K4 dQ", "K5 dK", "K5 dV", "K5 dQ"), grads,
                              refs):
        assert out.shape == ref.shape and torch.isfinite(out).all(), name
        assert fp32_close(out, ref), name


def test_fp32_bwd_at_d160_runs_the_3xtf32_kernels(cuda):
    """At SD1.5's 1536² level 2 (1, 8, 2304, 160) the profiler sees K3 and K4 launch the
    D 160 3xTF32 instances, and no other backward kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = (randn((1, 2304, 8 * 160), s, cuda, FP32) for s in range(4))
    o, lse = fa.flash_attention(q, k, v, 8)
    dcap = fa.attention_dcap(o, do, 8)
    for name, fn in (("k3", fa.flash_bwd_dkv), ("k4", fa.flash_bwd_dq)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(q, k, v, do, lse, dcap, 8)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        assert any(FP32_BWD_D160[name] in n for n in names), (name, names)
        assert not any("flash_bwd" in n and FP32_BWD_D160[name] not in n for n in names), names


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("d", [0, 4, 516, 520])
def test_fwd_tiles_refuse_a_head_dim_no_instance_takes(cuda, d, dtype):
    with pytest.raises(ValueError, match="no K1/K2 instance"):
        fa.fwd_tiles(d, dtype)


def test_k1_k2_raise_on_misaligned_or_strided_inputs(cuda):
    """The tensor maps need a contiguous, 16-byte aligned projection: a view at a
    2-byte offset and a transposed view raise before any launch."""
    b, l, inner = 1, 256, 80
    flat = torch.zeros(b * l * inner + 8, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:1 + b * l * inner].view(b, l, inner)
    good = torch.zeros((b, l, inner), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, good, good, 2)
    strided = torch.zeros((b, inner, l), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.biased_attention(good, strided, good, 2)
    with pytest.raises(ValueError, match="aligned"):
        fa.biased_attention(good, good, good, 2, q_bias=shifted)
    # the fp32 route's plain 16-byte loads: a view 4 bytes off, a transposed view
    flat32 = torch.zeros(b * l * inner + 8, device=cuda)
    shifted32 = flat32[1:1 + b * l * inner].view(b, l, inner)
    good32 = torch.zeros((b, l, inner), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(good32, shifted32, good32, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.biased_attention(good32, good32, strided.float(), 2)
    assert fa.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    """fp16, and inputs of two dtypes, raise TypeError naming both routes."""
    q = torch.zeros((1, 64, 40), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q, q, q, 1)  # fp16
    with pytest.raises(TypeError, match="all of one dtype"):
        fa.flash_attention(q.float(), q.float(), q.bfloat16(), 1)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.biased_attention(q.float(), q.float(), q.float(), 1, q)  # an fp16 bias
    qh = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qh, qh, qh, 8)  # head dim 5
    with pytest.raises(ValueError):
        fa.biased_attention(qh, qh, qh, 1, torch.zeros((3, 64, 40), device=cuda,
                                                              dtype=torch.bfloat16))
    do = torch.zeros((1, 64, 8 * 168), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((8, 64), device=cuda)
    with pytest.raises(ValueError, match="up to 160, the widest UNet head"):
        fa.flash_bwd_dkv(do, do, do, do, lse, lse, 8)  # head dim 168
    with pytest.raises(TypeError):
        fa.flash_bwd_dq(q, q, q, q, lse[:1], lse[:1], 1)  # fp16
    with pytest.raises(ValueError, match="up to 160, the widest UNet head"):
        fa.flash_bwd_dq(do.float(), do.float(), do.float(), do.float(), lse, lse, 8)
    assert fa.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}


def bound(ref, dtype=BF16):
    """1e-2 (bf16) or 1e-4 (fp32) times max(1, max|ref|)."""
    return (1e-2 if dtype == BF16 else 1e-4) * max(1.0, ref.abs().max().item())


# SD1.5's level 2 at 1536² (L 2304) and 1472² (ragged 2116) at D 160, a short D 160
# L, and D 96 and 128 (jax's stock kernel takes both): the wide instances of both
# routes, zero filled to 160 below it
K3_K4_WIDE = [(1, 8, 2304, 160), (1, 8, 2116, 160), (1, 2, 333, 160), (1, 4, 1024, 96),
              (1, 4, 1024, 128)]
# the fp32 route at SD1.5's --mixed_precision no training shape, the smoke stacks' D 8
# and 16 at 512², D 32, 64 and 80, ragged and short L, and q scaled x4 (q_mul)
K3_K4_FP32 = [(8, 8, 4096, 40, 1, FP32), (2, 4, 4096, 8, 1, FP32), (2, 2, 4096, 16, 1, FP32),
              (2, 8, 4225, 40, 1, FP32), (2, 8, 1024, 40, 4, FP32), (1, 4, 333, 64, 1, FP32),
              (1, 8, 300, 80, 1, FP32), (2, 4, 40, 40, 1, FP32), (2, 4, 1000, 32, 4, FP32)] + [
              shape + (1, FP32) for shape in K3_K4_WIDE]


@pytest.mark.parametrize("b,heads,l,d,q_mul,dtype", [shape + (1, BF16) for shape in [
                                         (8, 8, 4096, 40), (2, 8, 2304, 80),
                                         (1, 8, 7744, 40), (2, 8, 4225, 40),
                                         (1, 8, 300, 80), (2, 8, 1024, 64),
                                         (1, 4, 333, 64), (2, 4, 40, 40), (1, 2, 40, 64),
                                         (1, 8, 4096, 40)] + K3_K4_WIDE] + K3_K4_FP32)
def test_k3_k4_match_plain(cuda, b, heads, l, d, q_mul, dtype):
    """dQ, dK, dV from O and LSE of K2, against the plain versions in fp32 on the
    same bf16 inputs and the same Dcap: the training shape (batch 8, and batch 1 of
    the canned train_canny task), the 384² and 704²
    latents, D 64 (the third instance of both kernels), ragged L (not a multiple of
    the 64-row tile: the kernels set P to 0 by index past L) and L 40, under one tile
    of 64 rows on the ring side and one 128-row stationary tile; the wide instances
    (K3_K4_WIDE). Then the fp32 route (K3_K4_FP32), counted in FP32_LAUNCHES as well."""
    q, k, v, do = (randn((b, l, heads * d), s, cuda, dtype) for s in range(4))
    q = q * q_mul
    o, lse = fa.flash_attention(q, k, v, heads)
    dcap = fa.attention_dcap(o, do, heads)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dcap, heads)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, dcap, heads)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"k1": 0, "k2": 1, "k3": 1, "k4": 1}
    n32 = int(dtype == FP32)
    assert fa.FP32_LAUNCHES == {"k1": 0, "k2": n32, "k3": n32, "k4": n32}
    args = [x.float() for x in (q, k, v, do)] + [lse, dcap]
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args, heads)
    ref_dq = fa.flash_bwd_dq_plain(*args, heads)
    for name, out, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert out.shape == ref.shape and out.dtype == dtype and torch.isfinite(out).all(), name
        assert (out.float() - ref).abs().max().item() <= bound(ref, dtype), name


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("b,heads,l,d", [(8, 8, 4096, 40), (2, 8, 4225, 40),
                                         (1, 8, 2304, 160)])
def test_flash_attention_grad_matches_plain_autograd(cuda, b, heads, l, d, dtype):
    """The repaired fault: long self-attention on the card used to return K2's
    output without a graph, dropping every gradient through it. Through
    dot_product_attention the gradients of q, k, v now exist and match the autograd
    of the plain fp32 attention on the same bf16 values: the training shape, a ragged
    L and SD1.5's level 2 at 1536² (D 160), in bf16 and in fp32 (the fp32 route)."""
    q, k, v, do = (randn((b, l, heads * d), s, cuda, dtype) for s in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    dot_product_attention(q, k, v, heads).backward(do)
    assert fa.LAUNCHES == {"k1": 0, "k2": 1, "k3": 1, "k4": 1}
    n32 = int(dtype == FP32)
    assert fa.FP32_LAUNCHES == {"k1": 0, "k2": n32, "k3": n32, "k4": n32}
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    qh, kh, vh = (split_heads(x, heads) for x in ref_in)
    ref = merge_heads(torch.softmax(qh @ kh.transpose(-1, -2) * d**-0.5, dim=-1) @ vh)
    ref.backward(do.float())
    for name, x, r in zip("qkv", (q, k, v), ref_in):
        assert x.grad is not None and x.grad.abs().max().item() > 0, name
        assert (x.grad.float() - r.grad).abs().max().item() <= bound(r.grad, dtype), name


# ---------------------------------------------------------------------------- K5

def heads_view(b, heads, l, d, seed, device, dtype=BF16):
    """A (B, H, L, D) head-split view of a (B, L, H*D) projection, as
    dot_product_attention hands it to K5 (no copy)."""
    return split_heads(randn((b, l, heads * d), seed, device, dtype), heads)


# the fp32 route: the stock step under --mixed_precision no (D 40) and its VAE encoder
# (D 512), a non-default and a negative scale, D 64 and 80, the smoke stacks' D 8
K5_FWD_FP32 = [(2, 8, 1024, 40, None, FP32), (4, 8, 4096, 40, None, FP32),
               (2, 4, 256, 80, 0.3, FP32), (2, 1, 4096, 512, None, FP32),
               (2, 8, 1024, 64, None, FP32), (2, 4, 256, 40, -0.2, FP32),
               (2, 4, 4096, 8, None, FP32)]


@pytest.mark.parametrize("b,heads,l,d,scale,dtype", [shape + (BF16,) for shape in [
                                               (2, 8, 1024, 40, None), (2, 4, 256, 80, 0.3),
                                               (1, 1, 1024, 512, None), (2, 8, 4096, 40, 0.3),
                                               (16, 1, 4096, 512, None), (2, 8, 1024, 64, None),
                                               (2, 4, 256, 40, -0.2)]] + K5_FWD_FP32)
def test_k5_fwd_matches_plain(cuda, b, heads, l, d, scale, dtype):
    """O, m and l of the stock forward against its plain version in fp32 on the same
    bf16 inputs, at the default, a non-default and a negative softmax scale, at the
    stock step's VAE encoder shape (D 512) and at D 64. Then the fp32 route
    (K5_FWD_FP32)."""
    scale = d**-0.5 if scale is None else scale
    q, k, v = (heads_view(b, heads, l, d, s, cuda, dtype) for s in range(3))
    fs.reset_launch_counts()
    o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {"k5_fwd": 1, "k5_dkv": 0, "k5_dq": 0}
    assert fs.FP32_LAUNCHES["k5_fwd"] == (dtype == FP32)
    o_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(q.float(), k.float(), v.float(), scale)
    assert o.stride() == q.stride()
    if dtype == FP32:
        assert fp32_close(o, o_ref)
        assert (m - m_ref).abs().max().item() <= 1e-4
        assert ((lsum - l_ref).abs() / l_ref).max().item() <= 1e-4
        return
    assert (o.float() - o_ref).abs().max().item() <= 1e-2
    assert ((m - m_ref).abs() / m_ref.abs().clamp(min=1)).max().item() <= 1e-3
    assert ((lsum - l_ref).abs() / l_ref).max().item() <= 1e-3


@pytest.mark.parametrize("q_layout,lq,lk,d", [("contiguous", 1024, 1024, 40),
                                              ("contiguous", 512, 2048, 80),
                                              ("projection", 2048, 512, 64),
                                              ("contiguous", 256, 1024, 512)])
def test_k5_fwd_takes_any_layout(cuda, q_layout, lq, lk, d):
    """The forward reads (B, H, L, D) tensors by their strides: q as a contiguous
    tensor (strides of H above those of L) or a projection's head-split view, k and v
    in the other layout, Lq != Lk. O comes back with q's strides."""
    b, heads, scale = 2, 4, 0.125

    def make(length, layout, seed):
        x = heads_view(b, heads, length, d, seed, cuda)
        return x.contiguous() if layout == "contiguous" else x

    k_layout = "projection" if q_layout == "contiguous" else "contiguous"
    q = make(lq, q_layout, 0)
    k, v = make(lk, k_layout, 1), make(lk, k_layout, 2)
    assert q.stride() != k.stride()
    o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["k5_fwd"] == 1
    o_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(q.float(), k.float(), v.float(), scale)
    assert o.stride() == q.stride()
    assert (o.float() - o_ref).abs().max().item() <= 1e-2
    assert ((m - m_ref).abs() / m_ref.abs().clamp(min=1)).max().item() <= 1e-3
    assert ((lsum - l_ref).abs() / l_ref).max().item() <= 1e-3


@pytest.mark.parametrize("b,heads,l,d,scale,layout,dtype", [shape + (BF16,) for shape in [
    (2, 8, 1024, 40, None, "projection"), (2, 8, 2304, 80, 0.3, "projection"),
    (2, 8, 4096, 40, 0.3, "projection"), (2, 8, 1024, 40, -0.3, "projection"),
    (2, 4, 1024, 64, None, "projection"), (2, 8, 1024, 40, 0.3, "contiguous"),
    (2, 4, 512, 80, -0.2, "contiguous")]] + [
    (4, 8, 4096, 40, None, "projection", FP32), (2, 8, 1024, 40, -0.3, "projection", FP32),
    (2, 4, 1024, 64, 0.3, "contiguous", FP32), (2, 4, 512, 80, -0.2, "contiguous", FP32),
    (2, 4, 1024, 16, None, "projection", FP32)] + [
    (2, 4, 1024, 128, 0.3, "projection", dtype) for dtype in (BF16, FP32)])
def test_k5_bwd_matches_plain(cuda, b, heads, l, d, scale, layout, dtype):
    """dK/dV and dQ of the stock backward (K3's and K4's kernels, forming m + log l)
    from the K5 forward's m and l, against the plain versions in fp32 on the same bf16
    inputs and the same di: the default, a non-default and a negative scale, D 40, 64
    and 80, and 128 (the widest head jax's stock kernel takes at any length: the wide
    instances), head-split views of the projections and contiguous (B, H, L, D)
    tensors. The gradients come back with the strides of their inputs. Then the fp32
    route."""
    scale = d**-0.5 if scale is None else scale
    q, k, v, do = (heads_view(b, heads, l, d, s, cuda, dtype) for s in range(4))
    if layout == "contiguous":
        q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    fs.reset_launch_counts()
    o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fs.stock_flash_bwd_dkv(q, k, v, do, m, lsum, di, scale)
    dq = fs.stock_flash_bwd_dq(q, k, v, do, m, lsum, di, scale)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {"k5_fwd": 1, "k5_dkv": 1, "k5_dq": 1}
    n32 = int(dtype == FP32)
    assert fs.FP32_LAUNCHES == {"k5_fwd": n32, "k5_dkv": n32, "k5_dq": n32}
    assert dq.stride() == q.stride() and dk.stride() == dv.stride() == k.stride()
    args = [x.float() for x in (q, k, v, do)] + [m, lsum, di, scale]
    ref_dk, ref_dv = fs.stock_flash_bwd_dkv_plain(*args)
    ref_dq = fs.stock_flash_bwd_dq_plain(*args)
    for name, out, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert out.shape == ref.shape and out.dtype == dtype and torch.isfinite(out).all(), name
        assert (out.float() - ref).abs().max().item() <= bound(ref, dtype), name


@pytest.mark.parametrize("route", ["backend", "env"])
def test_k5_grad_through_dot_product_attention(cuda, route, monkeypatch):
    """backend="flash_stock", or CONTROLLORA_FLASH_IMPL=stock under "auto", sends long
    self-attention on the card through K5 (and not K2-K4); the gradients match the
    autograd of the plain fp32 attention."""
    b, heads, l, d = 2, 8, 4096, 40
    q, k, v, do = (randn((b, l, heads * d), s, cuda) for s in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fs.reset_launch_counts()
    if route == "env":
        monkeypatch.setenv("CONTROLLORA_FLASH_IMPL", "stock")
        out = dot_product_attention(q, k, v, heads)
    else:
        out = dot_product_attention(q, k, v, heads, backend="flash_stock")
    out.backward(do)
    assert fs.LAUNCHES == {"k5_fwd": 1, "k5_dkv": 1, "k5_dq": 1}
    assert fa.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    qh, kh, vh = (split_heads(x, heads) for x in ref_in)
    ref = merge_heads(torch.softmax(qh @ kh.transpose(-1, -2) * d**-0.5, dim=-1) @ vh)
    ref.backward(do.float())
    assert (out.float() - ref).abs().max().item() <= 1e-2
    for name, x, r in zip("qkv", (q, k, v), ref_in):
        assert x.grad is not None and x.grad.abs().max().item() > 0, name
        assert (x.grad.float() - r.grad).abs().max().item() <= bound(r.grad), name


def test_k5_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = heads_view(1, 2, 4225, 40, 0, cuda)
    with pytest.raises(ValueError, match="power-of-two"):
        fs.stock_flash_attention(q, q, q, 0.1)  # L 4225: no stock block
    q = heads_view(1, 2, 256, 40, 0, cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fs.stock_flash_fwd(q.half(), q.half(), q.half(), 0.1)  # fp16
    with pytest.raises(TypeError, match="all of one dtype"):
        fs.stock_flash_fwd(q.float(), q, q, 0.1)
    w = heads_view(1, 2, 256, 168, 1, cuda)
    rows = torch.zeros((1, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="<= 160: the widest UNet head"):
        fs.stock_flash_bwd_dq(w, w, w, w, rows, rows, rows, 0.1)  # head dim 168
    with pytest.raises(ValueError, match="strides"):
        fs.stock_flash_fwd(q, q.contiguous(), q, 0.1)  # k and v in different layouts
    with pytest.raises(ValueError, match="<= 160: the widest UNet head"):
        fs.stock_flash_bwd_dkv(w, w, w, w, rows, rows, rows, 0.1)  # head dim 168
    with pytest.raises(TypeError):
        qf = q.half()
        fs.stock_flash_bwd_dkv(qf, qf, qf, qf, rows, rows, rows, 0.1)  # fp16
    with pytest.raises(ValueError, match="<= 160: the widest UNet head"):
        fs.stock_flash_bwd_dq(w.float(), w.float(), w.float(), w.float(), rows, rows, rows, 0.1)
    with pytest.raises(ValueError, match="strides"):
        fs.stock_flash_bwd_dq(q, q, q, q.contiguous(), rows, rows, rows, 0.1)  # dO's layout
    assert fs.LAUNCHES == {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}


def test_bwd_wrappers_raise_on_misaligned_views(cuda):
    """The backward's tensor maps need 16-byte aligned bases and strides: a projection
    at a 2-byte offset (K3/K4) and a head-split view at one (K5) raise before any
    launch, as do fp32 rows for K3/K4."""
    b, heads, l, d = 1, 2, 256, 40
    flat = torch.zeros(b * l * heads * d + 8, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:1 + b * l * heads * d].view(b, l, heads * d)
    good = torch.zeros((b, l, heads * d), device=cuda, dtype=torch.bfloat16)
    rows = torch.zeros((b * heads, l), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_bwd_dkv(good, shifted, good, good, rows, rows, heads)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_bwd_dq(good, good, good, shifted, rows, rows, heads)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_bwd_dq(good, good, good, good, rows.double(), rows, heads)
    sq, gq = split_heads(shifted, heads), split_heads(good, heads)
    stock_rows = rows.view(b, heads, l)
    with pytest.raises(ValueError, match="aligned"):
        fs.stock_flash_bwd_dkv(sq, sq, sq, sq, stock_rows, stock_rows, stock_rows, 0.1)
    with pytest.raises(ValueError, match="aligned"):
        fs.stock_flash_bwd_dq(gq, sq, sq, gq, stock_rows, stock_rows, stock_rows, 0.1)
    assert fa.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    assert fs.LAUNCHES == {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}


@pytest.mark.parametrize("size", [512, 1024])
def test_canny_on_card_equals_cpu(cuda, size):
    """The Canny annotator on a CUDA tensor stays on the card and gives the CPU's
    edge map exactly (procedural images of process/diffusiondb_canny), at the three
    threshold pairs of tests/test_annotators.py, one image and a batch of two."""
    from controllora_tpu_torch.annotators import canny
    from controllora_tpu_torch.data.process_datasets import _procedural_image

    imgs = torch.from_numpy(np.stack([_procedural_image(i, size) for i in (0, 1)]))
    for lo, hi in ((50, 150), (100, 200), (30, 80)):
        ref = canny(imgs, lo, hi)
        out = canny(imgs.to(cuda), lo, hi)
        assert out.device.type == "cuda" and torch.equal(out.cpu(), ref)
        assert torch.equal(canny(imgs[0].to(cuda), lo, hi).cpu(), ref[0])
        assert ref.float().mean() > 1.0  # edges fired
