"""The arithmetic of the fp32 route's 3xTF32 kernels, emulated on the CPU.

Every fp32 flash kernel (csrc/flash_attn_fp32.cu: the forward, dK/dV and dQ) multiplies
on the tensor cores, which read tf32 operands: 1 sign, 8 exponent and 10 stored
mantissa bits. Each fp32 operand x is split into hi = x with its 13 low mantissa bits
dropped and lo = tf32_rna(x - hi) (x - hi is exact in fp32; cvt.rna.tf32.f32 rounds to
nearest, ties away from zero), and a product a*b is taken as lo_a*hi_b + hi_a*lo_b +
hi_a*hi_b: the split of P and dS in registers, of Q, K, V, dO and their transposes by
the producer warpgroups (or, for Q and dO in dQ up to D 80 and for the stationary
operands at D 88-160, in registers by the consumers). Here the same split
is done in plain torch, every product of tf32 values is exact in float64 (22
significant bits), and attention runs through it at each head dim of the fp32 paths (8,
16, 32, 40, 64, 80, the D 88-160 instances' 96, 128 and 160, zero filled to 160 as they
are, and the VAE's 512) at a small length, with q as drawn and scaled x4
(a peaked softmax): the forward (S = Q K^T, O = P V), the products of dK/dV (S^T = K
Q^T, dP^T = V dO^T, dV = P^T dO, dK = dS^T Q) and the chain of dQ (S = Q K^T, dP = dO
V^T, dS in fp32, dQ = dS K * scale) against float64. Three products stay within the fp32
route's bound, 1e-4 * max(1, max|ref|) on every output
(tests/test_torch_kernels_gpu.py, chip_smoke.py); one TF32 product (both operands
rounded, tf32_rna) misses it, which is why the kernels issue three.
"""

import numpy as np
import pytest
import torch

B, H, L = 1, 2, 256
BOUND = 1e-4  # the fp32 route's: 1e-4 * max(1, max|ref|)
DIMS = [8, 16, 32, 40, 64, 80, 96, 128, 160, 512]
WIDE = 160  # heads of 88-160 run zero filled to 160


def tf32_rna(x):
    """x (fp32) rounded to tf32: to nearest, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) of fp32 x as the kernels split it, each a tf32 value in fp32."""
    hi = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b of fp32 tensors as three tf32 products (lo*hi + hi*lo + hi*hi), each
    product exact and every sum in float64."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    d = torch.float64
    return al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d) + ah.to(d) @ bh.to(d)


def mm_tf32(a, b):
    """a @ b as one tf32 product: both operands rounded, the product exact."""
    return tf32_rna(a.float()).double() @ tf32_rna(b.float()).double()


def attention(q, k, v, do, mm, scale):
    """O, and dK, dV from P and dS formed in float64 from S^T and dP^T taken by `mm`
    (the dK/dV kernel's products, keys as rows); fp32 where the kernels hold fp32."""
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = mm(p.float(), v)
    st = mm(k, q.transpose(-1, -2)) * scale
    pt = torch.softmax(st, dim=-2)  # P^T: the softmax runs over keys, the rows here
    dpt = mm(v, do.transpose(-1, -2))
    ref_o = (torch.softmax(q.double() @ k.double().transpose(-1, -2) * scale, -1)
             @ v.double())
    dcap = (do.double() * ref_o).sum(-1)  # as the caller hands it, fp32
    dst = pt * (dpt - dcap.float().double()[..., None, :])
    dv = mm(pt.float(), do)
    dk = mm(dst.float(), q) * scale
    return o, dk, dv


def reference(q, k, v, do, scale):
    q, k, v, do = (x.double() for x in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = p @ v
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return o, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def inputs(d, q_mul, seed=16):
    rng = np.random.default_rng(seed + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, d)).astype(np.float32))
                   for _ in range(4))
    return q * q_mul, k, v, do


def zero_filled(d, *xs):
    """The operands as the kernel instance of head dim d reads them: heads of 88-160
    with zero columns up to 160."""
    pad = WIDE - d if 80 < d < WIDE else 0
    return [torch.nn.functional.pad(x, (0, pad)) for x in xs]


def errors(out, ref):
    """max|out - ref| over max(1, max|ref|), per output."""
    return [float((o - r).abs().max()) / max(1.0, float(r.abs().max()))
            for o, r in zip(out, ref)]


def test_split_is_exact_to_about_2_to_the_minus_21():
    """hi + lo recovers x to within 2^-21 |x| (hi carries 11 significant bits, lo the
    next 11 after rounding), and both parts are tf32 values: their 13 low bits are 0."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    x = x * torch.exp2(torch.from_numpy(np.random.default_rng(1).integers(-20, 20, 100_000)))
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0**-21
    assert (hi.abs() <= x.abs()).all()  # a truncation, toward zero


@pytest.mark.parametrize("q_mul", [1, 4])
@pytest.mark.parametrize("d", DIMS)
def test_three_tf32_products_hold_the_fp32_bound_and_one_does_not(d, q_mul):
    """O, dK and dV through 3xTF32 within 1e-4 * max(1, max|ref|) of float64; through
    one TF32 product at least one of them outside it."""
    q, k, v, do = inputs(d, q_mul)
    scale = d**-0.5
    ref = reference(q, k, v, do, scale)
    wide = zero_filled(d, q, k, v, do)
    three = errors([x[..., :d] for x in attention(*wide, mm_3xtf32, scale)], ref)
    one = errors([x[..., :d] for x in attention(*wide, mm_tf32, scale)], ref)
    assert max(three) <= BOUND, f"3xTF32 O, dK, dV: {three}"
    assert max(one) > BOUND, f"one TF32 product O, dK, dV: {one}"


def dq_chain(q, k, v, do, mm, scale):
    """dQ in the dQ kernel's order: S = Q K^T and dP = dO V^T taken by `mm` (unscaled),
    P = exp(S * scale - LSE) and dS = P (dP - Dcap) in fp32 from the caller's fp32 LSE
    and Dcap, then dQ = dS K * scale by `mm`."""
    s = mm(q, k.transpose(-1, -2)).float()
    dp = mm(do, v.transpose(-1, -2)).float()
    s64 = q.double() @ k.double().transpose(-1, -2) * scale
    lse = torch.logsumexp(s64, -1).float()  # as K2 hands it, fp32
    dcap = (do.double() * (torch.softmax(s64, -1) @ v.double())).sum(-1).float()
    ds = torch.exp(s * scale - lse[..., None]) * (dp - dcap[..., None])
    return mm(ds, k) * scale


def reference_dq(q, k, v, do, scale):
    q, k, v, do = (x.double() for x in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    ds = p * (do @ v.transpose(-1, -2) - (do * (p @ v)).sum(-1, keepdim=True))
    return ds @ k * scale


@pytest.mark.parametrize("q_mul", [1, 4])
@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 80, 96, 128, 160])
def test_dq_chain_holds_the_fp32_bound_through_3xtf32_and_not_through_one(d, q_mul):
    """dQ through the dQ kernel's chain of three 3xTF32 products within 1e-4 *
    max(1, max|ref|) of float64; through one TF32 product each, outside it."""
    q, k, v, do = inputs(d, q_mul)
    scale = d**-0.5
    ref = reference_dq(q, k, v, do, scale)
    wide = zero_filled(d, q, k, v, do)
    three = errors([dq_chain(*wide, mm_3xtf32, scale)[..., :d]], ref[None])[0]
    one = errors([dq_chain(*wide, mm_tf32, scale)[..., :d]], ref[None])[0]
    assert three <= BOUND, f"3xTF32 dQ: {three}"
    assert one > BOUND, f"one TF32 product dQ: {one}"
