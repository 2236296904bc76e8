"""The plain versions of the port's flash kernels K1-K4, and the ``FlashAttention``
autograd Function, against the JAX Pallas kernels, which run here in interpret mode
(as tests/test_pallas_attention.py runs them). Inputs come from a numpy seed; in
fp32, atol 2e-5 (forward) and 1e-4 * max(1, max|ref|) (gradients) cover the
different summation orders (online softmax over blocks vs one softmax); bf16 outputs
get 1e-2 * max(1, max|ref|), about two bf16 ulps.

The kernels themselves run only on the card: tests/test_torch_kernels_gpu.py. The
card runs each kernel on bf16 inputs (the bf16 route) or on fp32 inputs (the fp32
route, csrc/flash_attn_fp32.cu); here the plain versions are held in fp32 at the head
dims of both, the smoke stacks' 8, 16 and 32 among them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu_torch.ops import flash_attention as fa
from controllora_tpu_torch.ops.attention import dot_product_attention, split_heads

ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    fa.reset_launch_counts()
    with torch.enable_grad():  # whatever an earlier test file left (see test_torch_flash_stock.py)
        yield
    # on CPU tensors every wrapper takes its plain version: nothing launched
    assert set(fa.LAUNCHES) == set(fa.FP32_LAUNCHES) == {"k1", "k2", "k3", "k4"}
    assert all(n == 0 for n in fa.LAUNCHES.values()), fa.LAUNCHES
    assert all(n == 0 for n in fa.FP32_LAUNCHES.values()), fa.FP32_LAUNCHES


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("d", [8, 16, 32, 40, 80])
def test_k1_plain_matches_flash_attention_fwd(d):
    """Exact tiling: the JAX kernel at blocks of 64, no biases; the smoke stacks' head
    dims 8, 16 (UNet) and 32 (VAE) beside SD1.5's 40 and 80."""
    from controllora_tpu.ops.pallas_attention import flash_attention_fwd

    q, k, v = (rand((4, 128, d), s) for s in range(3))
    ref = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64)
    # (BH, L, D) is the (B, L, H*D) layout with one head
    out = fa.biased_attention(t(q), t(k), t(v), heads=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("l", [96, 288, 144])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("kv_biases", [False, True])
def test_k1_plain_matches_biased_attention(l, d, kv_biases):
    """Ragged L (pad + in-kernel KV mask on the JAX side), 2 heads, q/k/v biases of
    batch 1 broadcast over the CFG batch 2; D 160 is SD1.5's level 2, which serving at
    1472² and above sends to K1."""
    from controllora_tpu.ops.pallas_attention import biased_attention

    heads = 2
    q, k, v = (rand((2, l, heads * d), s) for s in range(3))
    qb, kb, vb = (rand((1, l, heads * d), s) for s in range(3, 6))
    if not kv_biases:
        kb = vb = None
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    ref = biased_attention(j(q), j(k), j(v), heads, j(qb), j(kb), j(vb))
    out = fa.biased_attention(t(q), t(k), t(v), heads, t(qb),
                              None if kb is None else t(kb),
                              None if vb is None else t(vb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_k1_plain_matches_biased_attention_at_smoke_head_dims(d):
    """The fp32 smoke stacks' K1 at 512² runs at head dims 8 (smoke) and 16 (smoke2):
    ragged L, 4 heads, q/k/v biases of batch 1 over the CFG batch 2, added in fp32 on
    both sides."""
    from controllora_tpu.ops.pallas_attention import biased_attention

    heads, l = 4, 200
    q, k, v = (rand((2, l, heads * d), s) for s in range(3))
    qb, kb, vb = (rand((1, l, heads * d), s) for s in range(3, 6))
    j = jnp.asarray
    ref = biased_attention(j(q), j(k), j(v), heads, j(qb), j(kb), j(vb))
    out = fa.biased_attention(t(q), t(k), t(v), heads, t(qb), t(kb), t(vb))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_k1_per_image_biases_tile():
    """Bias batch n under a 2n batch tiles: rows i and n + i share bias i."""
    q, k, v = (rand((4, 64, 16), s) for s in range(3))
    qb = rand((2, 64, 16), 9)
    out = fa.biased_attention(t(q), t(k), t(v), 2, t(qb))
    ref = fa.biased_attention(t(q), t(k), t(v), 2, t(np.concatenate([qb, qb])))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("l,d", [(128, 40), (96, 40), (288, 80), (144, 512), (128, 8),
                                 (96, 16), (160, 32), (256, 160), (300, 160), (256, 96),
                                 (256, 128)])
def test_k2_plain_matches_fwd(l, d):
    """O and LSE of the JAX forward kernel; ragged L runs it padded to blocks of 64
    with kv_valid masking, then slices. D 8, 16 and 32: the fp32 smoke stacks' UNet
    and VAE; D 160: SD1.5's level 2, whose forward the backward below needs, also at a
    ragged L; D 96 and 128: heads the card's DS 160 instance takes zero filled."""
    from controllora_tpu.ops.pallas_attention_vjp import _fwd

    q, k, v = (rand((2, l, d), s) for s in range(3))
    pad = (-l) % 64
    p = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0)))  # noqa: E731
    o_ref, lse_ref = _fwd(p(q), p(k), p(v), 64, 64, interpret=True,
                          kv_valid=l if pad else None)
    o, lse = fa.flash_attention(t(q), t(k), t(v), heads=1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref)[:, :l], atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :l, 0], atol=ATOL)


def test_k2_plain_multihead_layout():
    """(B, L, H*D) with H heads equals the per-head (B*H, L, D) computation; LSE
    rows are ordered b * H + h."""
    b, h, l, d = 2, 3, 40, 16
    q, k, v = (rand((b, l, h * d), s) for s in range(3))
    o, lse = fa.flash_attention(t(q), t(k), t(v), heads=h)

    def split(x):
        return t(x).reshape(b, l, h, d).permute(0, 2, 1, 3).reshape(b * h, l, d)

    o1, lse1 = fa.flash_attention(split(q), split(k), split(v), heads=1)
    merged = o1.reshape(b, h, l, d).permute(0, 2, 1, 3).reshape(b, l, h * d)
    np.testing.assert_allclose(o.numpy(), merged.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse1.numpy(), atol=1e-6)


def test_dot_product_attention_matches_jax():
    """The plain attention op (cross attention, short self-attention) in fp32."""
    from controllora_tpu.ops.attention import dot_product_attention as j_dpa

    q = rand((2, 64, 32), 0)
    kv = rand((2, 77, 32), 1), rand((2, 77, 32), 2)
    ref = j_dpa(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]), heads=4)
    out = dot_product_attention(t(q), t(kv[0]), t(kv[1]), heads=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_long_self_attention_stays_plain_on_cpu():
    """L >= 2048 routes to K2 only for CUDA tensors."""
    q = t(rand((1, 2048, 8), 0))
    out = dot_product_attention(q, q, q, heads=1)
    assert out.shape == (1, 2048, 8)


def assert_grad_close(out, ref, what, rel):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rel * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"{what}: max|delta| {err} > {bound}"


def jnp_to_np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 40, 80, 96, 160])
@pytest.mark.parametrize("l", [256, 300])
def test_k3_k4_plain_match_jax_bwd(l, d, dtype):
    """dQ (K4), dK and dV (K3) of the plain versions against the JAX backward: the
    Pallas `_bwd` kernels straight at L 256 (blocks of 64), and the VJP of
    `flash_attention_padded` at the ragged L 300 (padded to 320, KV-masked); D 8 and
    16 are the fp32 smoke stacks' training head dims, 160 SD1.5's level 2 (trained from
    1472² up), 96 a head the wide instances zero fill to 160."""
    from controllora_tpu.ops.pallas_attention_vjp import _bwd, _fwd, flash_attention_padded

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, do = (rand((2, l, d), s) for s in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    if l % 64 == 0:
        o, lse = _fwd(jq, jk, jv, 64, 64, interpret=True)
        refs = _bwd(64, 64, True, None, (jq, jk, jv, o, lse), jdo)
    else:
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_padded(a, b, c, 64, 64, True),
                         jq, jk, jv)
        refs = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(jnp_to_np(x)).to(tdt) for x in (jq, jk, jv, jdo))
    o, lse = fa.flash_attention(tq, tk, tv, heads=1)
    dcap = fa.attention_dcap(o, tdo, heads=1)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tdo, lse, dcap, heads=1)
    dq = fa.flash_bwd_dq(tq, tk, tv, tdo, lse, dcap, heads=1)
    rel = 1e-4 if dtype == "float32" else 1e-2
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert out.dtype == tdt, name
        assert_grad_close(out.float().numpy(), jnp_to_np(ref), name, rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_dtype_takes_the_two_routes(dtype):
    """bf16 inputs take the bf16 kernels and fp32 inputs the fp32 ones (None, a
    missing bias, is skipped)."""
    x = torch.zeros((1, 4, 8), dtype=dtype)
    assert fa.kernel_dtype(("q", x), ("k", x), ("v", x), ("q_bias", None)) == dtype


@pytest.mark.parametrize("dtypes", [(torch.float16,) * 3, (torch.float64,) * 3,
                                    (torch.float32, torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float16, torch.bfloat16)],
                         ids=["fp16", "fp64", "fp32+bf16", "bf16+fp16"])
def test_kernel_dtype_refuses_with_the_reason(dtypes):
    """fp16 (no JAX CLI builds an fp16 stack), fp64, and inputs of two dtypes raise
    TypeError naming both routes and every input's dtype."""
    named = [(n, torch.zeros((1, 4, 8), dtype=dt)) for n, dt in zip("qkv", dtypes)]
    with pytest.raises(TypeError, match="bfloat16 or float32 inputs, all of one dtype") as e:
        fa.kernel_dtype(*named)
    assert all(str(dt) in str(e.value) for dt in dtypes)


def test_vector_geometry_of_the_fp32_route():
    """The fp32 kernels read (B, H, L, D) fp32 tensors in 16-byte units (TMA, and the
    dQ kernel's cp.async): the projection's head-split view gives its element strides
    (D, H*D, L*H*D); a base 4 bytes off, a D of 4k + 2 and a strided last dim raise
    before any launch."""
    x = torch.zeros((2, 333, 4 * 40))
    assert fa.vector_geometry(split_heads(x, 4)) == ((40, 4, 333, 2), (40, 160, 333 * 160))
    base = torch.zeros(2 * 64 * 40 + 4)
    with pytest.raises(ValueError, match="aligned"):
        fa.vector_geometry(base[1:1 + 2 * 64 * 40].view(1, 2, 64, 40))
    with pytest.raises(ValueError, match="multiple of 4"):
        fa.vector_geometry(torch.zeros((1, 2, 64, 6)))
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.vector_geometry(torch.zeros((1, 2, 64, 64)).transpose(2, 3))


def test_flash_attention_vjp_matches_jax():
    """FlashAttention (K2 forward, K3 + K4 backward) on the CPU against jax.vjp of
    `flash_attention_padded`: (B, L, H*D) layout with 2 heads, ragged L."""
    from controllora_tpu.ops.pallas_attention_vjp import flash_attention_padded

    b, h, l, d = 2, 2, 300, 40
    q, k, v, do = (rand((b, l, h * d), s) for s in range(4, 8))

    def bhld(x):  # (B, L, H*D) -> (B*H, L, D)
        return jnp.asarray(x).reshape(b, l, h, d).transpose(0, 2, 1, 3).reshape(b * h, l, d)

    def blhd(x):  # (B*H, L, D) -> (B, L, H*D)
        return np.asarray(x).reshape(b, h, l, d).transpose(0, 2, 1, 3).reshape(b, l, h * d)

    ref_o, vjp = jax.vjp(lambda a, c, e: flash_attention_padded(a, c, e, 64, 64, True),
                         bhld(q), bhld(k), bhld(v))
    refs = vjp(bhld(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(tq, tk, tv, h)
    out.backward(t(do))
    np.testing.assert_allclose(out.detach().numpy(), blhd(ref_o), atol=ATOL)
    for name, x, ref in zip("qkv", (tq, tk, tv), refs):
        assert_grad_close(x.grad.numpy(), blhd(ref), f"d{name}", 1e-4)


def test_flash_attention_double_backward_raises():
    """The backward kernels build no graph: a second-order gradient through
    FlashAttention raises instead of coming back silently wrong."""
    q = t(rand((1, 64, 16), 8)).requires_grad_()
    w = t(rand((1, 64, 16), 9)).requires_grad_()
    out = fa.FlashAttention.apply(q, q, q, 2)
    (dq,) = torch.autograd.grad(out, q, grad_outputs=w, create_graph=True)
    with pytest.raises(RuntimeError, match="twice|once"):
        dq.sum().backward()


@pytest.mark.parametrize("b,l,heads,d", [(2, 4096, 8, 40), (8, 4096, 1, 512), (1, 333, 4, 80)])
def test_tma_geometry_of_the_projection_layout(b, l, heads, d):
    """K1/K2's tensor maps read a (B, L, H*D) bf16 projection as (D, H, L, B): the byte
    strides of H, L and B are 2D, 2HD and 2LHD, all multiples of 16 for D % 8 == 0."""
    x = torch.zeros((b, l, heads * d), dtype=torch.bfloat16)
    dims, strides = fa.tma_geometry(x, heads)
    assert dims == (d, heads, l, b)
    assert strides == (2 * d, 2 * heads * d, 2 * l * heads * d)
    # the (d, h, l, b) element sits at the byte offset the strides give
    flat = torch.arange(x.numel(), dtype=torch.float32).reshape(x.shape)
    i = (d - 1, heads - 1, l // 2, b - 1)
    offset = i[0] * 2 + sum(c * s for c, s in zip(i[1:], strides))
    assert flat[i[3], i[2], i[1] * d + i[0]].item() == offset // 2


def test_tma_geometry_refuses_what_a_tensor_map_cannot_read():
    heads = 2
    base = torch.zeros(4 * 64 * 80 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.tma_geometry(base[1:1 + 4 * 64 * 80].view(4, 64, 80), heads)  # 2-byte offset
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_geometry(torch.zeros((4, 80, 64), dtype=torch.bfloat16).transpose(1, 2), heads)
    with pytest.raises(ValueError, match="multiple"):
        fa.tma_geometry(torch.zeros((4, 64, 8), dtype=torch.bfloat16), heads)  # D 4: 8 bytes


@pytest.mark.parametrize("layout,shape", [("contiguous", (2, 8, 256, 40)),
                                          ("projection", (2, 8, 256, 40)),
                                          ("contiguous", (16, 1, 64, 512)),
                                          ("projection", (3, 4, 333, 80))])
def test_head_geometry_of_k5_views(layout, shape):
    """K5 hands its (B, H, L, D) inputs to the stride-general tensor-map encoder by
    their strides: a contiguous tensor (strides of H above those of L) or the head-split
    view of a (B, L, H*D) projection, for which head_geometry gives tma_geometry's
    numbers. The (d, h, l, b) element sits at the byte offset the strides give."""
    b, h, length, d = shape
    if layout == "contiguous":
        flat = torch.arange(b * h * length * d, dtype=torch.float32).reshape(shape)
    else:
        flat = split_heads(torch.arange(b * h * length * d, dtype=torch.float32)
                           .reshape(b, length, h * d), h)
        proj = torch.zeros((b, length, h * d), dtype=torch.bfloat16)
        assert fa.head_geometry(split_heads(proj, h)) == fa.tma_geometry(proj, h)
    x = torch.zeros_like(flat, dtype=torch.bfloat16)  # the same strides in bf16
    assert x.stride() == flat.stride()
    dims, strides = fa.head_geometry(x)
    assert dims == (d, h, length, b)
    sb, sh, sl, _ = flat.stride()
    assert strides == (2 * sh, 2 * sl, 2 * sb)
    i = (d - 1, h - 1, length // 2, b - 1)
    offset = i[0] * 2 + sum(c * st for c, st in zip(i[1:], strides))
    assert flat[i[3], i[1], i[2], i[0]].item() == offset // 2


def test_head_geometry_refuses_what_a_tensor_map_cannot_read():
    """What the K5 wrapper refuses with ValueError before any launch: a strided last
    dim, a head dim or stride that is no multiple of 16 bytes, a base off 16 bytes, a
    tensor that is not (B, H, L, D)."""
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.head_geometry(torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16).transpose(2, 3))
    with pytest.raises(ValueError, match="multiple"):  # rows 44 wide: 88-byte strides
        fa.head_geometry(torch.zeros((1, 2, 64, 44), dtype=torch.bfloat16)[..., :40])
    with pytest.raises(ValueError, match="multiple"):  # D 4: 8 bytes
        fa.head_geometry(torch.zeros((1, 2, 64, 4), dtype=torch.bfloat16))
    base = torch.zeros(2 * 64 * 40 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.head_geometry(base[1:1 + 2 * 64 * 40].view(1, 2, 64, 40))
    with pytest.raises(ValueError, match=r"\(B, H, L, D\)"):
        fa.head_geometry(torch.zeros((2, 64, 40), dtype=torch.bfloat16))


# (rows, keys, most splits) of K1/K2's bf16 instances: D 168-512, up to 80, 88-160
WIDE, NARROW, D160 = (64, 32, 8), (128, 64, 1), (192, 64, 8)


@pytest.mark.parametrize("bh,l,tiles,sms,want", [
    (1, 4096, WIDE, 132, 2),    # the VAE's batch-1 head: 64 query tiles for 132 SMs
    (8, 4096, WIDE, 132, 1),    # training batch 8: 512 tiles fill the card
    (16, 4096, NARROW, 132, 1),  # an instance that takes no split never splits
    (1, 1000, WIDE, 132, 8),    # 16 tiles: at most 8 splits
    (1, 200, WIDE, 132, 1),     # 7 key tiles: fewer than 4 a split
    (1, 300, WIDE, 132, 2),     # 10 key tiles: 2 splits of at least 4
    (8, 2304, D160, 132, 1),    # SD1.5 1536² level 2: 96 query tiles, one wave
    (1, 2304, D160, 132, 8),    # one head: 12 tiles, 11 by the SMs, at most 8 splits
    (1, 2116, D160, 132, 7),    # 1472² level 2, one head: 34 key tiles; 8 leave one empty
])
def test_kv_splits_plan(bh, l, tiles, sms, want):
    splits = fa.kv_splits(bh, l, l, tiles, sms)
    assert splits == want
    rows, keys, _ = tiles
    n_tiles = -(-l // keys)
    per = -(-n_tiles // splits)
    assert (splits - 1) * per < n_tiles  # no split is empty
    assert splits * bh * -(-l // rows) <= max(sms, bh * -(-l // rows))
