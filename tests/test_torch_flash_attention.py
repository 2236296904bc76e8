"""The plain versions of the port's flash kernels K1 and K2 against the JAX Pallas
kernels, which run here in interpret mode (as tests/test_pallas_attention.py runs
them). Inputs come from a numpy seed; everything is fp32, so atol 2e-5 covers the
different summation orders (online softmax over blocks vs one softmax).

The kernels themselves run only on the card: tests/test_torch_kernels_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu_torch.ops import flash_attention as fa
from controllora_tpu_torch.ops.attention import dot_product_attention

ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    fa.reset_launch_counts()
    yield
    # on CPU tensors every wrapper takes its plain version: nothing launched
    assert fa.LAUNCHES == {"k1": 0, "k2": 0}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("d", [40, 80])
def test_k1_plain_matches_flash_attention_fwd(d):
    """Exact tiling: the JAX kernel at blocks of 64, no biases."""
    from controllora_tpu.ops.pallas_attention import flash_attention_fwd

    q, k, v = (rand((4, 128, d), s) for s in range(3))
    ref = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64)
    # (BH, L, D) is the (B, L, H*D) layout with one head
    out = fa.biased_attention(t(q), t(k), t(v), heads=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("l", [96, 288, 144])
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("kv_biases", [False, True])
def test_k1_plain_matches_biased_attention(l, d, kv_biases):
    """Ragged L (pad + in-kernel KV mask on the JAX side), 2 heads, q/k/v biases of
    batch 1 broadcast over the CFG batch 2."""
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


def test_k1_per_image_biases_tile():
    """Bias batch n under a 2n batch tiles: rows i and n + i share bias i."""
    q, k, v = (rand((4, 64, 16), s) for s in range(3))
    qb = rand((2, 64, 16), 9)
    out = fa.biased_attention(t(q), t(k), t(v), 2, t(qb))
    ref = fa.biased_attention(t(q), t(k), t(v), 2, t(np.concatenate([qb, qb])))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("l,d", [(128, 40), (96, 40), (288, 80), (144, 512)])
def test_k2_plain_matches_fwd(l, d):
    """O and LSE of the JAX forward kernel; ragged L runs it padded to blocks of 64
    with kv_valid masking, then slices."""
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
