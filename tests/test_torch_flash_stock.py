"""K5 (jax's stock TPU flash attention, ported as ``ops/flash_stock.py``) against the
JAX package on the CPU, where the port takes its plain versions and jax's stock
Pallas kernels run in interpret mode (``pl.pallas_call`` patched as
tests/test_torch_flash_attention.py patches it).

Inputs come from a numpy seed. fp32: atol 2e-5 on O, m and l, and
1e-4 * max(1, max|ref|) on gradients (the kernels sum over 512-key blocks, the plain
versions in one pass); bf16: 1e-2 * max(1, max|ref|), about two bf16 ulps (the
stock kernel rounds P and dS to bf16 before its products, the plain versions do not).
The CUDA kernels themselves run only on the card: tests/test_torch_kernels_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.ops import attention as jattn
from controllora_tpu_torch.ops import flash_stock as fs
from controllora_tpu_torch.ops.attention import dot_product_attention

ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.delenv("CONTROLLORA_FLASH_IMPL", raising=False)
    fs.reset_launch_counts()
    # autograd on whatever the process state: a test file run earlier in the same
    # worker may have switched it off process-wide (scripts/dump_fixtures_torch.py
    # does, through tests/test_parity_fixtures.py)
    with torch.enable_grad():
        yield
    # on CPU tensors every wrapper takes its plain version: nothing launched
    assert fs.LAUNCHES == {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def to_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def assert_close(out, ref, what, rel):
    out, ref = to_np(out), to_np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rel * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"{what}: max|delta| {err} > {bound}"


@pytest.mark.parametrize("b,h,l,d,dtype,grads", [
    (1, 2, 256, 40, "float32", True),
    (1, 2, 512, 80, "bfloat16", True),
    (1, 1, 256, 512, "float32", False),
])
def test_flash_stock_route_matches_jax(b, h, l, d, dtype, grads):
    """dot_product_attention(backend="flash_stock") over (B, L, H*D): the output and
    (at D 40 and 80) the VJP against the JAX op on the same backend."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, do = (rand((b, l, h * d), s) for s in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    fn = lambda a, c, e: jattn.dot_product_attention(a, c, e, h, backend="flash_stock")  # noqa: E731
    ref, vjp = jax.vjp(fn, jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(to_np(x)).to(tdt).requires_grad_() for x in (jq, jk, jv))
    out = dot_product_attention(tq, tk, tv, h, backend="flash_stock")
    rel = ATOL if dtype == "float32" else 1e-2
    assert out.dtype == tdt
    assert_close(out, ref, "O", rel)
    if not grads:
        return
    out.backward(torch.from_numpy(to_np(jdo)).to(tdt))
    for name, x, r in zip("qkv", (tq, tk, tv), vjp(jdo)):
        assert x.grad.dtype == tdt
        assert_close(x.grad, r, f"d{name}", 1e-4 if dtype == "float32" else 1e-2)


def test_runtime_scale_and_residuals_match_jax():
    """A non-default sm_scale (0.3) straight through jax's stock flash_attention and
    the port's stock_flash_attention, (B, H, L, D); the forward residuals m and l
    against the stock kernel's (lane-broadcast there, one value a row here)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa

    b, h, l, d, scale = 1, 2, 256, 40, 0.3
    q, k, v, do = (rand((b, h, l, d), s) for s in range(10, 14))
    blk = fs.stock_block(l, l, d)
    bs = jfa.BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                        block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk,
                        block_q_dkv=blk, block_k_major_dq=blk, block_k_dq=blk,
                        block_q_dq=blk)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref, vjp = jax.vjp(lambda a, c, e: jfa.flash_attention(a, c, e, sm_scale=scale,
                                                           block_sizes=bs), jq, jk, jv)
    _, ref_l, ref_m = jfa._flash_attention_impl(jq, jk, jv, None, None, True, False, scale,
                                                1, blk, blk, blk, False)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fs.stock_flash_attention(tq, tk, tv, scale)
    o, m, lsum = fs.stock_flash_fwd(tq.detach(), tk.detach(), tv.detach(), scale)
    assert_close(out, ref, "O", ATOL)
    assert_close(o, ref, "O (stock_flash_fwd)", ATOL)
    assert_close(m, ref_m, "m", ATOL)
    assert_close(lsum, ref_l, "l", ATOL)
    out.backward(torch.from_numpy(do))
    for name, x, r in zip("qkv", (tq, tk, tv), vjp(jnp.asarray(do))):
        assert_close(x.grad, r, f"d{name}", 1e-4)
    # the default scale would give another result: the scale is not baked in
    other = fs.stock_flash_attention(tq.detach(), tk.detach(), tv.detach(), d**-0.5)
    assert np.abs(to_np(other) - to_np(ref)).max() > 1e-3


@pytest.mark.parametrize("l,exc", [(300, ValueError), (192, NotImplementedError)])
def test_same_exceptions_as_jax(l, exc):
    """L 300 has no power-of-two block (ValueError in _flash_stock); L 192 takes a
    block of 64, under the stock kernel's 128 (NotImplementedError)."""
    q = rand((1, l, 2 * 40), 0)
    with pytest.raises(exc):
        jattn.dot_product_attention(*(jnp.asarray(q),) * 3, 2, backend="flash_stock")
    with pytest.raises(exc):
        dot_product_attention(*(torch.from_numpy(q),) * 3, 2, backend="flash_stock")


def test_wide_head_rule_matches_stock():
    """A head wider than 128 that is not a multiple of 128 (D 160) is refused by the
    stock kernel where its KV loop takes more than one block (L 1024, blocks of 512)
    and taken in one block (L 256); the port's block rule does the same."""
    q = rand((1, 1, 1024, 160), 1)
    with pytest.raises(NotImplementedError):
        jattn._flash_stock(*(jnp.asarray(q),) * 3, 160**-0.5)
    with pytest.raises(NotImplementedError):
        fs.stock_flash_attention(*(torch.from_numpy(q),) * 3, 160**-0.5)
    q = q[:, :, :256]
    ref = jattn._flash_stock(*(jnp.asarray(q),) * 3, 160**-0.5)
    out = fs.stock_flash_attention(*(torch.from_numpy(q),) * 3, 160**-0.5)
    assert_close(out, ref, "O at D 160, one block", ATOL)


def test_env_switch_routes_flash_to_k5(monkeypatch):
    """CONTROLLORA_FLASH_IMPL=stock, read at call time, sends the flash route to K5,
    as in the JAX package: at L 300 the stock block rule now raises, where
    FlashAttention (K2-K4) took the ragged length; and K5 is what runs."""
    q = torch.from_numpy(rand((1, 300, 16), 2))
    dot_product_attention(q, q, q, 2, backend="flash")  # FlashAttention: any L
    calls = []
    real = fs.stock_flash_attention
    monkeypatch.setattr(fs, "stock_flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setenv("CONTROLLORA_FLASH_IMPL", "stock")
    with pytest.raises(ValueError, match="power-of-two"):
        dot_product_attention(q, q, q, 2, backend="flash")
    x = torch.from_numpy(rand((1, 256, 16), 3))
    out = dot_product_attention(x, x, x, 2, backend="flash")
    ref = dot_product_attention(x, x, x, 2, backend="xla")
    assert calls == [(1, 2, 300, 8), (1, 2, 256, 8)]
    assert_close(out, ref.numpy(), "K5 vs the matmul path", ATOL)
    # "auto" on a CPU tensor stays on the matmul path, switch or not
    dot_product_attention(x, x, x, 2)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="unknown attention backend"):
        dot_product_attention(x, x, x, 2, backend="pallas")


def test_pick_block_matches_jax():
    from controllora_tpu.ops.pallas_attention import pick_block

    for n in (64, 128, 192, 256, 300, 2304, 4096, 4225, 9216):
        for cap, hd in ((512, None), (1024, None), (1024, 512)):
            assert fs.pick_block(n, cap, hd) == pick_block(n, cap, hd), (n, cap, hd)
