"""K5's backward on K3's and K4's contract, on the CPU.

On the card, ``k5_stock_flash_bwd_dkv`` and ``k5_stock_flash_bwd_dq`` launch the same
kernels as K3 and K4 (``csrc/flash_attn_bwd.cu``), which form LSE = m + log(l) from the
stock residuals and take the stock runtime scale. This holds that contract with the
plain versions: K3's and K4's plain backward, fed m + log(l) from the K5 forward's plain
version, di as Dcap and the stock scale (D^-1/2, 0.3 and -0.3), equals the stock plain
backward, and jax's stock TPU backward (its Pallas kernels in interpret mode, as
tests/test_torch_flash_stock.py runs them) at B 1, H 2, L 256, D 40, 80 and 128 (the
widest head the stock kernel takes at any length, which K3/K4's wide instances run).

Inputs come from a numpy seed, in fp32. Bounds on each gradient, times
max(1, max|ref|): 1e-5 between the two plain versions (the same products; exp(S * s -
m) / l against exp(S * s - (m + log l)) differ in the last bits), 1e-4 against jax
(its kernels sum over blocks, the plain versions in one pass), as in
tests/test_torch_flash_stock.py. The kernels themselves run on the card:
tests/test_torch_kernels_gpu.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu_torch.ops import flash_attention as fa
from controllora_tpu_torch.ops import flash_stock as fs
from controllora_tpu_torch.ops.attention import merge_heads, split_heads

B, H, L = 1, 2, 256
SCALES = ["default", 0.3, -0.3]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    fa.reset_launch_counts()
    fs.reset_launch_counts()
    with torch.enable_grad():  # whatever an earlier test file in this worker left
        yield
    # CPU tensors take the plain versions: nothing launched
    assert fa.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    assert fs.LAUNCHES == {"k5_fwd": 0, "k5_dkv": 0, "k5_dq": 0}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_close(out, ref, what, rel, explain=None):
    """max|out - ref| <= rel * max(1, max|ref|); a failure also reports ``explain()``."""
    out = out.detach().float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = ref.detach().float().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rel * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"{what}: max|delta| {err} > {bound}" + (
        f"; {explain()}" if explain else "")


def float64_grads(q, k, v, do, scale):
    """(dQ, dK, dV) of softmax(Q K^T * scale) V by autograd in float64."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    o = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1) @ v
    return torch.autograd.grad(o, (q, k, v), do.double())


def diagnosis(routes, exact):
    """Each route's max error against the float64 gradients, and what the process ran
    with: the cause of a failure, where the bound alone cannot tell whose error it is."""
    errs = ", ".join(f"{route} {name} {(out.double() - ref).abs().max().item():.3e}"
                     for route, grads in routes.items()
                     for name, out, ref in zip(("dq", "dk", "dv"), grads, exact))
    return (f"against float64: {errs}; torch threads {torch.get_num_threads()}; xdist "
            f"worker {os.environ.get('PYTEST_XDIST_WORKER', 'none')}")


def inputs(d, scale, seed):
    """(q, k, v, dO) as (B, H, L, D) fp32 tensors, and the stock scale."""
    q, k, v, do = (torch.from_numpy(rand((B, H, L, d), seed + i)) for i in range(4))
    return q, k, v, do, d**-0.5 if scale == "default" else scale


def k3_k4_route(q, k, v, do, scale):
    """K5's backward as the kernels run it: the K5 forward's residuals as LSE = m +
    log(l), di = rowsum(dO * O) as Dcap, through the K3/K4 plain contract over the
    (B, L, H*D) projections. Returns (dQ, dK, dV) as (B, H, L, D)."""
    o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
    lse = (m + torch.log(lsum)).reshape(B * H, L)
    dcap = (o * do).sum(-1).reshape(B * H, L)
    proj = [merge_heads(x) for x in (q, k, v, do)]
    dk, dv = fa.flash_bwd_dkv_plain(*proj, lse, dcap, H, scale)
    dq = fa.flash_bwd_dq_plain(*proj, lse, dcap, H, scale)
    return tuple(split_heads(x, H) for x in (dq, dk, dv))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("d", [40, 80, 128])
def test_k3_k4_contract_equals_stock_plain(d, scale):
    """The K3/K4 plain backward on K5's residuals and scale equals K5's plain backward
    (P = exp(S * scale - m) / l, dS = P (dP - di) * scale, dK = dS^T Q, dQ = dS K)."""
    q, k, v, do, scale = inputs(d, scale, 20)
    dq, dk, dv = k3_k4_route(q, k, v, do, scale)
    o, m, lsum = fs.stock_flash_fwd_plain(q, k, v, scale)
    di = (o * do).sum(-1)
    ref_dk, ref_dv = fs.stock_flash_bwd_dkv(q, k, v, do, m, lsum, di, scale)
    ref_dq = fs.stock_flash_bwd_dq(q, k, v, do, m, lsum, di, scale)

    def explain():
        return diagnosis({"K3/K4 route": (dq, dk, dv), "stock plain": (ref_dq, ref_dk, ref_dv)},
                         float64_grads(q, k, v, do, scale))

    for name, out, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert_close(out, ref, f"{name} D {d} scale {scale}", 1e-5, explain)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("d", [40, 80, 128])
def test_k3_k4_contract_equals_jax_stock_backward(d, scale):
    """The same route against jax's stock flash attention's VJP (forward, dK/dV and dQ
    Pallas kernels in interpret mode) at the stock block, with the scale passed to it."""
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa

    q, k, v, do, scale = inputs(d, scale, 30)
    blk = fs.stock_block(L, L, d)
    bs = jfa.BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                        block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk,
                        block_q_dkv=blk, block_k_major_dq=blk, block_k_dq=blk,
                        block_q_dq=blk)
    _, vjp = jax.vjp(lambda a, c, e: jfa.flash_attention(a, c, e, sm_scale=scale,
                                                         block_sizes=bs),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do.numpy()))
    out = k3_k4_route(q, k, v, do, scale)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert_close(o, np.asarray(r, np.float32), f"{name} D {d} scale {scale}", 1e-4)
