"""The hand-written flash kernels K1 and K2 against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip. On the card:
    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -m gpu -q
bf16 inputs; the plain version runs in fp32 on the same bf16 values (and the same
bf16 sums with the biases) and its output stays fp32. The bounds (O 1e-2, LSE 1e-3)
cover the kernel's bf16 rounding of P and of its own output.
"""

import pytest
import torch

from controllora_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launch_counts()
    return torch.device("cuda")


def randn(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=torch.bfloat16)


@pytest.mark.parametrize("b,heads,l,d,bc", [(2, 8, 1024, 40, 1), (2, 4, 333, 80, 1),
                                            (1, 1, 1000, 512, 1), (2, 2, 77, 160, 1),
                                            (8, 8, 1024, 40, 4), (4, 4, 333, 80, 2)])
def test_k1_matches_plain(cuda, b, heads, l, d, bc):
    """bc is the bias batch: per-image biases (bc = n under the 2n CFG batch) must
    TILE, so batch row i reads bias row i % bc; every bias row differs."""
    q, k, v = (randn((b, l, heads * d), s, cuda) for s in range(3))
    qb, kb, vb = (0.25 * randn((bc, l, heads * d), s, cuda) for s in range(3, 6))
    out = fa.biased_attention(q, k, v, heads, qb, kb, vb)
    torch.cuda.synchronize()
    # the plain version on the same bf16 sums, kept in fp32 (no output rounding)
    qe, ke, ve = ((x + xb.repeat(b // bc, 1, 1)).float()
                  for x, xb in ((q, qb), (k, kb), (v, vb)))
    ref, _ = fa.attention_lse_plain(qe, ke, ve, heads)
    assert fa.LAUNCHES["k1"] == 1
    assert (out.float() - ref).abs().max().item() <= 1e-2


@pytest.mark.parametrize("b,heads,l,d", [(2, 8, 1024, 40), (1, 1, 700, 512),
                                         (1, 2, 129, 64)])
def test_k2_matches_plain(cuda, b, heads, l, d):
    q, k, v = (randn((b, l, heads * d), s, cuda) for s in range(3))
    o, lse = fa.flash_attention(q, k, v, heads)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), heads)
    assert fa.LAUNCHES["k2"] == 1
    assert (o.float() - o_ref).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 64, 40), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, 1)  # fp32
    qh = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qh, qh, qh, 8)  # head dim 5
    with pytest.raises(ValueError):
        fa.biased_attention(qh, qh, qh, 1, torch.zeros((3, 64, 40), device=cuda,
                                                              dtype=torch.bfloat16))
    assert fa.LAUNCHES == {"k1": 0, "k2": 0}
