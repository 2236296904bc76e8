"""Token merging in the port (``ops/tome.py``) against the JAX package's.

``build_merge`` runs on both sides on the same seeded (B, L, C) inputs at L 64 and
256, with the port's window choice replaced by the JAX draw for the same key
(``np.asarray`` of ``jax.random.randint``). The index maps must be exactly equal
(the merged row of every position, and which src rows stay unmerged, in order); the
merged tensor, the unmerged tensor and the merged folded biases agree within 1e-6
(fp32; the sums of merged rows may add in another order). The remaining tests follow
``tests/test_tome.py`` on the port alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.models.unet import _merge_stack_tokens
from controllora_tpu.ops import tome as jtome
from controllora_tpu.ops.folding import FoldedBias as JFoldedBias
from controllora_tpu_torch.models.unet import _merge_stack_tokens as merge_stack_tokens
from controllora_tpu_torch.ops import tome
from controllora_tpu_torch.ops.folding import FoldedBias

ATOL = 1e-6


def tokens(rng, b, length, c):
    return rng.normal(size=(b, length, c)).astype(np.float32)


def positions(b, length):
    return np.broadcast_to(np.arange(length, dtype=np.float32)[None, :, None],
                           (b, length, 1)).copy()


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def jax_side(hh, ww, ratio, key, x, rows, pos, y, biases):
    """One jitted JAX call (eager dispatch of each op costs seconds): the merge of x,
    of the positions and of the folded biases, the unmerge of y and of the rows."""
    merge, unmerge, _ = jtome.build_merge(x, hh, ww, jtome.ToMeConfig(ratio=ratio,
                                                                     min_tokens=0), key)
    merged = _merge_stack_tokens(JFoldedBias(*biases), merge, x.shape[0])
    return (merge(x), merge(pos), unmerge(y), unmerge(rows),
            (merged.q_bias, merged.k_bias, merged.v_bias, merged.out_bias))


@pytest.mark.parametrize("hh,ww,ratio,b", [(8, 8, 0.5, 2), (16, 16, 0.5, 3),
                                           (16, 16, 0.3, 2), (8, 8, 0.75, 1)])
def test_build_merge_matches_jax(hh, ww, ratio, b):
    rng = np.random.default_rng(hh * 10 + b)
    length, c = hh * ww, 12
    cfg = tome.ToMeConfig(ratio=ratio, min_tokens=0)
    r = tome.merge_count(cfg, length)
    merged_len = length - r
    x = tokens(rng, b, length, c)
    rows, pos = positions(b, merged_len), positions(b, length)
    y = tokens(rng, b, merged_len, 5)
    # folded biases: batch 1 (one guide under the CFG batch), absent, and of batch b
    biases = (tokens(rng, 1, length, 8), None, tokens(rng, b, length, 8),
              tokens(rng, 1, length, 8))
    key = jtome.step_key(0, jnp.int32(801), 3)
    # the JAX build_merge draws from `key` itself: hand the port the same draw
    rand = torch.from_numpy(np.array(jax.random.randint(key, (hh // 2, ww // 2), 0, 4)))
    ref = jax.tree.map(np.asarray, jax_side(hh, ww, ratio, key, x, rows, pos, y, biases))
    merge, unmerge, length_t = tome.build_merge(torch.from_numpy(x), hh, ww, cfg, rand)
    assert length_t == merged_len

    # exact index maps: the merged row of each position, and the unmerged src order
    np.testing.assert_array_equal(unmerge(torch.from_numpy(rows)).numpy(), ref[3])
    n_unm = length - (hh // 2) * (ww // 2) - r
    np.testing.assert_array_equal(merge(torch.from_numpy(pos))[:, :n_unm].numpy(),
                                  ref[1][:, :n_unm])
    np.testing.assert_allclose(merge(torch.from_numpy(x)).numpy(), ref[0], atol=ATOL)
    np.testing.assert_allclose(unmerge(torch.from_numpy(y)).numpy(), ref[2], atol=ATOL)
    out = merge_stack_tokens(FoldedBias(*(None if t is None else torch.from_numpy(t)
                                          for t in biases)), merge, b)
    for name, want in zip(("q_bias", "k_bias", "v_bias", "out_bias"), ref[4]):
        got = getattr(out, name)
        if want is None:
            assert got is None
            continue
        assert got.shape == (b, merged_len, 8)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=name)


def test_per_image_biases_tile_then_merge():
    """Biases of batch n under a 2n CFG batch tile to [u1..un || c1..cn] before the
    merge, as the JAX package's fit()."""
    rng = np.random.default_rng(0)
    x, bias = tokens(rng, 4, 64, 6), tokens(rng, 2, 64, 6)
    key = jtome.step_key(0, jnp.int32(500), 0)
    rand = torch.from_numpy(np.array(jax.random.randint(key, (4, 4), 0, 4)))
    ref = jax_side(8, 8, 0.5, key, x, positions(4, 32), positions(4, 64),
                   tokens(rng, 4, 32, 1), (bias, None, None, None))[4][0]
    merge, _, _ = tome.build_merge(torch.from_numpy(x), 8, 8,
                                   tome.ToMeConfig(ratio=0.5, min_tokens=0), rand)
    out = merge_stack_tokens(FoldedBias(q_bias=torch.from_numpy(bias)), merge, 4).q_bias
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_zero_ratio_is_identity():
    x = torch.randn(2, 64, 6)
    merge, unmerge, length = tome.build_merge(x, 8, 8, tome.ToMeConfig(ratio=0.0),
                                              torch.zeros(4, 4, dtype=torch.long))
    assert length == 64
    assert torch.equal(merge(x), x) and torch.equal(unmerge(x), x)


def test_merged_length_and_shapes():
    cfg = tome.ToMeConfig(ratio=0.5, min_tokens=0)
    x = torch.randn(3, 64, 5)
    r = tome.merge_count(cfg, 64)
    assert r == 32
    merge, unmerge, length = tome.build_merge(
        x, 8, 8, cfg, tome.window_choice(0, 999, 0, "p", 0, 4, 4))
    y = merge(x)
    assert y.shape == (3, 64 - r, 5) and length == 64 - r
    assert unmerge(y).shape == x.shape
    # the SD1.5 level-0 grid at 512²: 4096 tokens merge down to 2048
    assert tome.merge_count(tome.ToMeConfig(), 4096) == 2048


def test_window_constant_roundtrip_exact():
    """Tokens constant within each 2x2 window merge losslessly (every src matches an
    identical token), so unmerge(merge(x)) == x."""
    vals = torch.randn(1, 4, 4, 4)
    x = vals.repeat_interleave(2, 1).repeat_interleave(2, 2).reshape(1, 64, 4)
    cfg = tome.ToMeConfig(ratio=0.75, min_tokens=0)
    merge, unmerge, length = tome.build_merge(
        x, 8, 8, cfg, tome.window_choice(0, 1, 2, "p", 0, 4, 4))
    assert length == 16
    torch.testing.assert_close(unmerge(merge(x)), x, rtol=1e-5, atol=1e-6)


def test_merge_commutes_with_linear_projection():
    """merge averages rows, so it is linear: merge(x) @ w == merge(x @ w). This is
    what lets the folded path merge its per-position biases."""
    x, w = torch.randn(2, 64, 6), torch.randn(6, 10)
    merge, _, _ = tome.build_merge(x, 8, 8, tome.ToMeConfig(ratio=0.4, min_tokens=0),
                                   tome.window_choice(0, 7, 1, "p", 0, 4, 4))
    torch.testing.assert_close(merge(x) @ w, merge(x @ w), rtol=2e-4, atol=1e-5)


def test_batch1_broadcast_merge():
    x = torch.randn(3, 16, 5)
    merge, _, _ = tome.build_merge(x, 4, 4, tome.ToMeConfig(ratio=0.25, min_tokens=0),
                                   tome.window_choice(0, 7, 1, "p", 0, 2, 2))
    assert merge(torch.randn(1, 16, 5)).shape[0] == 3


def test_window_choice_is_deterministic_and_keyed():
    args = (0, 801, 3, "down_blocks.0.attentions.0", 0, 32, 32)
    a = tome.window_choice(*args)
    assert a.shape == (32, 32) and a.dtype == torch.long
    assert 0 <= int(a.min()) and int(a.max()) < 4
    assert torch.equal(a, tome.window_choice(*args))
    for i, other in ((1, 761), (2, 4), (3, "down_blocks.0.attentions.1"), (4, 1)):
        changed = list(args)
        changed[i] = other
        assert not torch.equal(a, tome.window_choice(*changed)), i


def test_maybe_tome_gates_like_jax():
    for cfg_kw in (dict(), dict(min_tokens=0), dict(ratio=0.0)):
        cj, ct = jtome.ToMeConfig(**cfg_kw), tome.ToMeConfig(**cfg_kw)
        for hh, ww in ((64, 64), (32, 32), (8, 8), (1, 1), (3, 4)):
            assert tome.maybe_tome(ct, hh, ww) == jtome.maybe_tome(cj, hh, ww)
    assert not tome.maybe_tome(None, 64, 64)
