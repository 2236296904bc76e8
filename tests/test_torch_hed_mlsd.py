"""The port's HED and MLSD annotators against the JAX package's.

One seeded numpy state dict per net in the reference checkpoint's key names
(``seeded_state_dict``) feeds the JAX package through ``hed_params_from_torch`` /
``mlsd_params_from_torch`` and the port through ``load_state_dict(strict=True)``. On
the CPU:

  * raw net outputs (HED's edge probability at 96x128, MLSD's tpMap at 128²):
    relative L2 <= 1e-4 and max|d| <= 1e-3 * max|ref|;
  * HED's uint8 map equals the JAX one wherever the JAX float (x 255) lies further
    than the two float maps' measured difference from a level boundary; the
    truncation can fall either way only there, and there by one level;
  * ``hed_nms`` exactly on a smooth map and on ridges that touch the edges, where
    only a wrapping roll (``jnp.roll``, ``torch.roll``) gives the JAX answer; on the
    saturated detector map it differs only at near-ties of the blurred values (the
    two blurs sum their taps in different orders);
  * ``decode_centers`` on one tpMap exactly, including tied scores, where the order
    is the lower flat index first (``lax.top_k``'s rule); the decoded lines of
    ``pred_lines`` (same centres, coordinates within 1e-3 px), the detector's line
    map equal; ``squares_from_segments`` and ``draw_lines`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from controllora_tpu.annotators import hed as jh
from controllora_tpu.annotators import mlsd as jm
from controllora_tpu_torch.annotators import hed as ph
from controllora_tpu_torch.annotators import mlsd as pm
from test_mlsd import _square_scene_segments
from test_torch_openpose import assert_close, image, numpy_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_truncated_equal(ours, ours_f, ref_f):
    """``ours`` (uint8) against the JAX float map ``ref_f`` truncated to uint8: equal
    wherever ``ref_f`` is further than max|ours_f - ref_f| from an integer; elsewhere
    within one level. Returns the count of pixels that differ."""
    ours, ours_f, ref_f = (np.asarray(a) for a in (ours, ours_f, ref_f))
    want = np.clip(ref_f, 0, 255).astype(np.uint8)
    margin = float(np.abs(ours_f.astype(np.float64) - ref_f).max())
    frac = ref_f - np.floor(ref_f)
    near = (frac <= margin) | (frac >= 1 - margin)
    np.testing.assert_array_equal(ours[~near], want[~near])
    assert np.abs(ours[near].astype(np.int16) - want[near]).max(initial=0) <= 1
    return int((ours != want).sum())


@pytest.fixture(scope="module")
def hed():
    sd = numpy_state_dict(ph.HEDNetwork)
    return ph.HEDdetector(sd, device="cpu"), jh.HEDdetector(jh.hed_params_from_torch(sd))


def jax_edge(det, img):
    bgr = img[:, :, ::-1].astype(np.float32) / 255.0
    return np.asarray(det._jit(det.params, jnp.asarray(bgr)[None]))[0, :, :, 0]


def test_hed_state_dict_strict_names():
    sd = numpy_state_dict(ph.HEDNetwork)
    assert list(sd)[:4] == ["netVggOne.0.weight", "netVggOne.0.bias", "netVggOne.2.weight",
                            "netVggOne.2.bias"]
    assert "netVggTwo.1.weight" in sd and "netVggFiv.5.bias" in sd
    assert sd["netCombine.0.weight"].shape == (1, 5, 1, 1) and len(sd) == 38


def test_hed_edges_match_jax(hed):
    ours, ref = hed
    img = image((96, 128, 3), 3)
    edge, jedge = ours.edge(img).numpy(), jax_edge(ref, img)
    assert_close(edge, jedge)
    assert 0.01 < edge.mean() < 0.99
    out = ours(img)
    assert out.shape == (96, 128) and out.dtype == np.uint8
    differ = assert_truncated_equal(out, np.clip(edge * 255, 0, 255), np.clip(jedge * 255, 0, 255))
    assert differ <= out.size // 100
    np.testing.assert_array_equal(np.asarray(ref(img)), np.clip(jedge * 255, 0, 255).astype(np.uint8))


def jax_blur(x, sigma):
    """The blur inside the JAX hed_nms."""
    radius = max(1, int(round(3.0 * sigma)))
    t = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    g = jnp.exp(-(t**2) / (2 * sigma * sigma))
    g = g / g.sum()
    b = jax.vmap(lambda row: jnp.convolve(row, g, mode="same"))(jnp.asarray(x, jnp.float32))
    return np.asarray(jax.vmap(lambda c: jnp.convolve(c, g, mode="same"), in_axes=1,
                               out_axes=1)(b))


def smooth_map(shape, seed):
    f = np.cumsum(np.cumsum(np.random.default_rng(seed).normal(size=shape), 0), 1)
    return ((f - f.min()) / (f.max() - f.min()) * 255).astype(np.float32)


@pytest.mark.parametrize("t,s", [(100, 2.0), (127, 3.0), (60, 1.0)])
def test_nms_smooth_map_exact(t, s):
    x = smooth_map((64, 80), int(t))
    ours, ref = ph.nms(x, t, s), jh.nms(x, t, s)
    assert ours.dtype == np.uint8 and 0 < (ours > 0).sum() < ours.size
    np.testing.assert_array_equal(ours, ref)


def test_nms_wraps_at_the_edges():
    """Ridges along the first column, the last row and the main diagonal through the
    corners: their directional neighbours lie across the edge, where ``jnp.roll``
    wraps. A zero-padded shift would keep pixels that the wrap drops."""
    x = smooth_map((48, 56), 7) * 0.3
    x[:, 0] = 240.0
    x[:, -1] = np.linspace(200, 250, 48)  # the wrapped neighbour of column 0
    x[-1, :] = 235.0
    x[np.arange(48), np.arange(48)] = 245.0
    ours, ref = ph.nms(x, 80, 1.0), jh.nms(x, 80, 1.0)
    np.testing.assert_array_equal(ours, ref)
    padded = torch.nn.functional.pad(torch.from_numpy(x)[None, None], (1, 1, 1, 1))[0, 0]
    zero_pad = ph.hed_nms(padded, 80, 1.0)[1:-1, 1:-1].numpy()
    assert (zero_pad != ours).any()


def test_nms_saturated_map_differs_only_at_ties(hed):
    ours_det, _ = hed
    x = ours_det(image((96, 128, 3), 3)).astype(np.float32)
    ours, ref = ph.nms(x, 127, 3.0), jh.nms(x, 127, 3.0)
    blurred = jax_blur(x, 3.0)
    scale = np.abs(blurred).max()
    for y, xx in zip(*np.nonzero(ours != ref)):
        b = blurred[y, xx]
        neighbours = [blurred[(y + dy) % 96, (xx + dx) % 128]
                      for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1),
                                     (1, -1), (-1, 1))]
        assert min(abs(b - n) for n in neighbours) <= 1e-5 * scale, (y, xx)
    assert (ours != ref).sum() <= x.size // 1000


@pytest.fixture(scope="module")
def mlsd():
    sd = numpy_state_dict(pm.MobileV2MLSDLarge)
    params = jm.mlsd_params_from_torch(sd)
    apply = jax.jit(lambda p, x: jm.MobileV2MLSDLarge().apply({"params": p}, x))
    return pm.MLSDdetector(sd, device="cpu"), jm.MLSDdetector(params), apply, params


def test_mlsd_state_dict_strict_names():
    sd = numpy_state_dict(pm.MobileV2MLSDLarge)
    assert "backbone.features.0.0.weight" in sd and "backbone.features.1.conv.2.running_var" in sd
    assert sd["backbone.features.2.conv.1.0.weight"].shape == (96, 1, 3, 3)  # depthwise
    assert "block15.conv1.0.weight" in sd and "block23.conv3.bias" in sd
    assert sd["backbone.features.0.1.num_batches_tracked"].dtype == np.int64


def test_mlsd_tpmap_matches_jax(mlsd):
    ours, _, apply, params = mlsd
    x = np.random.default_rng(1).uniform(-1, 1, (1, 128, 128, 4)).astype(np.float32)
    ref = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = ours.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (1, 64, 64, 9)
    assert_close(out.numpy(), ref)


def test_decode_centers_exact_with_ties():
    """A flat background (every pixel a tied local maximum of the 3x3 window) with
    40 planted peaks: the 160 remaining slots take the lowest flat indices, in
    order, as lax.top_k gives them."""
    rng = np.random.default_rng(2)
    tp = rng.normal(size=(1, 64, 64, 9)).astype(np.float32)
    tp[0, :, :, 0] = -3.0
    ys, xs = rng.integers(0, 64, 40), rng.integers(0, 64, 40)
    tp[0, ys, xs, 0] = rng.uniform(0, 4, 40)
    ref = jm.decode_centers(jnp.asarray(tp))
    ours = pm.decode_centers(torch.from_numpy(tp).permute(0, 3, 1, 2))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jdisp = np.asarray(ref[3])[np.asarray(ref[1]), np.asarray(ref[2])]
    np.testing.assert_array_equal(ours[3].numpy(), jdisp)
    scores = ours[0].numpy()
    assert (scores[1:] <= scores[:-1]).all() and (scores == scores[-1]).sum() > 100


class FixedMap(nn.Module):
    """A stand-in net that returns one tpMap."""

    def __init__(self, tp):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))
        self.tp = torch.from_numpy(tp).permute(0, 3, 1, 2)

    def forward(self, x):
        return self.tp


def test_pred_lines_planted_centre():
    tp = np.full((1, 64, 64, 9), -10.0, np.float32)
    tp[0, 30, 20, 0] = 10.0
    tp[0, 30, 20, 1:5] = [-15.0, -5.0, 15.0, 5.0]
    img = np.zeros((128, 96, 3), np.uint8)
    ours = pm.pred_lines(img, FixedMap(tp), (128, 128), 0.5, 20.0)
    ref = jm.pred_lines(img, lambda p, x: jnp.asarray(tp), None, (128, 128), 0.5, 20.0)
    assert ours.shape == (1, 4)
    np.testing.assert_array_equal(ours, ref)


def test_pred_lines_and_detector_match_jax(mlsd):
    ours, ref, apply, params = mlsd
    img = image((96, 128, 3), 4)
    lines = pm.pred_lines(img, ours.model, (128, 128), 0.1, 20.0)
    jlines = jm.pred_lines(img, apply, params, (128, 128), 0.1, 20.0)
    assert lines.shape == jlines.shape and len(lines) > 10
    np.testing.assert_allclose(lines, jlines, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(pm.draw_lines((96, 128), jlines), jm.draw_lines((96, 128), jlines))
    out = ours(img, 0.1, 0.1)
    assert out.shape == (96, 128) and out.dtype == np.uint8 and out.any()
    np.testing.assert_array_equal(out, ref(img, 0.1, 0.1))


def test_pred_squares_match_jax(mlsd):
    ours, _, apply, params = mlsd
    img = image((128, 128, 3), 6)
    got = pm.pred_squares(img, ours.model, (128, 128))
    want = jm.pred_squares(img, apply, params, (128, 128))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)


def test_squares_from_segments_exact():
    segs = _square_scene_segments()
    for shape in ((512, 512), (300, 400)):
        got = pm.squares_from_segments(segs, 200, pm.DEFAULT_SQUARE_PARAMS, (512, 512), shape)
        want = jm.squares_from_segments(segs, 200, jm.DEFAULT_SQUARE_PARAMS, (512, 512), shape)
        assert len(got[1]) >= 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    empty = pm.squares_from_segments(np.zeros((0, 4), np.float32), 200, pm.DEFAULT_SQUARE_PARAMS)
    assert all(len(a) == 0 for a in empty)
