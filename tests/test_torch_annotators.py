"""The port's Canny annotator and image utilities against the JAX package's.

``canny`` equals the JAX ``canny`` exactly (every pixel of the edge map) on the
scenes of ``tests/test_annotators.py`` at its three threshold pairs, on seeded random
uint8 RGB, gray and RGBA (through ``HWC3``) images, on a blank image, and on a weak
edge longer than 64 dilation steps, where both stop at the 64-step cap (and agree
with a higher cap too). A batch equals its images one by one, and a float image its
uint8 original. ``resize_image`` is within one uint8 level of the JAX one, upscaling
(lanczos3) and downscaling (antialiased linear), and ``HWC3`` is equal. The JAX
package's F1 check against cv2 holds for the port as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.annotators import CannyDetector as JCannyDetector
from controllora_tpu.annotators import HWC3 as JHWC3
from controllora_tpu.annotators import canny as jcanny
from controllora_tpu.annotators import resize_image as jresize_image
from controllora_tpu_torch.annotators import HWC3, CannyDetector, canny, resize_image

PAIRS = [(50, 150), (100, 200), (30, 80)]


def synth_image(seed=0, size=128):
    """tests/test_annotators.py's scene: a gradient background, a disc, a square and
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = 128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    cx, cy, r = size // 2, size // 2, size // 4
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    img[mask] = 220.0
    img[10 : size // 3, 10 : size // 3] = 40.0
    img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    return np.repeat(img[:, :, None], 3, axis=2)


def jax_edges(img, lo, hi, iters=64):
    return np.asarray(jcanny(jnp.asarray(img), jnp.float32(lo), jnp.float32(hi),
                             max_hysteresis_iters=iters))


def port_edges(img, lo, hi, iters=64):
    return canny(torch.from_numpy(np.ascontiguousarray(img)), lo, hi, iters).numpy()


@pytest.mark.parametrize("lo,hi", PAIRS)
@pytest.mark.parametrize("seed", [0, 1])
def test_canny_scene_exact(seed, lo, hi):
    img = synth_image(seed)
    ours = CannyDetector("cpu")(img, lo, hi)
    ref = JCannyDetector()(img, lo, hi)
    assert ours.dtype == np.uint8 and set(np.unique(ours)) <= {0, 255}
    assert (ours > 0).sum() > 100
    np.testing.assert_array_equal(ours, ref)


def test_canny_random_images_exact():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    rgba = HWC3(rng.integers(0, 256, (64, 64, 4), dtype=np.uint8))
    blank = np.full((48, 48, 3), 77, np.uint8)
    for img in (rgb, gray, rgba, blank):
        for lo, hi in PAIRS:
            np.testing.assert_array_equal(port_edges(img, lo, hi), jax_edges(img, lo, hi))
    assert port_edges(blank, 30, 80).max() == 0


def test_canny_batch_and_float_inputs():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    batch = canny(torch.from_numpy(imgs), 60, 120)
    assert batch.shape == (3, 40, 56) and batch.dtype == torch.uint8
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(), port_edges(imgs[i], 60, 120))
    floats = canny(torch.from_numpy(imgs.astype(np.float32)), 60, 120)
    assert torch.equal(floats, batch)
    np.testing.assert_array_equal(batch[1].numpy(), jax_edges(imgs[1], 60, 120))


def long_weak_edge(length=200):
    """A vertical step edge ``length`` rows long: 4 rows of strong contrast on top
    (Sobel magnitude 240), the rest weak (80), so hysteresis grows down one row a
    dilation step."""
    img = np.zeros((length, 24, 3), np.uint8)
    img[:, 12:] = 20
    img[:4, 12:] = 60
    return img


def test_canny_hysteresis_stops_at_the_cap():
    img = long_weak_edge()
    capped, ref = port_edges(img, 50, 150), jax_edges(img, 50, 150)
    np.testing.assert_array_equal(capped, ref)
    full, ref_full = port_edges(img, 50, 150, 256), jax_edges(img, 50, 150, 256)
    np.testing.assert_array_equal(full, ref_full)
    rows = lambda e: int((e > 0).any(axis=1).sum())  # noqa: E731
    assert rows(capped) < 80 < 190 < rows(full), (rows(capped), rows(full))


@pytest.mark.parametrize("shape,res", [((100, 150, 3), 256), ((64, 64, 3), 512),
                                       ((97, 61, 3), 64), ((300, 200, 3), 128),
                                       ((80, 120, 3), 80)])
def test_resize_image_within_one_level(shape, res):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    ours, ref = resize_image(img, res), jresize_image(img, res)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(np.int16) - ref).max() <= 1


def test_hwc3_equal():
    rng = np.random.default_rng(2)
    for shape in ((8, 9), (8, 9, 1), (8, 9, 3), (8, 9, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(HWC3(img), JHWC3(img))
    with pytest.raises(ValueError, match="channel"):
        HWC3(np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("lo,hi", PAIRS)
def test_canny_matches_cv2(lo, hi):
    cv2 = pytest.importorskip("cv2")
    from test_annotators import tolerant_f1

    img = synth_image()
    ours = CannyDetector("cpu")(img, lo, hi)
    score = tolerant_f1(ours, cv2.Canny(img, lo, hi), tol_px=1)
    assert score > 0.82, f"tolerant F1 {score:.3f} too low (lo={lo}, hi={hi})"
