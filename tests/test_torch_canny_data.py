"""The port's process/ datasets against the JAX package's, and with no PIL at all.

``process/diffusiondb_canny`` (procedural images, no network): each item draws the
JAX item's crop and thresholds from the same seeded generator; its ``pixel_values``
equal the JAX item's (the bound the port must meet is one uint8 level, 1/127.5: its
bilinear, ``utils/image.py::resize_bilinear``, follows PIL's fixed-point resample
and meets it exactly); the guide is exactly the JAX ``canny`` of the port's own
image at those thresholds; the ids are equal. The JAX hermetic test's properties
(``tests/test_datasets.py``) hold. ``_resize_short`` equals PIL's BILINEAR.
``mpii_pose`` and ``danbooru_sketch`` items read from PNG files equal the JAX items
(their 80 x 100 images are resized), with the same crop and sketch style. With ``PIL`` made unimportable, every dataset of the port imports and
reads an item from PNG files (DreamBooth's at a size that needs resizing).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from controllora_tpu.annotators import canny as jcanny
from controllora_tpu.data import process_datasets as jpd
from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu_torch.data import process_datasets as pd
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.utils.png import encode_png

LEVEL = 1 / 127.5 + 1e-6


def crop_and_thresholds(seed, idx, h, w, res):
    """The crop origin and the (low, high) thresholds item ``idx`` draws."""
    rng = np.random.default_rng(seed * 999_983 + idx)
    y = int(rng.integers(0, max(h - res, 0) + 1))
    x = int(rng.integers(0, max(w - res, 0) + 1))
    t1, t2 = sorted(rng.integers(1, 255, 2).tolist())
    return (y, x), (int(t1), int(max(t2, t1 + 1)))


@pytest.mark.parametrize("res,seed", [(64, 0), (96, 3)])
def test_diffusiondb_canny_items_match_jax(res, seed):
    ours = pd.DiffusionDBCanny(HashTokenizer(), resolution=res, size=8, seed=seed,
                               device="cpu")
    ref = jpd.DiffusionDBCanny(JHashTokenizer(), resolution=res, size=8, seed=seed,
                               device="cpu")
    assert len(ours) == len(ref) == 8
    for idx in (0, 1, 5):
        a, b = ours[idx], ref[idx]
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        assert np.abs(a["pixel_values"] - b["pixel_values"]).max() <= LEVEL
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
        np.testing.assert_array_equal(a["guide_values"], b["guide_values"])
        # the same crop of the procedural image, resized within one level
        big = pd._procedural_image(idx, res + 64)
        np.testing.assert_array_equal(big, jpd._procedural_image(idx, res + 64))
        short = pd._resize_short(big, res)
        (y, x), (lo, hi) = crop_and_thresholds(seed, idx, *short.shape[:2], res)
        img = short[y:y + res, x:x + res]
        np.testing.assert_array_equal(np.round((a["pixel_values"] + 1) * 127.5), img)
        guide = np.asarray(jcanny(jnp.asarray(img), jnp.float32(lo), jnp.float32(hi)))
        np.testing.assert_array_equal(a["guide_values"],
                                      np.repeat(guide[:, :, None], 3, 2) / 127.5 - 1.0)


def test_diffusiondb_canny_hermetic():
    """tests/test_datasets.py's properties, for the port's class."""
    ds = pd.DiffusionDBCanny(HashTokenizer(), resolution=96, size=5, seed=3, device="cpu")
    it = ds[1]
    assert it["pixel_values"].shape == (96, 96, 3)
    assert it["guide_values"].shape == (96, 96, 3)
    vals = np.unique(np.round(it["guide_values"], 3))
    assert set(vals.tolist()) <= {-1.0, 1.0}
    np.testing.assert_allclose(ds[1]["guide_values"], it["guide_values"])
    assert np.abs(ds[2]["pixel_values"] - it["pixel_values"]).max() > 0.1


@pytest.mark.parametrize("shape,res", [((80, 100, 3), 64), ((576, 576, 3), 512),
                                       ((50, 70, 3), 64), ((64, 90, 3), 64)])
def test_resize_short_equals_pil(shape, res):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    ours = pd._resize_short(img, res)
    h, w = shape[:2]
    s = res / min(h, w)
    want = np.asarray(Image.fromarray(img).resize(
        (max(res, round(w * s)), max(res, round(h * s))), Image.BILINEAR))
    assert ours.shape == want.shape
    np.testing.assert_array_equal(ours, want)


def make_jsonl(root, guide_dirs=("guides",)):
    """tests/test_datasets.py's layout: 4 images of 80 x 100 and their inverses as
    guides, written as PNG by the port's encoder."""
    os.makedirs(root / "images")
    for d in guide_dirs:
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    with open(root / "prompt.jsonl", "w") as f:
        for i in range(4):
            img = rng.integers(0, 255, (80, 100, 3)).astype(np.uint8)
            (root / "images" / f"{i}.png").write_bytes(encode_png(img))
            for d in guide_dirs:
                (root / d / f"{i}.png").write_bytes(encode_png(255 - img))
            f.write(json.dumps({"image": f"images/{i}.png", "guide": f"{guide_dirs[0]}/{i}.png",
                                "text": f"caption {i}"}) + "\n")
    return str(root)


@pytest.mark.parametrize("name,dirs", [("MPIIPose", ("guides",)),
                                       ("DanbooruSketch", ("sketch_a", "sketch_b", "sketch_c"))])
def test_jsonl_items_match_jax(tmp_path, name, dirs):
    root = make_jsonl(tmp_path / "data", dirs)
    ours = getattr(pd, name)(HashTokenizer(), resolution=64, data_root=root, seed=1)
    ref = getattr(jpd, name)(JHashTokenizer(), resolution=64, data_root=root, seed=1)
    assert len(ours) == len(ref) == 4
    for idx in range(4):
        a, b = ours[idx], ref[idx]
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        for k in ("pixel_values", "guide_values"):
            assert a[k].shape == b[k].shape == (64, 64, 3)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{idx} {k}")
        # synchronized crop: the guide is the image's inverse at every pixel
        total = np.round((a["pixel_values"] + 1) * 127.5 + (a["guide_values"] + 1) * 127.5)
        np.testing.assert_allclose(total, 255, atol=2)


NO_PIL = """
import sys

import numpy as np


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError("PIL imported: " + name)
        return None


sys.meta_path.insert(0, Refuse())
from controllora_tpu_torch.data.dreambooth import DreamBoothDataset
from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
from controllora_tpu_torch.data.process_datasets import (
    DanbooruSketch, DiffusionDBCanny, MPIIPose)
from controllora_tpu_torch.data.tokenizer import HashTokenizer
import pathlib

tmp = pathlib.Path(sys.argv[1])
tok = HashTokenizer()
root = str(tmp / "data")
items = [DiffusionDBCanny(tok, resolution=64, size=2, device="cpu")[0],
         MPIIPose(tok, resolution=64, data_root=root)[0],
         DanbooruSketch(tok, resolution=64, data_root=root)[0],
         Fill50kSynthetic(tok, resolution=64, size=2)[0],
         DreamBoothDataset(tok, instance_data_dir=str(tmp / "instance"),
                           instance_prompt="a sks toy", resolution=64)[0]]
for item in items:
    assert item["pixel_values"].shape == (64, 64, 3)
    assert np.isfinite(item["pixel_values"]).all()
assert not [m for m in sys.modules if m.split(".")[0] == "PIL"]
print(len(items), "items")
"""


def test_datasets_read_pngs_without_pil(tmp_path):
    """In a fresh interpreter whose import hook refuses PIL, every dataset of the
    port imports and reads one item from PNG files (DreamBooth's 80 x 100 instance
    image needs a resize)."""
    make_jsonl(tmp_path / "data", ("guides", "sketch_a", "sketch_b", "sketch_c"))
    (tmp_path / "instance").mkdir()
    img = np.random.default_rng(1).integers(0, 256, (80, 100, 3), dtype=np.uint8)
    (tmp_path / "instance" / "0.png").write_bytes(encode_png(img))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", NO_PIL, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "5 items"
