"""The reference's process/ dataset zoo (SURVEY.md §2.1 data layer): the port's own
copy of ``controllora_tpu/data/process_datasets.py``, so that
``DatasetBase.from_name`` resolves the same names.

  * diffusiondb_canny — on-the-fly Canny guides with RANDOM thresholds in [1, 255)
    per sample (the reference's augmentation, process/diffusiondb_canny.py:37-39),
    computed by the port's Canny (``annotators/canny.py``) on ``device``. Sources
    images from the HF hub when ``CONTROLLORA_USE_HUB=1`` and ``datasets`` can load
    it, else a procedural image generator (no network needed).
  * mpii_pose — prompt.jsonl + precomputed pose-guide images with a synchronized
    random crop (reference process/mpii_pose.py:29-36).
  * danbooru_sketch — jsonl prompts + per-sample random choice among 3 precomputed
    sketch-style directories (reference process/danbooru_sketch.py:16-32).

No PIL on these paths (the card's machine has none): PNG files decode through
``utils/png.py`` and resize with ``utils/image.py::resize_bilinear``, which equals
PIL's ``BILINEAR``. Only a file that is not a PNG goes through PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from controllora_tpu_torch.data.registry import DatasetBase
from controllora_tpu_torch.utils.image import resize_bilinear
from controllora_tpu_torch.utils.png import SIGNATURE as PNG_SIGNATURE, decode_png


def _rand_crop_pair(a: np.ndarray, b: np.ndarray, res: int, rng) -> tuple:
    """Synchronized random crop (reference train:615-635 / mpii_pose.py:29-36)."""
    h, w = a.shape[:2]
    y = int(rng.integers(0, max(h - res, 0) + 1))
    x = int(rng.integers(0, max(w - res, 0) + 1))
    return a[y : y + res, x : x + res], b[y : y + res, x : x + res]


def _resize_short(img: np.ndarray, res: int) -> np.ndarray:
    """Short side -> ``res`` (PIL's BILINEAR, as the JAX copy resizes)."""
    h, w = img.shape[:2]
    s = res / min(h, w)
    return resize_bilinear(img, max(res, round(h * s)), max(res, round(w * s)))


def _read_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: a PNG through the port's decoder, any
    other format through PIL (``convert("RGB")``, as the JAX copy reads every file)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _procedural_image(idx: int, size: int) -> np.ndarray:
    """Deterministic colorful synthetic 'photo' for hermetic runs."""
    rng = np.random.default_rng(idx)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack(
        [
            127 + 120 * np.sin(xx / rng.uniform(8, 40) + rng.uniform(0, 6)),
            127 + 120 * np.sin(yy / rng.uniform(8, 40) + rng.uniform(0, 6)),
            127 + 120 * np.sin((xx + yy) / rng.uniform(10, 50)),
        ],
        axis=-1,
    )
    for _ in range(rng.integers(2, 6)):
        cx, cy, r = rng.uniform(0, size, 2).tolist() + [rng.uniform(10, size / 3)]
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img[mask] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


class DiffusionDBCanny(DatasetBase):
    """Images with Canny guides at random thresholds; the detector runs on
    ``device`` (the CLIs pass their ``--device``; the JAX class takes and ignores the
    keyword)."""

    name = "diffusiondb_canny"

    def __init__(self, tokenizer=None, resolution: int = 512, use_crop: bool = True,
                 size: int = 1000, seed: int = 0, device="cuda", **_):
        if tokenizer is None:
            from controllora_tpu_torch.data.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.seed = seed
        self.device = device
        self._hub = None
        if os.environ.get("CONTROLLORA_USE_HUB") == "1":
            # opt-in HF hub source (zero-egress containers would stall retrying)
            try:
                from datasets import load_dataset

                self._hub = load_dataset(
                    "poloclub/diffusiondb", "2m_random_1k", split="train",
                    download_mode="reuse_cache_if_exists",
                )
                size = len(self._hub)
            except Exception:
                self._hub = None
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from controllora_tpu_torch.annotators import CannyDetector

        rng = np.random.default_rng(self.seed * 999_983 + idx)
        if self._hub is not None:
            rec = self._hub[int(idx)]
            img = np.asarray(rec["image"].convert("RGB"))
            text = rec["prompt"]
        else:
            img = _procedural_image(idx, self.resolution + 64)
            text = f"synthetic scene {idx}"
        img = _resize_short(img, self.resolution)
        img, _ = _rand_crop_pair(img, img, self.resolution, rng)
        # random thresholds in [1, 255) — the reference's augmentation
        t1, t2 = sorted(rng.integers(1, 255, 2).tolist())
        guide = np.asarray(CannyDetector(self.device)(img, int(t1), int(max(t2, t1 + 1))))
        guide3 = np.repeat(guide[:, :, None], 3, axis=2).astype(np.float32)
        return {
            "pixel_values": img.astype(np.float32) / 127.5 - 1.0,
            "guide_values": guide3 / 127.5 - 1.0,
            "input_ids": self.tokenizer([text])[0],
        }


class _JsonlGuideDataset(DatasetBase):
    """Shared loader: prompt.jsonl with {'image': ..., 'guide': ..., 'text': ...}."""

    data_root = ""
    prompt_file = "prompt.jsonl"

    def __init__(self, tokenizer=None, resolution: int = 512, use_crop: bool = True,
                 seed: int = 0, data_root: Optional[str] = None, **_):
        if tokenizer is None:
            from controllora_tpu_torch.data.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.seed = seed
        self.root = data_root or self.data_root
        path = os.path.join(self.root, self.prompt_file)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — this dataset needs local data "
                f"(see reference process/{self.name}.py)"
            )
        with open(path) as f:
            self.records = [json.loads(l) for l in f if l.strip()]

    def __len__(self):
        return len(self.records)

    def _load_pair(self, rec, rng):
        img = _read_rgb(os.path.join(self.root, rec["image"]))
        guide = _read_rgb(os.path.join(self.root, self._guide_path(rec, rng)))
        return img, guide

    def _guide_path(self, rec, rng):
        return rec["guide"]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 999_983 + idx)
        rec = self.records[idx]
        img, guide = self._load_pair(rec, rng)
        img = _resize_short(img, self.resolution)
        guide = _resize_short(guide, self.resolution)
        if guide.shape != img.shape:
            guide = guide[: img.shape[0], : img.shape[1]]
        img, guide = _rand_crop_pair(img, guide, self.resolution, rng)
        return {
            "pixel_values": img.astype(np.float32) / 127.5 - 1.0,
            "guide_values": guide.astype(np.float32) / 127.5 - 1.0,
            "input_ids": self.tokenizer([rec.get("text", "")])[0],
        }


class MPIIPose(_JsonlGuideDataset):
    name = "mpii_pose"
    data_root = "data/mpii"


class DanbooruSketch(_JsonlGuideDataset):
    """Per-sample random sketch style among precomputed dirs
    (reference process/danbooru_sketch.py:16-32)."""

    name = "danbooru_sketch"
    data_root = "data/danbooru"
    sketch_dirs = ("sketch_a", "sketch_b", "sketch_c")

    def _guide_path(self, rec, rng):
        style = self.sketch_dirs[int(rng.integers(0, len(self.sketch_dirs)))]
        base = os.path.basename(rec["image"])
        return os.path.join(style, base)
