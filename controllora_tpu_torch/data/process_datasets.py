"""The reference's process/ dataset zoo (SURVEY.md §2.1 data layer): the port's own
copy of ``controllora_tpu/data/process_datasets.py``, so that
``DatasetBase.from_name`` resolves the same names.

  * diffusiondb_canny — on-the-fly Canny guides; registered, but its items need the
    Canny annotator, which is not ported yet (reading one raises).
  * mpii_pose — prompt.jsonl + precomputed pose-guide images with a synchronized
    random crop (reference process/mpii_pose.py:29-36).
  * danbooru_sketch — jsonl prompts + per-sample random choice among 3 precomputed
    sketch-style directories (reference process/danbooru_sketch.py:16-32).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from controllora_tpu_torch.data.registry import DatasetBase


def _rand_crop_pair(a: np.ndarray, b: np.ndarray, res: int, rng) -> tuple:
    """Synchronized random crop (reference train:615-635 / mpii_pose.py:29-36)."""
    h, w = a.shape[:2]
    y = int(rng.integers(0, max(h - res, 0) + 1))
    x = int(rng.integers(0, max(w - res, 0) + 1))
    return a[y : y + res, x : x + res], b[y : y + res, x : x + res]


def _resize_short(img: np.ndarray, res: int) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    s = res / min(h, w)
    return np.asarray(
        Image.fromarray(img).resize((max(res, round(w * s)), max(res, round(h * s))),
                                    Image.BILINEAR)
    )


class DiffusionDBCanny(DatasetBase):
    """Registered under the JAX package's name. Its guides are Canny edges of each
    image with random thresholds, and the Canny annotator is not ported yet (ROADMAP
    Queue 1 item 15), so reading an item raises."""

    name = "diffusiondb_canny"

    def __init__(self, tokenizer=None, resolution: int = 512, use_crop: bool = True,
                 size: int = 1000, seed: int = 0, **_):
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError("process/diffusiondb_canny needs the Canny annotator, "
                                  "which is not ported yet: ROADMAP Queue 1 item 15")


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
        from PIL import Image

        img = np.asarray(Image.open(os.path.join(self.root, rec["image"])).convert("RGB"))
        guide = np.asarray(Image.open(os.path.join(self.root, self._guide_path(rec, rng))).convert("RGB"))
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
