"""DreamBooth dataset — instance (+ optional class) images with fixed prompts
(reference train_dreambooth_lora.py:410-488).

The port's own copy of ``controllora_tpu/data/dreambooth.py``: the port imports
nothing of the JAX package, and reads PNGs without PIL. tests/test_torch_dreambooth.py
holds the two equal.

Yields per index:
  {"pixel_values": (H,W,3) [-1,1], "input_ids": (77,)} and, under prior preservation,
  "class_pixel_values"/"class_input_ids" — the trainer concatenates instance‖class
  halves into one batch (reference collate_fn :500-520).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from controllora_tpu_torch.data.registry import DatasetBase
from controllora_tpu_torch.utils.png import SIGNATURE as PNG_SIGNATURE, decode_png

_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _list_images(root: str):
    return sorted(
        os.path.join(root, f) for f in os.listdir(root) if f.lower().endswith(_EXTS)
    )


def _load_image(path: str, resolution: int, center_crop: bool, rng) -> np.ndarray:
    """The image resized (bilinear) so its short side is ``resolution``, then cropped
    to a square at the centre or at random, in [-1, 1]. A PNG is decoded by the port's
    own codec, and one whose short side is already ``resolution`` needs no resize and
    no PIL (which the card's machine lacks); anything else goes through PIL, as the JAX
    copy does."""
    with open(path, "rb") as f:
        data = f.read()
    img = decode_png(data) if data.startswith(PNG_SIGNATURE) else None
    if img is None or min(img.shape[:2]) != resolution:
        from PIL import Image

        pil = Image.open(path).convert("RGB") if img is None else Image.fromarray(img)
        w, h = pil.size
        scale = resolution / min(w, h)
        img = np.asarray(pil.resize((max(resolution, round(w * scale)),
                                     max(resolution, round(h * scale))), Image.BILINEAR))
    h, w = img.shape[:2]
    if center_crop or (w == resolution and h == resolution):
        x0 = (w - resolution) // 2
        y0 = (h - resolution) // 2
    else:
        x0 = int(rng.integers(0, w - resolution + 1))
        y0 = int(rng.integers(0, h - resolution + 1))
    crop = img[y0:y0 + resolution, x0:x0 + resolution]
    return crop.astype(np.float32) / 127.5 - 1.0


class DreamBoothDataset(DatasetBase):
    name = "dreambooth"

    def __init__(
        self,
        tokenizer=None,
        instance_data_dir: str = "",
        instance_prompt: str = "",
        class_data_dir: Optional[str] = None,
        class_prompt: Optional[str] = None,
        resolution: int = 512,
        center_crop: bool = False,
        seed: int = 0,
        **_,
    ):
        if tokenizer is None:
            from controllora_tpu_torch.data.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self.instance_images = _list_images(instance_data_dir)
        if not self.instance_images:
            raise ValueError(f"no images under {instance_data_dir}")
        self.instance_ids = tokenizer([instance_prompt])[0]
        self.class_images = _list_images(class_data_dir) if class_data_dir else []
        self.class_ids = tokenizer([class_prompt])[0] if class_prompt else None
        self.resolution = resolution
        self.center_crop = center_crop
        self.seed = seed

    def __len__(self) -> int:
        return max(len(self.instance_images), len(self.class_images) or 1)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        out = {
            "pixel_values": _load_image(
                self.instance_images[idx % len(self.instance_images)],
                self.resolution, self.center_crop, rng,
            ),
            "input_ids": self.instance_ids,
        }
        if self.class_images:
            out["class_pixel_values"] = _load_image(
                self.class_images[idx % len(self.class_images)],
                self.resolution, self.center_crop, rng,
            )
            out["class_input_ids"] = self.class_ids
        return out
