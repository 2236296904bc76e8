"""fill50k — the ControlNet circles sanity workload, synthesized locally.

The port's own copy of ``controllora_tpu/data/fill50k.py`` (numpy only):
the port imports nothing of the JAX package. tests/test_torch_standalone.py
holds the two equal.

The reference builds fill50k from ControlNet's zip (reference
tasks/make_dataset_fill50k.py:14-28): target = a filled circle on a colored background,
guide = the circle outline, caption "<color> circle with <color> background". With no
network in this container we synthesize the same distribution procedurally, so training
smoke tests and benchmarks run hermetically. Also registered under
"process/fill50k" in the reference's registry convention.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from controllora_tpu_torch.data.registry import DatasetBase

# ControlNet fill50k palette-style named colors
_COLORS = {
    "red": (220, 40, 40),
    "green": (40, 180, 60),
    "blue": (50, 80, 220),
    "yellow": (230, 220, 50),
    "purple": (150, 60, 200),
    "cyan": (60, 200, 210),
    "orange": (240, 150, 40),
    "pink": (240, 130, 180),
    "brown": (150, 100, 60),
    "gray": (128, 128, 128),
    "white": (240, 240, 240),
    "black": (20, 20, 20),
}
_NAMES = list(_COLORS)


class Fill50kSynthetic(DatasetBase):
    name = "fill50k"

    def __init__(
        self,
        tokenizer=None,
        resolution: int = 512,
        size: int = 50_000,
        seed: int = 0,
        use_crop: bool = True,  # accepted for reference CLI parity; crops are a no-op
        **_,  # the CLIs' device=, which only the Canny dataset uses
    ):
        if tokenizer is None:
            from controllora_tpu_torch.data.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def _sample_spec(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        bg, fg = rng.choice(len(_NAMES), size=2, replace=False)
        r = self.resolution
        radius = rng.uniform(0.08, 0.35) * r
        cx = rng.uniform(radius + 2, r - radius - 2)
        cy = rng.uniform(radius + 2, r - radius - 2)
        return _NAMES[int(bg)], _NAMES[int(fg)], cx, cy, radius

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        bg_name, fg_name, cx, cy, radius = self._sample_spec(idx)
        r = self.resolution
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32)
        dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)

        img = np.empty((r, r, 3), np.float32)
        img[:] = np.asarray(_COLORS[bg_name], np.float32)
        mask = dist <= radius
        img[mask] = np.asarray(_COLORS[fg_name], np.float32)

        ring = (np.abs(dist - radius) <= 1.5).astype(np.float32)
        guide = np.repeat(ring[:, :, None], 3, axis=2) * 255.0

        caption = f"{fg_name} circle with {bg_name} background"
        return {
            "pixel_values": img / 127.5 - 1.0,
            "guide_values": guide / 127.5 - 1.0,
            "input_ids": self.tokenizer([caption])[0],
        }
