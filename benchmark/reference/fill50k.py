"""fill50k-style guides and images (ControlNet's circles task): a filled circle of one
of 12 colours on another, its 3-pixel ring as the guide, and the caption "<fg>
circle with <bg> background". Item i of the 50,000 is drawn from
``numpy.random.default_rng(seed * 1_000_003 + i)``; a batch of the training stream
draws its items with replacement from ``default_rng(stream seed)``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

COLORS = {
    "red": (220, 40, 40), "green": (40, 180, 60), "blue": (50, 80, 220),
    "yellow": (230, 220, 50), "purple": (150, 60, 200), "cyan": (60, 200, 210),
    "orange": (240, 150, 40), "pink": (240, 130, 180), "brown": (150, 100, 60),
    "gray": (128, 128, 128), "white": (240, 240, 240), "black": (20, 20, 20),
}
NAMES = list(COLORS)
SIZE = 50_000


def spec(index: int, resolution: int, seed: int = 0) -> Tuple[str, str, float, float, float]:
    """(background, foreground, cx, cy, radius) of item ``index``."""
    rng = np.random.default_rng(seed * 1_000_003 + index)
    bg, fg = rng.choice(len(NAMES), size=2, replace=False)
    radius = rng.uniform(0.08, 0.35) * resolution
    cx = rng.uniform(radius + 2, resolution - radius - 2)
    cy = rng.uniform(radius + 2, resolution - radius - 2)
    return NAMES[int(bg)], NAMES[int(fg)], cx, cy, radius


def caption(item: Tuple[str, str, float, float, float]) -> str:
    return f"{item[1]} circle with {item[0]} background"


def draw(item, resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """(image, guide), (H, W, 3) float32 in [-1, 1]: the circle with a 1-pixel
    anti-aliased edge, the guide 1 where |d - radius| <= 1.5 and -1 elsewhere, in
    float32 arithmetic."""
    bg, fg, cx, cy, radius = item
    f32 = np.float32
    grid = np.arange(resolution, dtype=f32)
    dx = grid[None, :] - f32(cx)
    dy = grid[:, None] - f32(cy)
    d = np.sqrt(dx * dx + dy * dy)
    rad = f32(radius)
    a = np.where(d <= rad - f32(0.5), f32(1.0),
                 np.where(d >= rad + f32(0.5), f32(0.0), rad + f32(0.5) - d)).astype(f32)
    fg_c = np.asarray(COLORS[fg], f32)
    bg_c = np.asarray(COLORS[bg], f32)
    img = fg_c * a[:, :, None] + bg_c * (f32(1.0) - a[:, :, None])
    ring = np.where(np.abs(d - rad) <= f32(1.5), f32(1.0), f32(-1.0))
    return img / f32(127.5) - f32(1.0), np.repeat(ring[:, :, None], 3, axis=2)


def stream_batches(stream_seed: int, batch: int, count: int, resolution: int
                   ) -> List[Dict[str, object]]:
    """The first ``count`` batches of the training stream: items, images, guides and
    captions."""
    rng = np.random.default_rng(stream_seed)
    out = []
    for _ in range(count):
        items = [spec(int(i), resolution) for i in rng.integers(0, SIZE, batch)]
        drawn = [draw(it, resolution) for it in items]
        out.append({"images": np.stack([d[0] for d in drawn]),
                    "guides": np.stack([d[1] for d in drawn]),
                    "captions": [caption(it) for it in items]})
    return out
