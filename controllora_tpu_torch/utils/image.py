"""Image input for the sampling CLIs: PNG files read and resized without PIL.

The JAX scripts read images with PIL (``Image.open(path).convert("RGB"|"L")
.resize(size, Image.BICUBIC)``). The card's machine has no PIL, so the port reads
PNGs through its own decoder (``utils/png.py``: 8-bit gray, RGB or RGBA; gray
replicates to RGB, alpha is dropped, as ``convert("RGB")`` does) and resizes with
``F.interpolate(mode="bicubic", antialias=True)``, whose kernel (a = -0.5, widened
by the scale when shrinking) is PIL's, one axis at a time with uint8 rounding
between, as PIL does: within one level of PIL's (PIL's weights are fixed-point).
Other formats are refused with the reason. ``resize_linear`` is the antialiased
bilinear resize of float images that the pipeline (the inpaint mask) and the hires
fix share.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from controllora_tpu_torch.utils.png import SIGNATURE, decode_png


def read_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB; any other file raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG: the port reads images with its own PNG "
                         "decoder (utils/png.py), since the card's machine has no PIL; "
                         "convert the image to PNG")
    return decode_png(data)


def resize_bicubic(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (height, width[, C]) uint8, as PIL's
    ``resize((width, height), Image.BICUBIC)`` within one level: like PIL, the
    horizontal pass runs first and its result is rounded and clamped to uint8 before
    the vertical one (bicubic overshoots at hard edges)."""
    x = torch.from_numpy(np.asarray(image, np.float32))
    x = (x[..., None] if x.dim() == 2 else x).permute(2, 0, 1)[None]
    for size in ((x.shape[2], width), (height, width)):
        if tuple(x.shape[2:]) != size:
            x = F.interpolate(x, size=size, mode="bicubic", antialias=True,
                              align_corners=False).round().clamp(0, 255)
    y = x[0].permute(1, 2, 0).to(torch.uint8).numpy()
    return y[..., 0] if np.asarray(image).ndim == 2 else y


def resize_linear(images, height: int, width: int, device="cpu") -> torch.Tensor:
    """(B, H, W, C) float images (array or tensor) -> (B, height, width, C) fp32 on
    ``device``: ``F.interpolate(mode="bilinear", antialias=True,
    align_corners=False)``, which equals the JAX package's ``jax.image.resize(...,
    "linear")`` within 2e-6 on [-1, 1] images (a triangle filter widened by the
    scale when shrinking, weights renormalised at the border)."""
    x = torch.as_tensor(np.asarray(images, np.float32), device=device).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", antialias=True,
                      align_corners=False)
    return x.permute(0, 2, 3, 1)


def to_luma(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 L, by PIL's ``convert("L")`` integer
    formula (ITU-R 601-2: 0.299 R + 0.587 G + 0.114 B, rounded)."""
    rgb = np.asarray(image, np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def load_image(path: str, resolution: int) -> np.ndarray:
    """An init or guide image: RGB, resized to resolution², in [-1, 1] (float32)."""
    image = resize_bicubic(read_png(path), resolution, resolution)
    return image.astype(np.float32) / 127.5 - 1.0


def load_mask(path: str, resolution: int) -> np.ndarray:
    """An inpainting mask: luma, resized to resolution², in [0, 1] (white =
    repaint)."""
    mask = resize_bicubic(to_luma(read_png(path)), resolution, resolution)
    return mask.astype(np.float32) / 255.0
