"""Annotator image utilities (counterpart of ``controllora_tpu/annotators/util.py``).

``HWC3`` (gray/alpha -> RGB, reference annotator/util.py:9-25) is the JAX package's
numpy function, copied. ``resize_image`` (short side -> resolution, H and W rounded
up to multiples of 64, reference annotator/util.py:28-38) reproduces the JAX
package's ``jax.image.resize``: lanczos3 when upscaling, antialiased linear when
downscaling, then rounded and clipped to uint8. Each axis is one weight matrix, built
as jax builds it (``utils/image.py::resize_weights``), so the result is within one
uint8 level of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from controllora_tpu_torch.utils.image import resize_jax


def HWC3(x: np.ndarray) -> np.ndarray:
    """uint8 HW/HWC{1,3,4} -> HWC3 (alpha composited over white, like the reference)."""
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] == 1:
        return np.repeat(x, 3, axis=2)
    if x.shape[2] == 3:
        return x
    if x.shape[2] == 4:
        color = x[:, :, :3].astype(np.float32)
        alpha = x[:, :, 3:].astype(np.float32) / 255.0
        y = color * alpha + 255.0 * (1.0 - alpha)
        return y.clip(0, 255).astype(np.uint8)
    raise ValueError(f"bad channel count {x.shape}")


def resize_image(image: np.ndarray, resolution: int) -> np.ndarray:
    """Scale so the short side == resolution, round H/W up to multiples of 64
    (reference annotator/util.py:28-38); (H, W, C) uint8 in and out."""
    h, w = image.shape[:2]
    k = resolution / min(h, w)
    H = int(math.ceil(h * k / 64.0)) * 64
    W = int(math.ceil(w * k / 64.0)) * 64
    method = "lanczos3" if k > 1 else "linear"
    out = resize_jax(torch.from_numpy(np.asarray(image, np.float32)), H, W, method)
    return out.round().clamp(0, 255).to(torch.uint8).numpy()
