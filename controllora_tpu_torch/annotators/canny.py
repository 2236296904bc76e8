"""Canny edge detector as torch ops (counterpart of
``controllora_tpu/annotators/canny.py``, the reference's cv2.Canny equivalent,
reference annotator/canny/__init__.py:4-6). It runs where its input lies: a CUDA
tensor stays on the card.

The JAX function, step for step, with the same edge map bit for bit:
  * Sobel 3x3 with a replicate border, as shifted adds of the padded image (no
    convolution, so no TF32 or cuDNN algorithm choice can touch it; on integer-valued
    images every sum is exact), L1 magnitude (cv2's L2gradient=False);
  * per pixel, the gradient of the channel with the largest magnitude, the first on
    ties (``jnp.argmax``'s rule, and ``torch.argmax``'s);
  * 4-sector non-maximum suppression at tan(22.5 deg) / tan(67.5 deg) in fp32, with
    the ``>`` / ``>=`` asymmetry and zero-filled neighbours at the border;
  * ``strong = nms > high``, ``weak = nms > low``, then hysteresis: ``strong`` grows
    into ``weak`` by 8-neighbour dilation (a 3x3 max pool of the mask, taken where
    ``weak`` holds) for exactly ``max_hysteresis_iters`` steps, with no host sync. A
    step past the fixed point changes nothing, so this equals the JAX
    ``while_loop``, which stops at the fixed point or at the cap.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

_TAN22 = 0.4142135623730951  # tan(pi/8)
_TAN67 = 2.414213562373095  # tan(3pi/8)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y - dy, x - dx], zero where that falls outside (the
    JAX ``_shift``: a roll whose wrapped rows and columns are zeroed)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def _sobel(img: torch.Tensor):
    """(gx, gy) of (B, C, H, W) fp32 with a replicate border: the JAX ``_conv2`` of
    the Sobel kernels (a cross-correlation), tap by tap."""
    h, w = img.shape[-2:]
    p = F.pad(img, (1, 1, 1, 1), mode="replicate")

    def tap(i, j):
        return p[..., i:i + h, j:j + w]

    gx = (tap(0, 2) - tap(0, 0)) + 2.0 * (tap(1, 2) - tap(1, 0)) + (tap(2, 2) - tap(2, 0))
    gy = (tap(2, 0) - tap(0, 0)) + 2.0 * (tap(2, 1) - tap(0, 1)) + (tap(2, 2) - tap(0, 2))
    return gx, gy


def canny(image: Union[torch.Tensor, np.ndarray], low_threshold, high_threshold,
          max_hysteresis_iters: int = 64) -> torch.Tensor:
    """Edge map (0/255 uint8) of an (H, W), (H, W, C) or (B, H, W, C) image, uint8 or
    float in [0, 255]: (H, W), or (B, H, W) for a batch, on the image's device (a
    numpy image runs on the CPU)."""
    x = torch.as_tensor(np.asarray(image) if isinstance(image, np.ndarray) else image)
    if x.dim() == 2:
        x = x[:, :, None]
    batched = x.dim() == 4
    img = (x if batched else x[None]).to(torch.float32).permute(0, 3, 1, 2)

    gx, gy = _sobel(img)
    mag_c = gx.abs() + gy.abs()  # L1, per channel
    cidx = mag_c.argmax(dim=1, keepdim=True)
    gx = gx.gather(1, cidx)[:, 0]
    gy = gy.gather(1, cidx)[:, 0]
    mag = gx.abs() + gy.abs()

    # sector NMS (cv2 quantization)
    tan22 = torch.tensor(_TAN22, dtype=torch.float32, device=mag.device)
    tan67 = torch.tensor(_TAN67, dtype=torch.float32, device=mag.device)
    ax, ay = gx.abs(), gy.abs()
    horiz = ay <= tan22 * ax  # gradient ~ horizontal -> compare left/right
    vert = ay >= tan67 * ax  # gradient ~ vertical -> compare up/down
    same_sign = (gx * gy) >= 0  # diagonal direction selector
    keep_h = (mag > _shift(mag, 0, 1)) & (mag >= _shift(mag, 0, -1))
    keep_v = (mag > _shift(mag, 1, 0)) & (mag >= _shift(mag, -1, 0))
    keep_d1 = (mag > _shift(mag, 1, 1)) & (mag >= _shift(mag, -1, -1))  # 135 deg
    keep_d2 = (mag > _shift(mag, 1, -1)) & (mag >= _shift(mag, -1, 1))  # 45 deg
    keep = torch.where(horiz, keep_h,
                       torch.where(vert, keep_v, torch.where(same_sign, keep_d1, keep_d2)))
    nms = torch.where(keep, mag, torch.zeros((), dtype=mag.dtype, device=mag.device))

    # the thresholds in fp32, as the JAX detector passes them (jnp.float32)
    strong = nms > torch.tensor(float(high_threshold), dtype=torch.float32, device=nms.device)
    weak = nms > torch.tensor(float(low_threshold), dtype=torch.float32, device=nms.device)

    # hysteresis: grow `strong` into `weak` by 8-neighbourhood dilation. A step is
    # JAX's (dilate(cur) & weak) | cur: the 3x3 max includes the pixel itself, so a
    # weak pixel takes it and any other keeps its value
    edges = strong[:, None].to(torch.float32)
    weak = weak[:, None]
    for _ in range(max_hysteresis_iters):
        edges = torch.where(weak, F.max_pool2d(edges, 3, stride=1, padding=1), edges)
    out = edges[:, 0].to(torch.uint8) * 255
    return out if batched else out[0]


class CannyDetector:
    """Drop-in for the reference's CannyDetector (annotator/canny/__init__.py): a
    numpy image in, a numpy (H, W) uint8 edge map out, computed on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def __call__(self, img: np.ndarray, low_threshold, high_threshold) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return canny(x, float(low_threshold), float(high_threshold)).cpu().numpy()
