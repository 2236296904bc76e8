"""Image input for the sampling CLIs and the datasets: PNG files read and resized
without PIL.

The JAX scripts read images with PIL (``Image.open(path).convert("RGB"|"L")
.resize(size, Image.BICUBIC)``, the datasets ``Image.BILINEAR``). The card's machine
has no PIL, so the port reads PNGs through its own decoder (``utils/png.py``: 8-bit
gray, RGB or RGBA; gray replicates to RGB, alpha is dropped, as ``convert("RGB")``
does) and resizes them with ``resize_bicubic`` and ``resize_bilinear``, which follow
PIL's 8-bit resample in its own integer arithmetic (libImaging/Resample.c: the
kernel widened by the scale when shrinking, fixed-point weights with 22 fractional
bits, the horizontal pass first, uint8 between the passes), so they equal PIL's
output. Other formats are refused with the reason. ``resize_linear`` is the
antialiased bilinear resize of float images that the pipeline (the inpaint mask)
and the hires fix share; ``resize_jax`` is ``jax.image.resize`` itself for the
annotators: ``"linear"``/``"bilinear"``, ``"cubic"``/``"bicubic"`` (Keys, a = -0.5)
and ``"lanczos3"`` as one weight matrix per axis, antialiased when shrinking, and
``"nearest"`` by jax's half-pixel rule. ``resize_align_corners`` is the bilinear
``align_corners=True`` upsampling of the MLSD and MiDaS decoders.
"""

from __future__ import annotations

import math

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


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# PIL's filters (support, kernel) and its 8-bit fixed point (libImaging/Resample.c)
_PIL_FILTERS = {"bilinear": (1.0, _bilinear), "bicubic": (2.0, _bicubic)}
_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int, mode: str):
    """(first input index, fixed-point weights (out_size, taps)) of one axis, as
    PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them: the kernel's
    support widened by the scale when shrinking, each output's weights normalised in
    double precision, then rounded to 22 fractional bits."""
    support, kernel = _PIL_FILTERS[mode]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [kernel((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        total = 0.0
        for w in k:
            total += w
        for x, w in enumerate(k):
            w = w / total if total != 0.0 else w
            weights[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, weights


def _pil_pass(x: np.ndarray, axis: int, out_size: int, mode: str) -> np.ndarray:
    """One axis of PIL's 8-bit resample: integer sums from half a unit, shifted down
    and clipped to uint8 (``clip8``)."""
    first, weights = _pil_coeffs(x.shape[axis], out_size, mode)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.int64(1 << (_PRECISION_BITS - 1))
    for tap in range(weights.shape[1]):
        idx = np.minimum(first + tap, x.shape[axis] - 1)
        acc = acc + np.take(x, idx, axis=axis) * weights[:, tap].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def _resize_pil(image: np.ndarray, height: int, width: int, mode: str) -> np.ndarray:
    """PIL's ``resize`` of a uint8 image with its ``mode`` filter, in PIL's own
    integer arithmetic: the horizontal pass first, its uint8 result fed to the
    vertical one, an axis whose size does not change left alone."""
    x = np.asarray(image).astype(np.int64)
    if x.shape[1] != width:
        x = _pil_pass(x, 1, width, mode)
    if x.shape[0] != height:
        x = _pil_pass(x, 0, height, mode)
    return x.astype(np.uint8)


def resize_bicubic(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (height, width[, C]) uint8, as PIL's
    ``resize((width, height), Image.BICUBIC)``."""
    return _resize_pil(image, height, width, "bicubic")


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (height, width[, C]) uint8, as PIL's
    ``resize((width, height), Image.BILINEAR)``."""
    return _resize_pil(image, height, width, "bilinear")


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > 3.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (jax's ``_keys_cubic_kernel``;
    ``F.interpolate(mode="bicubic")`` takes a = -0.75), of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(in_size: int, out_size: int, method: str) -> torch.Tensor:
    """(out_size, in_size) fp32 weights of one axis of ``jax.image.resize(...,
    method, antialias=True)`` (jax ``image/scale.py`` ``compute_weight_mat``): the
    kernel's support scaled by 1/scale when shrinking, each output's weights
    normalised, outputs whose sample lies outside the input zeroed."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = ((sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
         / max(inv_scale, 1.0))
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous()


def nearest_indices(in_size: int, out_size: int) -> torch.Tensor:
    """jax's ``"nearest"`` source index of each output, floor((i + 0.5) * in / out)
    in fp32, rounded as XLA compiles it: the constants folded first, (i + 0.5) *
    fp32(in * fp32(1 / out)) (half-pixel centres; ``F.interpolate(mode="nearest")``
    takes floor(i * in / out))."""
    scale = torch.ones((), dtype=torch.float32) / out_size * in_size
    return torch.floor((torch.arange(out_size, dtype=torch.float32) + 0.5) * scale
                       ).to(torch.int64)


def resize_jax(image: torch.Tensor, height: int, width: int, method: str,
               dims=(0, 1)) -> torch.Tensor:
    """``jax.image.resize`` of ``image`` to (height, width) along its axes ``dims``
    ((H, W, C) by default; ``dims=(-2, -1)`` for NCHW), on the image's device:
    fp32 through one weight matrix per axis that changes size (``resize_weights``),
    or, for ``"nearest"``, an index gather in the input's dtype."""
    x = image if method == "nearest" else image.float()
    for axis, size in zip(dims, (height, width)):
        if x.shape[axis] == size:
            continue
        if method == "nearest":
            x = x.index_select(axis, nearest_indices(x.shape[axis], size).to(x.device))
        else:
            w = resize_weights(x.shape[axis], size, method).to(x.device)
            x = torch.tensordot(w, x.movedim(axis, 0), dims=1).movedim(0, axis)
    return x


def resize_align_corners(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, height, width): bilinear with align_corners=True, source
    row i * (h - 1) / (height - 1) (the JAX package's ``_resize_align_corners`` of
    MLSD's BlockTypeA and MiDaS's fusion blocks)."""
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=True)


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
