"""Annotator utilities (counterpart of ``controllora_tpu/annotators/util.py``).

``HWC3`` (gray/alpha -> RGB, reference annotator/util.py:9-25) is the JAX package's
numpy function, copied. ``resize_image`` (short side -> resolution, H and W rounded
up to multiples of 64, reference annotator/util.py:28-38) reproduces the JAX
package's ``jax.image.resize``: lanczos3 when upscaling, antialiased linear when
downscaling, then rounded and clipped to uint8. Each axis is one weight matrix, built
as jax builds it (``utils/image.py::resize_weights``, which also makes jax's cubic
and nearest modes for the nets' own resizes), so the result is within one uint8 level
of the JAX package's.

``detector_device`` and ``build_net`` are what every detector shares: a device that
is ``cuda`` unless the caller asks for the CPU (never a quiet fallback), and a net
built on it in eval mode from a state dict in the reference checkpoint's key names
(strict) or, without one, from ``seeded_state_dict``'s fan-in-scaled numpy fill.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


def detector_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device where CUDA is absent raises, so a
    detector runs on the CPU only when asked to (``device="cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the annotators run on the card by default and no CUDA device "
                           "is available: pass device='cpu' to run them on the CPU")
    return device


def seeded_state_dict(net: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """A numpy state dict in ``net``'s key names, drawn from ``seed``: conv and linear
    weights N(0, 2 / fan_in) (He: a ReLU stack keeps its scale through the depth),
    biases N(0, 0.01²), norm scales 1 + N(0, 0.1²) and shifts N(0, 0.1²), running
    means N(0, 0.1²) and variances U(0.5, 1.5), tokens and position embeddings
    N(0, 0.02²). The draws follow the state dict's order."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in net.state_dict().items():
        leaf, shape = key.rsplit(".", 1)[-1], tuple(t.shape)
        normal = rng.standard_normal(shape, dtype=np.float32)
        if leaf == "num_batches_tracked":
            out[key] = np.zeros(shape, np.int64)
        elif leaf == "running_var":
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "weight" and len(shape) >= 2:
            out[key] = normal * np.float32(math.sqrt(2.0 / math.prod(shape[1:])))
        elif leaf == "weight":
            out[key] = 1.0 + np.float32(0.1) * normal
        elif leaf == "bias":
            out[key] = np.float32(0.01) * normal
        elif leaf == "running_mean":
            out[key] = np.float32(0.1) * normal
        else:
            out[key] = np.float32(0.02) * normal
    return out


def build_net(make: Callable[[], nn.Module], state_dict: Optional[Dict] = None,
              device="cuda") -> nn.Module:
    """``make()`` on ``device`` in eval mode without gradients, holding
    ``state_dict`` (tensors or numpy arrays in the checkpoint's key names, loaded
    strict) or, without one, ``seeded_state_dict(net, 0)``."""
    with torch.device("meta"):
        net = make()
    if state_dict is None:
        state_dict = seeded_state_dict(net, 0)
    net = net.to_empty(device=detector_device(device))
    net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    return net.eval().requires_grad_(False)


def gaussian_blur(maps: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """(N, H, W) -> (N, H, W) fp32: the JAX package's separable blur, each row
    ``jnp.convolve(row, g, mode="same")`` (zero padding) and then each column, with
    g the normalised Gaussian of 2 * radius + 1 taps. Each pass sums the shifted
    rows or columns tap by tap in one fixed order of elementwise fp32 operations, so
    the card and the CPU give the same bits for the same maps."""
    t = torch.arange(-radius, radius + 1, dtype=torch.float32)
    g = torch.exp(-(t ** 2) / (2 * sigma * sigma))
    g = (g / g.sum()).tolist()
    x = maps.float()
    for axis in (2, 1):
        n = x.shape[axis]
        p = F.pad(x, (radius, radius) if axis == 2 else (0, 0, radius, radius))
        acc = torch.zeros_like(x)
        for j, w in enumerate(g):
            acc = acc + p.narrow(axis, j, n) * w
        x = acc
    return x
