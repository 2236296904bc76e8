"""HED soft-edge annotator (counterpart of ``controllora_tpu/annotators/hed.py``;
reference annotator/hed/__init__.py:9-94): a 5-stage VGG edge net with 1x1 score
heads, NCHW.

``HEDNetwork``'s modules carry the ControlNet ``network-bsds500.pth`` names
(``netVggOne.0``, ``netScoreOne``, ``netCombine.0``; the file's ``module`` prefix is
renamed to ``net`` as the reference does, annotator/hed/__init__.py:70). Each side
output is upsampled to the input size by jax's ``"bilinear"`` resize
(``utils/image.py::resize_jax``). The scribble post-process ``hed_nms`` (blur with
radius round(3 sigma), directional ridge maxima, threshold) runs on the device; its
directional shifts wrap at the edges, as ``jnp.roll`` does (``torch.roll``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from controllora_tpu_torch.annotators.util import build_net, detector_device, gaussian_blur
from controllora_tpu_torch.utils.image import resize_jax

# Caffe-era BGR mean (the reference feeds BGR: input_image[:, :, ::-1], then subtracts
# this mean, annotator/hed/__init__.py:78-79, 106-109)
_BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)

_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_STAGE_NAMES = ("One", "Two", "Thr", "Fou", "Fiv")


class HEDNetwork(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for si, (widths, sname) in enumerate(zip(_STAGES, _STAGE_NAMES)):
            layers = [nn.MaxPool2d(2, 2)] if si > 0 else []
            for w in widths:
                layers += [nn.Conv2d(cin, w, 3, padding=1), nn.ReLU()]
                cin = w
            setattr(self, f"netVgg{sname}", nn.Sequential(*layers))
            setattr(self, f"netScore{sname}", nn.Conv2d(cin, 1, 1))
        self.netCombine = nn.Sequential(nn.Conv2d(5, 1, 1), nn.Sigmoid())

    def forward(self, x_bgr01: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) BGR in [0, 1] -> (B, 1, H, W) edge probability."""
        H, W = x_bgr01.shape[-2:]
        mean = torch.tensor(_BGR_MEAN, dtype=torch.float32, device=x_bgr01.device)
        x = x_bgr01 * 255.0 - mean.view(1, 3, 1, 1)
        scores = []
        for sname in _STAGE_NAMES:
            x = getattr(self, f"netVgg{sname}")(x)
            s = getattr(self, f"netScore{sname}")(x)
            scores.append(resize_jax(s, H, W, "bilinear", dims=(-2, -1)))
        return self.netCombine(torch.cat(scores, 1))


def hed_nms(x: torch.Tensor, threshold: float, sigma: float) -> torch.Tensor:
    """Scribble post-process (reference annotator/hed/__init__.py:117-132): Gaussian
    blur, keep the ridge maxima along any of 4 directions (neighbours taken by a
    wrapping roll), binarize. x: (H, W) float in [0, 255] -> (H, W) uint8 0/255 on
    x's device."""
    blurred = gaussian_blur(x.float()[None], sigma, max(1, int(round(3.0 * sigma))))[0]
    dirs = (
        ((0, -1), (0, 1)),    # horizontal line
        ((-1, 0), (1, 0)),    # vertical
        ((-1, -1), (1, 1)),   # main diagonal
        ((-1, 1), (1, -1)),   # anti diagonal
    )
    y = torch.zeros_like(blurred)
    for d1, d2 in dirs:
        dil = torch.maximum(blurred, torch.maximum(torch.roll(blurred, d1, (0, 1)),
                                                   torch.roll(blurred, d2, (0, 1))))
        y = torch.where(dil == blurred, blurred, y)
    return (y > threshold).to(torch.uint8) * 255


def nms(x: np.ndarray, t: float, s: float) -> np.ndarray:
    """Reference-API wrapper over hed_nms (annotator/hed/__init__.py:117), on the CPU."""
    return hed_nms(torch.as_tensor(np.asarray(x, np.float32)), t, s).numpy()


class HEDdetector:
    """``__call__(uint8 RGB HWC)`` -> uint8 (H, W) edge map, like the reference
    detector. ``state_dict`` in the checkpoint's key names (``from_pretrained`` reads
    the file); without it, ``seeded_state_dict``'s fill."""

    def __init__(self, state_dict: Optional[Dict] = None, device="cuda"):
        self.device = detector_device(device)
        self.net = build_net(HEDNetwork, state_dict, self.device)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda") -> "HEDdetector":
        from controllora_tpu_torch.utils.convert import annotator_file_state_dict

        return cls(annotator_file_state_dict("hed", path, device), device)

    def edge(self, input_image: np.ndarray) -> torch.Tensor:
        """(H, W) edge probability, fp32 on the device."""
        assert input_image.ndim == 3
        bgr = torch.from_numpy(np.ascontiguousarray(input_image[:, :, ::-1])).to(self.device)
        with torch.no_grad():
            return self.net((bgr.float() / 255.0).permute(2, 0, 1)[None])[0, 0]

    def __call__(self, input_image: np.ndarray) -> np.ndarray:
        return (self.edge(input_image) * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
