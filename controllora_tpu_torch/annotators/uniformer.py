"""UniFormer-S + UPerNet ADE20K segmentation (counterpart of
``controllora_tpu/annotators/uniformer.py``; reference annotator/uniformer/:
UniformerDetector, the mmseg UniFormer backbone and UPerHead, config
exp/upernet_global_small), NCHW, test mode 'whole'.

  * ``UniFormerBackbone``: 4 stages (3, 4, 8, 3 blocks; widths 64/128/320/512; head
    dim 64), each after a patch embedding (conv + LayerNorm over channels); stages 1-2
    convolutional MHRA blocks (``CBlock``: depthwise position conv, batch norm,
    1x1 - 5x5 depthwise - 1x1, conv MLP), stages 3-4 global self-attention blocks
    (``SABlock``: LayerNorm, plain matmul and softmax as the JAX package's einsum),
    each stage's output LayerNorm'd.
  * ``UPerHead``: the pyramid pooling module at scales 1/2/3/6
    (``F.adaptive_avg_pool2d``: torch's window rule, which the JAX
    ``_adaptive_avg_pool`` copies) and the FPN, BN ConvModules of 512 channels, 150
    classes; every upsampling is jax's ``"bilinear"`` resize
    (``utils/image.py::resize_jax``).
Module names are the mmseg checkpoint's (``backbone.blocks1.0.attn``,
``decode_head.psp_modules.0.1.conv``...; the file's nested ``"state_dict"`` is taken
first). The detector takes the argmax on the device, resizes the labels back by jax's
``"nearest"`` rule and paints them with the ADE20K palette.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.annotators.midas import Attention, Mlp
from controllora_tpu_torch.annotators.util import build_net, detector_device
from controllora_tpu_torch.utils.image import resize_jax

_DIMS = (64, 128, 320, 512)
_DEPTHS = (3, 4, 8, 3)
_HEAD_DIM = 64

_IMAGENET_MEAN = (123.675, 116.28, 103.53)
_IMAGENET_STD = (58.395, 57.12, 57.375)


def _channels_last_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _CMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CBlock(nn.Module):
    """Convolutional MHRA block (reference uniformer.py:62-81)."""

    def __init__(self, dim, mlp_ratio=4):
        super().__init__()
        self.pos_embed = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.norm1 = nn.BatchNorm2d(dim)
        self.conv1 = nn.Conv2d(dim, dim, 1)
        self.attn = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv2 = nn.Conv2d(dim, dim, 1)
        self.norm2 = nn.BatchNorm2d(dim)
        self.mlp = _CMlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        return x + self.mlp(self.norm2(x))


class SABlock(nn.Module):
    """Global self-attention block (reference uniformer.py:112-135)."""

    def __init__(self, dim, heads, mlp_ratio=4):
        super().__init__()
        self.pos_embed = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, hh, ww = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + self.attn(self.norm1(t))
        t = t + self.mlp(self.norm2(t))
        return t.transpose(1, 2).reshape(b, c, hh, ww)


class _PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return _channels_last_norm(self.norm, self.proj(x))


class UniFormerBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for si, (dim, depth) in enumerate(zip(_DIMS, _DEPTHS), 1):
            setattr(self, f"patch_embed{si}", _PatchEmbed(cin, dim, 4 if si == 1 else 2))
            setattr(self, f"blocks{si}", nn.ModuleList(
                CBlock(dim) if si <= 2 else SABlock(dim, dim // _HEAD_DIM)
                for _ in range(depth)))
            setattr(self, f"norm{si}", nn.LayerNorm(dim, eps=1e-6))
            cin = dim

    def forward(self, x):
        outs = []
        for si in range(1, 5):
            x = getattr(self, f"patch_embed{si}")(x)
            for block in getattr(self, f"blocks{si}"):
                x = block(x)
            outs.append(_channels_last_norm(getattr(self, f"norm{si}"), x))
        return outs


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (no bias) + BN + ReLU."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return resize_jax(x, hw[0], hw[1], "bilinear", dims=(-2, -1))


class UPerHead(nn.Module):
    def __init__(self, in_channels=_DIMS, channels=512, num_classes=150,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(in_channels[-1], channels, 1))
            for s in pool_scales)
        self.bottleneck = ConvModule(in_channels[-1] + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvModule(channels, channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        c4 = feats[-1]
        psp = [c4] + [_resize(m(c4), c4.shape[-2:]) for m in self.psp_modules]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats[:-1])]
        laterals.append(self.bottleneck(torch.cat(psp, 1)))
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + _resize(laterals[i + 1], laterals[i].shape[-2:])
        outs = [conv(laterals[i]) for i, conv in enumerate(self.fpn_convs)] + [laterals[-1]]
        outs = [_resize(f, outs[0].shape[-2:]) for f in outs]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, 1)))


class UniFormerSeg(nn.Module):
    """Normalized (B, 3, H, W) image -> (B, 150, H, W) class logits."""

    def __init__(self):
        super().__init__()
        self.backbone = UniFormerBackbone()
        self.decode_head = UPerHead()

    def forward(self, x):
        return _resize(self.decode_head(self.backbone(x)), x.shape[-2:])


def ade_palette() -> List[List[int]]:
    """ADE20K 150-class palette (standard mmseg colors)."""
    rng = np.random.default_rng(42)
    base = rng.integers(0, 255, (150, 3))
    # the exact mmseg palette's first entries, rest deterministic pseudo-colors
    known = [
        [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
        [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
        [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
        [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
        [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
        [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
        [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220],
        [255, 9, 92], [112, 9, 255], [8, 255, 214], [7, 255, 224],
        [255, 184, 6], [10, 255, 71], [255, 41, 10], [7, 255, 255],
        [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7],
    ]
    out = np.array(known + base[len(known):].tolist())
    return out[:150].tolist()


class UniformerDetector:
    """``__call__(uint8 RGB HWC)`` -> uint8 HWC ADE20K colour map (reference
    annotator/uniformer/__init__.py:11-23). ``state_dict`` in the mmseg checkpoint's
    key names (``from_pretrained`` reads the file and takes its ``"state_dict"``);
    without it, ``seeded_state_dict``'s fill."""

    def __init__(self, state_dict: Optional[Dict] = None, device="cuda"):
        self.device = detector_device(device)
        self.model = build_net(UniFormerSeg, state_dict, self.device)
        self.palette = np.array(ade_palette(), np.uint8)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda") -> "UniformerDetector":
        from controllora_tpu_torch.utils.convert import annotator_file_state_dict

        return cls(annotator_file_state_dict("uniformer", path, device), device)

    def logits(self, img: np.ndarray) -> torch.Tensor:
        """(150, H', W') fp32 class logits on the device, H' and W' the image's size
        rounded up to multiples of 32: ImageNet-normalised (in float64 on the host,
        as the JAX detector's numpy does), resized by jax's linear rule."""
        h, w = img.shape[:2]
        x = (np.asarray(img, np.float32) - _IMAGENET_MEAN) / _IMAGENET_STD
        x = torch.from_numpy(x.astype(np.float32)).to(self.device)
        x = resize_jax(x, (h + 31) // 32 * 32, (w + 31) // 32 * 32, "linear")
        with torch.no_grad():
            return self.model(x.permute(2, 0, 1)[None])[0]

    def labels(self, img: np.ndarray) -> torch.Tensor:
        """(H, W) int64 class labels on the device: the argmax, resized back by jax's
        nearest rule."""
        seg = self.logits(img).argmax(0)
        return resize_jax(seg, img.shape[0], img.shape[1], "nearest")

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self.palette[self.labels(img).cpu().numpy()]
