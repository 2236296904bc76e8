"""MiDaS depth, DPT-hybrid (counterpart of ``controllora_tpu/annotators/midas.py``;
reference annotator/midas/: MidasDetector -> (depth, normal), DPTDepthModel with the
vitb_rn50_384 backbone), NCHW.

  * ``pretrained.model.patch_embed.backbone``: the ResNetV2 stem of timm
    ``StdConv2d``s (weight standardisation at forward time, eps 1e-8, the JAX
    package's ``_std`` formula, which it bakes into imported weights instead) with
    GroupNorm 32, post-activation bottlenecks in stages (3, 4, 9); taps at /4 and /8.
  * ViT-B/16 (768 wide, 12 heads) over the /16 map's 1x1 projection, a cls token and
    position embeddings resized from 24x24 by jax's bilinear rule (antialiased when
    shrinking, ``utils/image.py::resize_jax``); taps after blocks 8 and 11 with the
    'project' readout (``pretrained.act_postprocess{3,4}``).
  * ``scratch``: the reassemble convs, four RefineNet fusion blocks (bilinear
    align_corners x2) and the output head, non-negative.
Module names are the checkpoint's (``pretrained.model.blocks.N.attn.qkv``,
``scratch.refinenet4.resConfUnit1``...); the attention is plain matmul and softmax,
as the JAX package's einsum is. ``depth_to_normal`` and the detector's resizes run
on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.annotators.canny import _sobel
from controllora_tpu_torch.annotators.util import build_net, detector_device
from controllora_tpu_torch.utils.image import resize_align_corners, resize_jax

# ---------------------------------------------------------------------------- resnetv2


class StdConv2d(nn.Conv2d):
    """timm's StdConv2d: each output filter standardised over its inputs and taps,
    (w - mean) / sqrt(var + eps) with the biased variance, at forward time."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        return self._conv_forward(x, (w - mean) / torch.sqrt(var + 1e-8), self.bias)


def _stdconv(cin, cout, k, stride=1):
    return StdConv2d(cin, cout, k, stride, k // 2, bias=False)


class _Downsample(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = _stdconv(cin, cout, 1, stride)
        self.norm = nn.GroupNorm(32, cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2 post-activation bottleneck (preact=False, as built for the
    vit_base_r50 hybrid): conv -> GN + ReLU twice, conv -> GN, plus the normed
    downsample, ReLU."""

    def __init__(self, cin, cout, mid, stride=1, proj=False):
        super().__init__()
        self.downsample = _Downsample(cin, cout, stride) if proj else None
        self.conv1 = _stdconv(cin, mid, 1)
        self.norm1 = nn.GroupNorm(32, mid, eps=1e-5)
        self.conv2 = _stdconv(mid, mid, 3, stride)
        self.norm2 = nn.GroupNorm(32, mid, eps=1e-5)
        self.conv3 = _stdconv(mid, cout, 1)
        self.norm3 = nn.GroupNorm(32, cout, eps=1e-5)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _stdconv(3, 64, 7, 2)
        self.norm = nn.GroupNorm(32, 64, eps=1e-5)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.norm(self.conv(x))), 3, 2, padding=1)


class _Stage(nn.Module):
    def __init__(self, cin, cout, mid, n, stride):
        super().__init__()
        self.blocks = nn.ModuleList(
            Bottleneck(cin if i == 0 else cout, cout, mid, stride if i == 0 else 1, i == 0)
            for i in range(n))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ResNetV2Stem(nn.Module):
    """Stem + 3 stages (3, 4, 9 blocks); returns (/4 256ch, /8 512ch, /16 1024ch)."""

    def __init__(self):
        super().__init__()
        self.stem = _Stem()
        self.stages = nn.ModuleList([_Stage(64, 256, 64, 3, 1), _Stage(256, 512, 128, 4, 2),
                                     _Stage(512, 1024, 256, 9, 2)])

    def forward(self, x):
        h = self.stem(x)
        taps = []
        for stage in self.stages:
            h = stage(h)
            taps.append(h)
        return taps


# ---------------------------------------------------------------------------- vit


class Attention(nn.Module):
    """Multi-head self-attention over tokens: plain matmul and softmax."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        probs = torch.softmax((q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5), dim=-1)
        return self.proj((probs @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim=768, heads=12, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.backbone = ResNetV2Stem()
        self.proj = nn.Conv2d(1024, dim, 1)


class _ViT(nn.Module):
    def __init__(self, dim=768, depth=12, heads=12):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + 24 * 24, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(depth))


class _ProjectReadout(nn.Module):
    """The 'project' readout (reference vit.py:30-42): each token concatenated with
    the cls token, Linear + GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t):
        return self.project(torch.cat([t[:, 1:], t[:, :1].expand_as(t[:, 1:])], -1))


class _Pretrained(nn.Module):
    def __init__(self, dim=768):
        super().__init__()
        self.model = _ViT(dim)
        # Sequential indices of the reference (readout, transpose, unflatten, convs)
        self.act_postprocess3 = nn.Sequential(_ProjectReadout(dim), nn.Identity(),
                                              nn.Identity(), nn.Conv2d(dim, 768, 1))
        self.act_postprocess4 = nn.Sequential(_ProjectReadout(dim), nn.Identity(),
                                              nn.Identity(), nn.Conv2d(dim, 768, 1),
                                              nn.Conv2d(768, 768, 3, 2, 1))


# ---------------------------------------------------------------------------- dpt


class ResidualConvUnit(nn.Module):
    def __init__(self, feats=256):
        super().__init__()
        self.conv1 = nn.Conv2d(feats, feats, 3, padding=1)
        self.conv2 = nn.Conv2d(feats, feats, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _UpAlignCorners(nn.Module):
    def forward(self, x):
        return resize_align_corners(x, x.shape[-2] * 2, x.shape[-1] * 2)


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: (+ resConfUnit1(res)), resConfUnit2, bilinear align_corners
    x2, 1x1 out_conv. The deepest block (refinenet4) takes no ``res`` and leaves its
    resConfUnit1 unused, as the reference does."""

    def __init__(self, feats=256):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(feats)
        self.resConfUnit2 = ResidualConvUnit(feats)
        self.out_conv = nn.Conv2d(feats, feats, 1)

    def forward(self, x, res=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        return self.out_conv(resize_align_corners(x, x.shape[-2] * 2, x.shape[-1] * 2))


class _Scratch(nn.Module):
    def __init__(self, features=256):
        super().__init__()
        for i, cin in enumerate((256, 512, 768, 768), 1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(cin, features, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), _UpAlignCorners(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())


class DPTHybridDepth(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, H, W) non-negative depth; H and W multiples of
    32."""

    def __init__(self, features=256, vit_dim=768, hooks=(8, 11)):
        super().__init__()
        self.hooks = hooks
        self.pretrained = _Pretrained(vit_dim)
        self.scratch = _Scratch(features)

    def forward(self, x):
        b, _, H, W = x.shape
        gh, gw = H // 16, W // 16
        vit = self.pretrained.model
        c1, c2, c3 = vit.patch_embed.backbone(x)
        tokens = vit.patch_embed.proj(c3).flatten(2).transpose(1, 2)
        dim = tokens.shape[-1]
        pos_tok, pos_grid = vit.pos_embed[:, :1], vit.pos_embed[0, 1:]
        side = int(np.sqrt(pos_grid.shape[0]))
        pos_grid = resize_jax(pos_grid.reshape(side, side, dim), gh, gw, "bilinear")
        pos = torch.cat([pos_tok, pos_grid.reshape(1, gh * gw, dim)], 1)
        tokens = torch.cat([vit.cls_token.expand(b, 1, dim), tokens], 1) + pos
        taps = {}
        for i, block in enumerate(vit.blocks):
            tokens = block(tokens)
            if i in self.hooks:
                taps[i] = tokens

        def reassemble(t, post):
            h = post[0](t).transpose(1, 2).reshape(b, dim, gh, gw)
            for conv in post[3:]:
                h = conv(h)
            return h

        l3 = reassemble(taps[self.hooks[0]], self.pretrained.act_postprocess3)
        l4 = reassemble(taps[self.hooks[1]], self.pretrained.act_postprocess4)
        s = self.scratch
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(c2))
        p1 = s.refinenet1(p2, s.layer1_rn(c1))
        return s.output_conv(p1)[:, 0]


# ---------------------------------------------------------------------------- detector


def depth_to_normal(depth: torch.Tensor, a: float = 2 * np.pi, bg_th: float = 0.1):
    """Reference normal-map construction (midas/__init__.py:28-37): (H, W) depth ->
    (depth in [0, 1], (H, W, 3) unit normals), Sobel with a replicate border."""
    gx, gy = (g[0, 0] for g in _sobel(depth[None, None].float()))
    norm01 = (depth - depth.min()) / torch.clamp(depth.max() - depth.min(), min=1e-8)
    gx = torch.where(norm01 < bg_th, 0.0, gx)
    gy = torch.where(norm01 < bg_th, 0.0, gy)
    n = torch.stack([gx, gy, torch.full_like(gx, a)], dim=-1)
    return norm01, n / torch.sqrt(torch.sum(n ** 2, dim=-1, keepdim=True))


class MidasDetector:
    """``__call__(uint8 RGB HWC)`` -> (depth uint8 (H, W), normal uint8 (H, W, 3)).
    ``state_dict`` in the dpt_hybrid checkpoint's key names (``from_pretrained``
    reads the file); without it, ``seeded_state_dict``'s fill."""

    def __init__(self, state_dict: Optional[Dict] = None, device="cuda"):
        self.device = detector_device(device)
        self.model = build_net(DPTHybridDepth, state_dict, self.device)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda") -> "MidasDetector":
        from controllora_tpu_torch.utils.convert import annotator_file_state_dict

        return cls(annotator_file_state_dict("midas", path, device), device)

    def depth(self, input_image: np.ndarray) -> torch.Tensor:
        """(h, w) fp32 depth on the device: the image in [-1, 1] resized (jax linear)
        to multiples of 32, the net, and resized back."""
        h, w = input_image.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(input_image)).to(self.device).float()
        x = resize_jax(x / 127.5 - 1.0, (h + 31) // 32 * 32, (w + 31) // 32 * 32, "linear")
        with torch.no_grad():
            depth = self.model(x.permute(2, 0, 1)[None])[0]
        return resize_jax(depth[:, :, None], h, w, "linear")[:, :, 0]

    def __call__(self, input_image: np.ndarray, a=np.pi * 2.0, bg_th: float = 0.1):
        norm01, normal = depth_to_normal(self.depth(input_image), a, bg_th)
        depth_u8 = (norm01 * 255).clamp(0, 255).to(torch.uint8)
        normal_u8 = (normal * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)
        return depth_u8.cpu().numpy(), normal_u8.cpu().numpy()
