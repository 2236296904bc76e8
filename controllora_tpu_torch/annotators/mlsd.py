"""M-LSD line segment detector (counterpart of ``controllora_tpu/annotators/mlsd.py``;
reference annotator/mlsd/, MobileV2_MLSD_Large and its decode utils.py:19-87), NCHW.

  * ``MobileV2MLSDLarge``: the truncated MobileNetV2 (4-channel input: RGB and a ones
    channel) with FPN taps at features {1, 3, 6, 10, 13}, then the BlockTypeA/B/C
    fusion head (A upsamples by bilinear align_corners, ``utils/image.py::
    resize_align_corners``) to a 16-channel map of which channels 7: are returned.
    Module names are the reference checkpoint's (``backbone.features.N.conv.M``,
    ``block15.conv1.0``, ``block23.conv3``...); batch norm is inference-only.
  * ``decode_centers`` on the device: sigmoid, a 3x3 SAME max window, then the top
    200 centres with ties ordered by the lower flat index, as ``lax.top_k`` orders
    them (a stable descending sort; ``torch.topk`` promises no order among ties).
  * ``pred_lines``' segment filter, ``pred_squares`` and ``squares_from_segments``
    with ``_maxfilter5`` (the hough merge, intersections, corners and square
    scoring) are the JAX package's numpy code, copied; ``draw_lines`` rasterizes
    with OpenPose's ``_draw_line``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.annotators.openpose import _draw_line
from controllora_tpu_torch.annotators.util import build_net, detector_device
from controllora_tpu_torch.utils.image import resize_align_corners, resize_jax

_IR_SETTING = [  # t, c, n, s (truncated MobileNetV2, reference mbv2_mlsd_large.py:173-181)
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
]
_FPN_SELECTED = (1, 3, 6, 10, 13)


def _cbr(cin, cout, k=3, stride=1, groups=1, relu6=True, dilation=1):
    """Conv (no bias) + inference batch norm + ReLU6 (the backbone) or ReLU (the head),
    as ``nn.Sequential`` indices 0, 1, 2."""
    pad = dilation * (k // 2)
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad, dilation=dilation,
                                   groups=groups, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU6() if relu6 else nn.ReLU())


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        layers = [_cbr(cin, hidden, 1)] if expand != 1 else []
        layers += [_cbr(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        return x + self.conv(x) if self.residual else self.conv(x)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        features = [_cbr(4, 32, 3, 2)]
        cin = 32
        for t, c, n, s in _IR_SETTING:
            for j in range(n):
                features.append(InvertedResidual(cin, c, s if j == 0 else 1, t))
                cin = c
        self.features = nn.Sequential(*features)


class BlockTypeA(nn.Module):
    def __init__(self, in_c1: int, in_c2: int, out_c1: int, out_c2: int, upscale=True):
        super().__init__()
        self.conv1 = _cbr(in_c2, out_c2, 1, relu6=False)
        self.conv2 = _cbr(in_c1, out_c1, 1, relu6=False)
        self.upscale = upscale

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = resize_align_corners(b, b.shape[-2] * 2, b.shape[-1] * 2)
        return torch.cat([a, b], 1)


class BlockTypeB(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, relu6=False)
        self.conv2 = _cbr(in_c, out_c, 3, relu6=False)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, relu6=False, dilation=5)
        self.conv2 = _cbr(in_c, in_c, 3, relu6=False)
        self.conv3 = nn.Conv2d(in_c, out_c, 1)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MobileV2MLSDLarge(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = _Backbone()
        self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False)
        self.block16 = BlockTypeB(128, 64)
        self.block17 = BlockTypeA(32, 64, 64, 64)
        self.block18 = BlockTypeB(128, 64)
        self.block19 = BlockTypeA(24, 64, 64, 64)
        self.block20 = BlockTypeB(128, 64)
        self.block21 = BlockTypeA(16, 64, 64, 64)
        self.block22 = BlockTypeB(128, 64)
        self.block23 = BlockTypeC(64, 16)

    def forward(self, x):
        """(B, 4, H, W) in [-1, 1] -> (B, 9, H/2, W/2) tpMap (centre, 4 displacements,
        extras)."""
        feats = []
        for layer in self.backbone.features:
            x = layer(x)
            feats.append(x)
        c1, c2, c3, c4, c5 = (feats[k] for k in _FPN_SELECTED)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[:, 7:]


# ---------------------------------------------------------------------------- decode


def decode_centers(tp_map: torch.Tensor, topk: int = 200, ksize: int = 3):
    """(1, 9, H, W) -> (scores (topk,), ys, xs, displacements (topk, 4) at those
    centres), on the map's device — the reference's deccode_output_score_and_ptss
    (utils.py:19-44)."""
    heat = torch.sigmoid(tp_map[0, 0])
    hmax = F.max_pool2d(heat[None], ksize, stride=1, padding=ksize // 2)[0]
    flat = (heat * (hmax == heat).to(heat.dtype)).reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:topk], idx[:topk]
    w = heat.shape[1]
    ys, xs = idx // w, idx % w
    return scores, ys, xs, tp_map[0, 1:5][:, ys, xs].T


def _centres(image: np.ndarray, net: nn.Module, input_shape):
    """The image resized (jax linear) to input_shape, a ones channel appended, to
    [-1, 1], through ``net`` and ``decode_centers``; numpy on the host."""
    device = next(net.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).float()
    resized = resize_jax(x, input_shape[0], input_shape[1], "linear")
    inp = torch.cat([resized, torch.ones_like(resized[:, :, :1])], -1) / 127.5 - 1.0
    with torch.no_grad():
        tp_map = net(inp.permute(2, 0, 1)[None])
    return [t.cpu().numpy() for t in decode_centers(tp_map)]


def pred_lines(
    image: np.ndarray,
    net: nn.Module,
    input_shape=(512, 512),
    score_thr: float = 0.10,
    dist_thr: float = 20.0,
) -> np.ndarray:
    """image: uint8 HWC RGB -> (N, 4) line segments [x0,y0,x1,y1] in image coords
    (reference utils.py:47-87); the net on its own device."""
    h, w = image.shape[:2]
    scores, ys, xs, disp = _centres(image, net, input_shape)
    segs = []
    for s, y, x, d in zip(scores, ys, xs, disp):
        length = float(np.hypot(d[2] - d[0], d[3] - d[1]))
        if s > score_thr and length > dist_thr:
            segs.append([x + d[0], y + d[1], x + d[2], y + d[3]])
    if not segs:
        return np.zeros((0, 4), np.float32)
    lines = 2.0 * np.asarray(segs, np.float32)  # map 256 -> 512
    lines[:, 0::2] *= w / input_shape[1]
    lines[:, 1::2] *= h / input_shape[0]
    return lines


DEFAULT_SQUARE_PARAMS = {
    "score": 0.06,
    "outside_ratio": 0.28,
    "inside_ratio": 0.45,
    "w_overlap": 0.0,
    "w_degree": 1.95,
    "w_length": 0.0,
    "w_area": 1.86,
    "w_center": 0.14,
}


def _maxfilter5(a: np.ndarray) -> np.ndarray:
    """5x5 max filter, SAME padding (the reference's F.max_pool2d NMS on the hough
    accumulator, utils.py:180-183)."""
    p = np.pad(a, 2, constant_values=-np.inf)
    out = np.full_like(a, -np.inf)
    for dy in range(5):
        for dx in range(5):
            np.maximum(out, p[dy : dy + a.shape[0], dx : dx + a.shape[1]], out)
    return out


def squares_from_segments(
    segments: np.ndarray,
    topk_len: int,
    params: Dict[str, float],
    input_shape=(512, 512),
    original_shape=None,
):
    """Square/quad detection from decoded line segments — the post-processing half of
    the reference's pred_squares (reference annotator/mlsd/utils.py:137-580), factored
    out so it is testable on synthetic scenes without trained weights.

    segments: (N, 4) [x0,y0,x1,y1] in the model's half-resolution (256) frame.
    Returns (merged_segments, squares, scores, inter_points) in original-image coords
    (squares sorted by score, descending).
    """
    original_shape = original_shape or input_shape
    empty = (np.zeros((0, 4), np.float32), np.zeros((0, 4, 2), np.float32),
             np.zeros((0,), np.float32), np.zeros((0, 2), np.float32))
    if len(segments) == 0:
        return empty
    segments = np.asarray(segments, np.float64)

    # ---- 1. merge near-collinear segments on a quantized hough grid (utils.py:139-227)
    start, end = segments[:, :2], segments[:, 2:]
    diff = start - end
    a = diff[:, 1]
    b = -diff[:, 0]
    c = a * start[:, 0] + b * start[:, 1]
    d = np.abs(-c) / np.sqrt(a**2 + b**2 + 1e-10)  # distance of line to (0,0)
    theta = np.arctan2(diff[:, 0], diff[:, 1]) * 180 / np.pi
    theta[theta < 0.0] += 180

    dq = np.floor(d).astype(np.int64)  # d_quant=1
    tq = np.floor(theta / 2).astype(np.int64)  # theta_quant=2
    acc_map = np.zeros((512 + 1, 180 + 1), np.float32)
    idx_map = np.full((512 + 1, 180 + 1), -1, np.int32)
    cells: Dict[Tuple[int, int], list] = {}
    for si in range(len(segments)):
        cell = (int(dq[si]), int(tq[si]))
        if cell[0] > 512 or cell[1] > 180:
            continue
        cells.setdefault(cell, []).append(si)
    for cell, idxs in cells.items():
        acc_map[cell] = len(idxs)
        idx_map[cell] = min(idxs)  # np.unique keeps the first occurrence

    nms = acc_map * (acc_map == _maxfilter5(acc_map))
    flat = nms.reshape(-1)
    k = min(topk_len, flat.size)
    order = np.argsort(flat)[::-1][:k]
    W = acc_map.shape[1]

    merged_segments = []
    for fi in order:
        y, x = int(fi) // W, int(fi) % W
        max_indice = idx_map[y, x]
        if max_indice == -1 or flat[fi] == 0:
            continue
        group = []
        for yo in range(-2, 3):
            for xo in range(-2, 3):
                yy, xx = y + yo, x + xo
                if 0 <= yy < acc_map.shape[0] and 0 <= xx < acc_map.shape[1]:
                    group.extend(cells.get((yy, xx), []))
        pts = segments[group].reshape(-1, 2)
        srt = np.sort(pts, axis=0)
        x_min, y_min = srt[0]
        x_max, y_max = srt[-1]
        if theta[max_indice] >= 90:
            merged_segments.append([x_min, y_max, x_max, y_min])
        else:
            merged_segments.append([x_min, y_min, x_max, y_max])
    if len(merged_segments) < 4:
        return empty

    # ---- 2. pairwise line intersections (utils.py:229-248)
    new_segments = np.asarray(merged_segments, np.float64)
    start, end = new_segments[:, :2], new_segments[:, 2:]
    new_centers = (start + end) / 2.0
    diff = start - end
    dist_segments = np.sqrt(np.sum(diff**2, axis=-1))
    a = diff[:, 1]
    b = -diff[:, 0]
    c = a * start[:, 0] + b * start[:, 1]
    pre_det = a[:, None] * b[None, :]
    det = pre_det - pre_det.T
    pre_iy = a[:, None] * c[None, :]
    inter_y = (pre_iy - pre_iy.T) / (det + 1e-10)
    pre_ix = c[:, None] * b[None, :]
    inter_x = (pre_ix - pre_ix.T) / (det + 1e-10)
    # near-parallel pairs intersect at ~inf; clip to a finite sentinel before the int
    # cast (the distance checks below reject them regardless)
    inter_pts = np.stack([inter_x, inter_y], axis=-1)
    inter_pts = np.clip(np.nan_to_num(inter_pts, posinf=1e9, neginf=-1e9),
                        -2**31 + 1, 2**31 - 1).astype(np.int32)

    # ---- 3. corner classification (utils.py:250-352)
    d1s = np.sqrt(np.sum((inter_pts - start[:, None, :]) ** 2, -1, keepdims=True))
    d1e = np.sqrt(np.sum((inter_pts - end[:, None, :]) ** 2, -1, keepdims=True))
    d2s = np.sqrt(np.sum((inter_pts - start[None, :, :]) ** 2, -1, keepdims=True))
    d2e = np.sqrt(np.sum((inter_pts - end[None, :, :]) ** 2, -1, keepdims=True))
    dist1 = np.sort(np.concatenate([d1s, d1e], -1), -1)  # (N, N, 2)
    dist2 = np.sort(np.concatenate([d2s, d2e], -1), -1)

    v1 = new_centers[:, None, :] - inter_pts
    deg1 = np.arctan2(v1[:, :, 1], v1[:, :, 0]) * 180 / np.pi
    deg1[deg1 < 0] += 360
    v2 = new_centers[None, :, :] - inter_pts
    deg2 = np.arctan2(v2[:, :, 1], v2[:, :, 0]) * 180 / np.pi
    deg2[deg2 < 0] += 360
    deg_sort = np.sort(np.stack([deg1, deg2], -1), -1)
    deg_diff = np.abs(deg1 - deg2)
    deg_diff[deg_diff > 180] = 360 - deg_diff[deg_diff > 180]

    o_r, i_r = params["outside_ratio"], params["inside_ratio"]
    corner_dict: Dict[int, list] = {ci: [] for ci in range(4)}
    inter_points = []
    n = len(new_segments)
    for i in range(n):
        for j in range(i + 1, n):
            if not (60 < deg_diff[i, j] < 120):
                continue
            ok1 = (dist1[i, j, 1] >= dist_segments[i]
                   and dist1[i, j, 0] <= dist_segments[i] * o_r) or (
                dist1[i, j, 1] <= dist_segments[i]
                and dist1[i, j, 0] <= dist_segments[i] * i_r)
            ok2 = (dist2[i, j, 1] >= dist_segments[j]
                   and dist2[i, j, 0] <= dist_segments[j] * o_r) or (
                dist2[i, j, 1] <= dist_segments[j]
                and dist2[i, j, 0] <= dist_segments[j] * i_r)
            if not (ok1 and ok2):
                continue
            x, y = inter_pts[i, j]
            da, db = deg_sort[i, j]
            if (0 <= da <= 45 and 45 <= db <= 120) or (db >= 315 and 45 <= da <= 120):
                ci = 0
            elif 45 <= da <= 125 and 125 <= db <= 225:
                ci = 1
            elif 125 <= da <= 225 and 225 <= db <= 315:
                ci = 2
            elif (0 <= da <= 45 and 225 <= db <= 315) or (db >= 315 and 225 <= da <= 315):
                ci = 3
            else:
                continue
            corner_dict[ci].append([int(x), int(y), i, j])
            inter_points.append([int(x), int(y)])

    # ---- 4. assemble squares from corners sharing lines (utils.py:354-404)
    square_list, connect_list, segments_list = [], [], []
    for c0 in corner_dict[0]:
        for c1 in corner_dict[1]:
            l01 = next((l for l in c0[2:] if l in c1[2:]), None)
            if l01 is None:
                continue
            for c2 in corner_dict[2]:
                l12 = next((l for l in c1[2:] if l in c2[2:]), None)
                if l12 is None:
                    continue
                for c3 in corner_dict[3]:
                    l23 = next((l for l in c2[2:] if l in c3[2:]), None)
                    if l23 is None:
                        continue
                    for l30 in c3[2:]:
                        if l30 in c0[2:]:
                            square_list.append(c0[:2] + c1[:2] + c2[:2] + c3[:2])
                            connect_list.append([l01, l12, l23, l30])
                            segments_list.append(c0[2:] + c1[2:] + c2[2:] + c3[2:])

    def rescale_segs(segs):
        segs = np.asarray(segs, np.float32)
        if len(segs):
            segs[:, 0::2] *= 2 / input_shape[1] * original_shape[1]
            segs[:, 1::2] *= 2 / input_shape[0] * original_shape[0]
        return segs

    ipts = np.asarray(inter_points, np.float32).reshape(-1, 2)
    if len(ipts):
        ipts[:, 0] *= 2 / input_shape[1] * original_shape[1]
        ipts[:, 1] *= 2 / input_shape[0] * original_shape[0]
    if not square_list:
        return (rescale_segs(new_segments), np.zeros((0, 4, 2), np.float32),
                np.zeros((0,), np.float32), ipts)

    # ---- 5. score + rank squares (utils.py:421-549)
    map_size = input_shape[0] / 2
    squares = np.asarray(square_list, np.float64).reshape(-1, 4, 2)
    connect_array = np.asarray(connect_list)
    segments_array = np.asarray(segments_list).reshape(-1, 4, 2)

    vec1 = np.roll(squares, 1, axis=1) - squares
    vec1 /= np.linalg.norm(vec1, axis=-1, keepdims=True) + 1e-10
    vec2 = np.roll(squares, -1, axis=1) - squares
    vec2 /= np.linalg.norm(vec2, axis=-1, keepdims=True) + 1e-10
    sq_degree = np.arccos(np.clip(np.sum(vec1 * vec2, -1), -1, 1)) * 180 / np.pi

    def check_outside_inside(seg_info, connect_idx):
        mat = dist1 if connect_idx == seg_info[0] else dist2
        i, j = seg_info
        min_d, max_d = mat[i, j]
        if max_d > dist_segments[connect_idx]:
            return min_d, 0, 1  # outside: min_dist, cover_param, peri_param
        return min_d, -1, -1  # inside

    overlap_scores, degree_scores, length_scores = [], [], []
    for connects, segs, square, degree in zip(
        connect_array, segments_array, squares, sq_degree
    ):
        cover = perimeter = 0.0
        square_length = []
        for s_idx in range(4):
            e_idx = (s_idx + 1) % 4
            cidx = connects[s_idx]
            s_min, s_cov, s_per = check_outside_inside(segs[s_idx], cidx)
            e_min, e_cov, e_per = check_outside_inside(segs[e_idx], cidx)
            cover += dist_segments[cidx] + s_cov * s_min + e_cov * e_min
            peri = dist_segments[cidx] + s_per * s_min + e_per * e_min
            perimeter += peri
            square_length.append(peri)
        overlap_scores.append(cover / perimeter)
        d0, d1_, d2_, d3 = degree
        r1 = d0 / d2_ if d0 / d2_ <= 1.0 else d2_ / d0
        r2 = d1_ / d3 if d1_ / d3 <= 1.0 else d3 / d1_
        degree_scores.append((r1 + r2) / 2)
        l0, l1, l2, l3 = square_length
        lr1 = l0 / l2 if l2 > l0 else l2 / l0
        lr2 = l1 / l3 if l3 > l1 else l3 / l1
        length_scores.append((lr1 + lr2) / 2)

    overlap_scores = np.asarray(overlap_scores)
    overlap_scores /= np.max(overlap_scores)
    degree_scores = np.asarray(degree_scores)
    length_scores = np.asarray(length_scores)

    ax_, ay_ = squares[:, :, 0], squares[:, :, 1]
    correction = ax_[:, -1] * ay_[:, 0] - ay_[:, -1] * ax_[:, 0]
    area = np.sum(ax_[:, :-1] * ay_[:, 1:], -1) - np.sum(ay_[:, :-1] * ax_[:, 1:], -1)
    area_scores = 0.5 * np.abs(area + correction) / (map_size * map_size)

    # reference quirk preserved: center2center is a SCALAR (np.sum without axis,
    # utils.py:532) — a constant shift that cannot change the ranking
    centers = np.array([[map_size / 2, map_size / 2]], np.float64)
    center2center = np.sqrt(np.sum((centers - np.mean(squares, axis=1)) ** 2))
    center_scores = center2center / (map_size / np.sqrt(2.0))

    score_array = (
        params["w_overlap"] * overlap_scores
        + params["w_degree"] * degree_scores
        + params["w_area"] * area_scores
        - params["w_center"] * center_scores
        + params["w_length"] * length_scores
    )
    order = np.argsort(score_array)[::-1]
    score_array = score_array[order]
    squares = squares[order].astype(np.float32)
    squares[:, :, 0] *= 2 / input_shape[1] * original_shape[1]
    squares[:, :, 1] *= 2 / input_shape[0] * original_shape[0]
    return (rescale_segs(new_segments), squares,
            score_array.astype(np.float32), ipts)




def pred_squares(
    image: np.ndarray,
    net: nn.Module,
    input_shape=(512, 512),
    square_params: Optional[Dict[str, float]] = None,
):
    """Square/quad detection — reference pred_squares (utils.py:89-580): the
    junction decode on the net's device, then the host-side hough merge /
    intersection / corner assembly."""
    square_params = square_params or DEFAULT_SQUARE_PARAMS
    h, w = image.shape[:2]
    scores, ys, xs, disp = _centres(image, net, input_shape)
    segs = []
    for s, y, x, d in zip(scores, ys, xs, disp):
        if s > square_params["score"] and float(np.hypot(d[2] - d[0], d[3] - d[1])) > 20.0:
            segs.append([x + d[0], y + d[1], x + d[2], y + d[3]])
    return squares_from_segments(
        np.asarray(segs, np.float32).reshape(-1, 4), len(scores), square_params,
        input_shape, (h, w),
    )


def draw_lines(shape: Tuple[int, int], lines: np.ndarray, thickness: int = 1):
    """Rasterize white line segments on black (reference mlsd/__init__.py:65-77)."""
    canvas = np.zeros((*shape, 3), np.uint8)
    for x0, y0, x1, y1 in lines:
        _draw_line(canvas, (x0, y0), (x1, y1), (255, 255, 255), width=thickness * 2)
    return canvas


class MLSDdetector:
    """``__call__(uint8 RGB HWC, thr_v, thr_d)`` -> uint8 (H, W) line map (reference
    annotator/mlsd/__init__.py). ``state_dict`` in the checkpoint's key names
    (``from_pretrained`` reads the file); without it, ``seeded_state_dict``'s fill."""

    def __init__(self, state_dict: Optional[Dict] = None, device="cuda"):
        self.device = detector_device(device)
        self.model = build_net(MobileV2MLSDLarge, state_dict, self.device)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda") -> "MLSDdetector":
        from controllora_tpu_torch.utils.convert import annotator_file_state_dict

        return cls(annotator_file_state_dict("mlsd", path, device), device)

    def __call__(self, img: np.ndarray, thr_v: float = 0.1, thr_d: float = 0.1):
        lines = pred_lines(img, self.model, (512, 512), thr_v, thr_d * 200)
        return draw_lines(img.shape[:2], lines)[:, :, 0]
