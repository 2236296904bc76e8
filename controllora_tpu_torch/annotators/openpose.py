"""OpenPose body and hand estimation (counterpart of
``controllora_tpu/annotators/openpose.py``; reference annotator/openpose/).

  * ``BodyposeModel``: the VGG trunk and six two-branch CPM stages (38 PAF and 19
    heatmap channels); ``HandposeModel``: the single-branch 22-keypoint CPM. Both are
    ``nn.Sequential``s named as the CMU checkpoints' modules (``model0.conv1_1``,
    ``model2_1.Mconv1_stage2_L1``, ``model1_0.conv5_3_CPM``...), so their state dicts
    load strict; NCHW.
  * ``infer_maps`` / ``infer_hand`` keep the JAX scale loop: boxsize 368, stride 8,
    jax's cubic resize in and out (``utils/image.py::resize_jax``), pad value 128,
    inputs / 256 - 0.5. The maps stay on the detector's device.
  * The sigma-3 blur (``jnp.convolve(mode="same")``: zero padding, radius round(4
    sigma), rows then columns) and the 4-neighbour peak mask run on the device.
  * The decode (``find_peaks``' host half, ``score_limbs``, ``assemble_people``,
    ``hand_detect``, ``decode_hand_peaks``) and the drawing (``draw_bodypose``,
    ``draw_handpose``, ``_draw_line``) are the JAX package's numpy code, copied.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controllora_tpu_torch.annotators.util import build_net, detector_device, gaussian_blur
from controllora_tpu_torch.utils.image import resize_jax

# ---------------------------------------------------------------------------- nets

_VGG_TRUNK = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool",),
    ("conv2_1", 128), ("conv2_2", 128), ("pool",),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool",),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128),
)

_HAND_TRUNK = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool",),
    ("conv2_1", 128), ("conv2_2", 128), ("pool",),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool",),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3_CPM", 128),
)


def _block(cin: int, convs) -> nn.Sequential:
    """Named layers as the reference's ``make_layers`` builds them: each (name, out,
    kernel[, relu]) a same-padded conv, followed by a ReLU unless relu is False;
    ``("pool",)`` a 2x2 max pool."""
    layers = OrderedDict()
    for i, item in enumerate(convs):
        if item[0] == "pool":
            layers[f"pool{i}"] = nn.MaxPool2d(2, 2)
            continue
        name, cout, k, *relu = item
        layers[name] = nn.Conv2d(cin, cout, k, padding=k // 2)
        if not relu or relu[0]:
            layers[f"relu_{name}"] = nn.ReLU()
        cin = cout
    return nn.Sequential(layers)


def _trunk(layout) -> nn.Sequential:
    return _block(3, [item if item[0] == "pool" else (item[0], item[1], 3) for item in layout])


def _cpm_stage(cin: int, out: int, stage: int, suffix: str) -> nn.Sequential:
    """Mconv1-5 7x7 128, Mconv6 1x1 128, Mconv7 1x1 -> out (no ReLU)."""
    return _block(cin, [(f"Mconv{i}_stage{stage}{suffix}", 128, 7) for i in range(1, 6)]
                  + [(f"Mconv6_stage{stage}{suffix}", 128, 1),
                     (f"Mconv7_stage{stage}{suffix}", out, 1, False)])


class BodyposeModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.model0 = _trunk(_VGG_TRUNK)
        for br, out in (("1", 38), ("2", 19)):
            setattr(self, f"model1_{br}", _block(128, [
                *[(f"conv5_{i}_CPM_L{br}", 128, 3) for i in range(1, 4)],
                (f"conv5_4_CPM_L{br}", 512, 1), (f"conv5_5_CPM_L{br}", out, 1, False)]))
            for s in range(2, 7):
                setattr(self, f"model{s}_{br}", _cpm_stage(185, out, s, f"_L{br}"))

    def forward(self, x):
        """(B, 3, H, W) in [-0.5, 0.5] -> (paf (B, 38, H/8, W/8), heat (B, 19, H/8, W/8))."""
        feat = self.model0(x)
        l1, l2 = self.model1_1(feat), self.model1_2(feat)
        for s in range(2, 7):
            cat = torch.cat([l1, l2, feat], 1)
            l1, l2 = getattr(self, f"model{s}_1")(cat), getattr(self, f"model{s}_2")(cat)
        return l1, l2


class HandposeModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.model1_0 = _trunk(_HAND_TRUNK)
        self.model1_1 = _block(128, [("conv6_1_CPM", 512, 1), ("conv6_2_CPM", 22, 1, False)])
        for s in range(2, 7):
            setattr(self, f"model{s}", _cpm_stage(150, 22, s, ""))

    def forward(self, x):
        """(B, 3, H, W) in [-0.5, 0.5] -> (B, 22, H/8, W/8) heatmaps."""
        feat = self.model1_0(x)
        out = self.model1_1(feat)
        for s in range(2, 7):
            out = getattr(self, f"model{s}")(torch.cat([out, feat], 1))
        return out


# ---------------------------------------------------------------------------- decode

# limb sequence and PAF channel pairs (0-indexed; the published CMU convention —
# reference body.py:99-105 uses 1-indexed limbSeq and mapIdx offset by 19)
LIMB_SEQ = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
]
PAF_IDX = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1), (2, 3),
    (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35), (32, 33),
    (36, 37), (18, 19), (26, 27),
]


def _shifted(b: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """b moved one place along ``axis`` (step 1: out[i] = b[i - 1]; -1: b[i + 1]),
    zero where nothing moves in."""
    out = torch.zeros_like(b)
    n = b.shape[axis]
    if step > 0:
        out.narrow(axis, 1, n - 1).copy_(b.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(b.narrow(axis, 1, n - 1))
    return out


def peak_mask(heatmaps: torch.Tensor, thre1: float = 0.1) -> torch.Tensor:
    """(H, W, P) -> boolean (H, W, P): local maxima over the 4 neighbours (zero past
    the border) of the sigma-3 blurred maps, above ``thre1`` (reference
    body.py:77-92), on the maps' device."""
    b = gaussian_blur(heatmaps.permute(2, 0, 1), 3.0, max(1, int(round(4.0 * 3.0))))
    keep = b > thre1
    for axis in (1, 2):
        for step in (1, -1):
            keep &= b >= _shifted(b, axis, step)
    return keep.permute(1, 2, 0)


def find_peaks(heatmaps, thre1: float = 0.1):
    """(H, W, 18) maps (a tensor on any device, or numpy) -> per-part list of (x, y,
    score, global_id); the mask on the maps' device, the list on the host."""
    maps = torch.as_tensor(heatmaps)
    mask = peak_mask(maps, thre1).cpu().numpy()
    heatmaps = maps.cpu().numpy()
    all_peaks = []
    counter = 0
    for part in range(18):
        ys, xs = np.nonzero(mask[:, :, part])
        peaks = [
            (int(x), int(y), float(heatmaps[y, x, part]), counter + i)
            for i, (x, y) in enumerate(zip(xs, ys))
        ]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks, img_h: int, thre2: float = 0.05,
                mid_num: int = 10):
    """PAF line-integral scoring + greedy bipartite matching per limb
    (reference body.py:104-150)."""
    connections = []
    for k, ((pa, pb), (ca, cb)) in enumerate(zip(LIMB_SEQ, PAF_IDX)):
        candA, candB = all_peaks[pa], all_peaks[pb]
        if not candA or not candB:
            connections.append(np.zeros((0, 5)))
            continue
        cands = []
        for i, a in enumerate(candA):
            for j, b in enumerate(candB):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(1e-3, float(np.hypot(*vec)))
                u = vec / norm
                xs = np.round(np.linspace(a[0], b[0], mid_num)).astype(int)
                ys = np.round(np.linspace(a[1], b[1], mid_num)).astype(int)
                px = paf[ys, xs, ca]
                py = paf[ys, xs, cb]
                scores = px * u[0] + py * u[1]
                prior = min(0.5 * img_h / norm - 1, 0)
                total = scores.mean() + prior
                if (scores > thre2).sum() > 0.8 * mid_num and total > 0:
                    cands.append((i, j, total, total + a[2] + b[2]))
        cands.sort(key=lambda c: c[2], reverse=True)
        used_i, used_j = set(), set()
        rows = []
        for i, j, s, _ in cands:
            if i not in used_i and j not in used_j:
                rows.append([candA[i][3], candB[j][3], s, i, j])
                used_i.add(i)
                used_j.add(j)
                if len(rows) >= min(len(candA), len(candB)):
                    break
        connections.append(np.array(rows) if rows else np.zeros((0, 5)))
    return connections


def assemble_people(all_peaks, connections):
    """Greedy subset assembly + merge + prune (reference body.py:155-209).
    Returns (candidate (N,4) [x,y,score,id], subset (P,20))."""
    candidate = np.array(
        [p for part in all_peaks for p in part], np.float64
    ).reshape(-1, 4)
    subset = -np.ones((0, 20))
    for k, (pa, pb) in enumerate(LIMB_SEQ):
        conn = connections[k]
        if len(conn) == 0:
            continue
        for row in conn:
            ida, idb, score = row[0], row[1], row[2]
            hits = []
            for j in range(len(subset)):
                if subset[j][pa] == ida or subset[j][pb] == idb:
                    hits.append(j)
                    if len(hits) == 2:
                        break
            if len(hits) == 1:
                j = hits[0]
                if subset[j][pb] != idb:
                    subset[j][pb] = idb
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(idb), 2] + score
            elif len(hits) == 2:
                j1, j2 = hits
                both = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if not (both == 2).any():
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += score
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][pb] = idb
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(idb), 2] + score
            elif k < 17:
                row20 = -np.ones(20)
                row20[pa] = ida
                row20[pb] = idb
                row20[-1] = 2
                row20[-2] = candidate[int(ida), 2] + candidate[int(idb), 2] + score
                subset = np.vstack([subset, row20])
    keep = [
        i for i in range(len(subset))
        if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4
    ]
    return candidate, subset[keep]


# ---------------------------------------------------------------------------- drawing

_LIMB_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]


def _draw_line(canvas: np.ndarray, p0, p1, color, width: int = 4):
    """Thick anti-alias-free line via dense sampling (cv2.line/ellipse equivalent)."""
    n = max(2, int(np.hypot(p1[0] - p0[0], p1[1] - p0[1])) * 2)
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    h, w = canvas.shape[:2]
    r = width // 2
    for x, y in zip(xs, ys):
        x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
        y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
        canvas[y0:y1, x0:x1] = color


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray, subset: np.ndarray):
    """Skeleton render (reference annotator/openpose/util.py:37-72 behavior)."""
    for limb_i in range(17):
        pa, pb = LIMB_SEQ[limb_i]
        color = _LIMB_COLORS[limb_i % len(_LIMB_COLORS)]
        for person in subset:
            ia, ib = int(person[pa]), int(person[pb])
            if ia < 0 or ib < 0:
                continue
            a, b = candidate[ia], candidate[ib]
            _draw_line(canvas, a[:2], b[:2], color)
    for part in range(18):
        color = _LIMB_COLORS[part % len(_LIMB_COLORS)]
        for person in subset:
            idx = int(person[part])
            if idx < 0:
                continue
            x, y = candidate[idx][:2]
            _draw_line(canvas, (x, y), (x, y), color, width=8)
    return canvas


# ---------------------------------------------------------------------------- hands

_HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8), (0, 9),
    (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15), (15, 16), (0, 17),
    (17, 18), (18, 19), (19, 20),
]


def hand_detect(candidate: np.ndarray, subset: np.ndarray, img_shape) -> List[tuple]:
    """Hand boxes from arm keypoints (reference openpose/util.py:94-157):
    box center = wrist + 0.33·(wrist − elbow), side = 1.5·max(|wrist−elbow|,
    0.9·|elbow−shoulder|). Returns [(x, y, w, is_left)]."""
    H, W = img_shape[:2]
    out = []
    for person in subset.astype(int):
        for (si, ei, wi), is_left in (((5, 6, 7), True), ((2, 3, 4), False)):
            if (person[[si, ei, wi]] < 0).any():
                continue
            x1, y1 = candidate[person[si]][:2]
            x2, y2 = candidate[person[ei]][:2]
            x3, y3 = candidate[person[wi]][:2]
            x = x3 + 0.33 * (x3 - x2)
            y = y3 + 0.33 * (y3 - y2)
            width = 1.5 * max(
                math.hypot(x3 - x2, y3 - y2), 0.9 * math.hypot(x2 - x1, y2 - y1)
            )
            x -= width / 2
            y -= width / 2
            x, y = max(0.0, x), max(0.0, y)
            width = min(width, W - x, H - y)
            if width >= 20:
                out.append((int(x), int(y), int(width), is_left))
    return out


def decode_hand_peaks(heatmaps, thre: float = 0.05) -> np.ndarray:
    """21 keypoints from hand heatmaps (H, W, 22) (a tensor on any device, or numpy)
    — the reference decode (hand.py:59-75): per channel, Gaussian-smooth (sigma 3,
    on the maps' device), threshold into a binary mask, label 8-connected components,
    keep the component with the largest RAW-heatmap mass, and return the raw argmax
    inside it. [0, 0] when nothing clears ``thre``."""
    from scipy import ndimage

    maps = torch.as_tensor(heatmaps)[:, :, :21]
    blurred = gaussian_blur(maps.permute(2, 0, 1), 3.0, 12).permute(1, 2, 0).cpu().numpy()
    heatmaps = maps.cpu().numpy()
    peaks = []
    eight = np.ones((3, 3), np.int32)  # skimage connectivity=2 semantics
    for part in range(21):
        raw = heatmaps[:, :, part]
        binary = blurred[:, :, part] > thre
        if not binary.any():
            peaks.append([0, 0])
            continue
        labels, n = ndimage.label(binary, structure=eight)
        sums = ndimage.sum_labels(raw, labels, index=np.arange(1, n + 1))
        best = int(np.argmax(sums)) + 1
        masked = np.where(labels == best, raw, 0.0)
        y, x = np.unravel_index(np.argmax(masked), masked.shape)
        peaks.append([int(x), int(y)])
    return np.array(peaks)


def draw_handpose(canvas: np.ndarray, all_hand_peaks) -> np.ndarray:
    """Hand skeleton render (reference openpose/util.py draw_handpose)."""
    for peaks in all_hand_peaks:
        for i, (e0, e1) in enumerate(_HAND_EDGES):
            p0, p1 = peaks[e0], peaks[e1]
            if (p0 == 0).all() or (p1 == 0).all():
                continue
            hue = int(i / len(_HAND_EDGES) * 255)
            _draw_line(canvas, p0, p1, (hue, 255 - hue, 128), width=2)
        for p in peaks:
            if not (p == 0).all():
                _draw_line(canvas, p, p, (0, 0, 255), width=4)
    return canvas


# ---------------------------------------------------------------------------- detector


def _scaled_maps(net, img: np.ndarray, device, boxsize: int, stride: int, scale_search):
    """The JAX scale loop: per scale, ``img`` (H, W, 3) resized by jax's cubic rule
    to s * boxsize rows, padded bottom/right to the stride with 128, / 256 - 0.5,
    through ``net``, each of its maps (the padded grid) resized back to (H, W) by the
    same rule; the mean over the scales, a list of (H, W, C) maps on ``device``."""
    H, W = img.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).float()
    acc = None
    for s in scale_search:
        scale = s * boxsize / H
        h = max(stride, int(round(H * scale)))
        w = max(stride, int(round(W * scale)))
        small = resize_jax(x, h, w, "bicubic")
        padded = F.pad(small.permute(2, 0, 1), (0, (stride - w % stride) % stride,
                                                0, (stride - h % stride) % stride), value=128.0)
        with torch.no_grad():
            outs = net(padded[None] / 256.0 - 0.5)
        outs = outs if isinstance(outs, tuple) else (outs,)
        maps = [resize_jax(o[0], H, W, "bicubic", dims=(-2, -1)) / len(scale_search)
                for o in outs]
        acc = maps if acc is None else [a + m for a, m in zip(acc, maps)]
    return [a.permute(1, 2, 0) for a in acc]


class OpenposeDetector:
    """``__call__(uint8 HWC image, hand=False)`` -> (canvas uint8 HWC, pose dict), as
    the reference (annotator/openpose/__init__.py:93-121). ``body_sd`` / ``hand_sd``
    are state dicts in the CMU checkpoints' key names (``from_pretrained`` reads the
    files); without ``body_sd`` the body net holds ``seeded_state_dict``'s fill,
    without ``hand_sd`` there is no hand net and ``hand=True`` draws no hands, as in
    the JAX detector."""

    def __init__(self, body_sd: Optional[Dict] = None, hand_sd: Optional[Dict] = None,
                 device="cuda"):
        self.device = detector_device(device)
        self.body_model = build_net(BodyposeModel, body_sd, self.device)
        self.hand_model = None if hand_sd is None else build_net(HandposeModel, hand_sd,
                                                                 self.device)

    @classmethod
    def from_pretrained(cls, body_path: str, hand_path: Optional[str] = None,
                        device="cuda") -> "OpenposeDetector":
        from controllora_tpu_torch.utils.convert import annotator_file_state_dict

        return cls(annotator_file_state_dict("openpose", body_path, device),
                   None if hand_path is None
                   else annotator_file_state_dict("openpose_hand", hand_path, device),
                   device)

    def infer_maps(self, ori_img: np.ndarray, boxsize: int = 368, stride: int = 8,
                   scale_search=(0.5,)):
        """(paf (H, W, 38), heat (H, W, 19)) fp32 on the device, averaged over
        ``scale_search`` (the reference's effective single scale 0.5 by default;
        (0.5, 1.0, 1.5, 2.0) is its commented full sweep)."""
        return tuple(_scaled_maps(self.body_model, ori_img, self.device, boxsize, stride,
                                  scale_search))

    def infer_hand(self, crop: np.ndarray, boxsize: int = 368, stride: int = 8,
                   scale_search=(0.5, 1.0, 1.5, 2.0)):
        """(H, W, 22) hand heatmaps of a square crop on the device, averaged over the
        reference's four scales (hand.py:26-58)."""
        assert self.hand_model is not None
        return _scaled_maps(self.hand_model, crop, self.device, boxsize, stride,
                            scale_search)[0]

    def __call__(self, ori_img: np.ndarray, hand: bool = False, scale_search=(0.5,)):
        paf, heat = self.infer_maps(ori_img, scale_search=scale_search)
        peaks = find_peaks(heat[:, :, :18])
        conns = score_limbs(paf.cpu().numpy(), peaks, ori_img.shape[0])
        candidate, subset = assemble_people(peaks, conns)
        canvas = np.zeros_like(ori_img)
        draw_bodypose(canvas, candidate, subset)
        pose = {
            "bodies": {"candidate": candidate.tolist(), "subset": subset.tolist()},
        }
        if hand and self.hand_model is not None:
            all_hand_peaks = []
            for x, y, w, is_left in hand_detect(candidate, subset, ori_img.shape):
                crop = ori_img[y : y + w, x : x + w]
                if not is_left:
                    crop = crop[:, ::-1]
                pk = decode_hand_peaks(self.infer_hand(np.ascontiguousarray(crop)))
                if not is_left:
                    pk[:, 0] = np.where(pk.sum(1) > 0, w - 1 - pk[:, 0], 0)
                pk = np.where(pk > 0, pk + np.array([x, y]), 0)
                all_hand_peaks.append(pk)
            draw_handpose(canvas, all_hand_peaks)
            pose["hands"] = [p.tolist() for p in all_hand_peaks]
        return canvas, pose
