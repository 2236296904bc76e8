"""The port's annotators on the card against the same detectors on the CPU.

These need an NVIDIA GPU; elsewhere they skip. On the card:
    python -m pytest tests/test_torch_annotators_gpu.py --noconftest -m gpu -q
Each detector is built twice from one seeded state dict (``seeded_state_dict``), on
the card and on the CPU, fp32 with TF32 off. At 128² the raw maps agree within
max|d| <= 1e-3 * max|ref|. What is decoded from them agrees but at near-ties, the
checks of ``chip_smoke.py``'s phase "annotators": OpenPose's peaks differ only where
a blurred value ties a neighbour or the threshold within twice the blurs'
difference (``peak_diff``); uint8 maps only at pixels whose CPU float lies within
the floats' difference of a level boundary, by one level (``truncation_diff``);
MLSD's centres from one map only in the order of scores that tie within 1e-6 (the
sigmoid of a large logit is 1.0 on one device and 1 - 2^-24 on the other);
UniFormer's labels only where the top two logits tie within twice the logits'
difference.
"""

import numpy as np
import pytest
import torch

from chip_smoke import peak_diff, truncation_diff
from controllora_tpu_torch.annotators import hed, midas, mlsd, openpose, uniformer
from controllora_tpu_torch.annotators.util import seeded_state_dict

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def pair(cls, net_cls, seed=0):
    with torch.device("meta"):
        sd = seeded_state_dict(net_cls(), seed)
    return cls(sd, device="cuda"), cls(sd, device="cpu")


def image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def close(card, cpu, rel=1e-3):
    card, cpu = card.double().cpu(), cpu.double()
    assert float((card - cpu).abs().max()) <= rel * float(cpu.abs().max())


def test_openpose_card_equals_cpu(cuda):
    card, cpu = pair(openpose.OpenposeDetector, openpose.BodyposeModel)
    img = image((128, 128, 3), 0)
    (paf, heat), (cpaf, cheat) = card.infer_maps(img), cpu.infer_maps(img)
    assert paf.is_cuda
    close(paf, cpaf)
    close(heat, cheat)
    if peak_diff(torch, heat, cheat) == 0:
        np.testing.assert_array_equal(card(img)[0], cpu(img)[0])


def test_hed_card_equals_cpu(cuda):
    card, cpu = pair(hed.HEDdetector, hed.HEDNetwork)
    img = image((128, 128, 3), 1)
    edge, cedge = card.edge(img), cpu.edge(img)
    close(edge, cedge)
    truncation_diff("hed", card(img), (edge * 255).clamp(0, 255), (cedge * 255).clamp(0, 255))
    x = torch.from_numpy(cpu(img).astype(np.float32))
    smooth = torch.linspace(0, 255, 128 * 128).reshape(128, 128) + 20 * torch.sin(x / 40)
    assert torch.equal(hed.hed_nms(smooth.to(cuda), 100, 2.0).cpu(), hed.hed_nms(smooth, 100, 2.0))


def test_mlsd_card_equals_cpu(cuda):
    card, cpu = pair(mlsd.MLSDdetector, mlsd.MobileV2MLSDLarge)
    img = image((128, 128, 3), 2)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 4, 128, 128)).astype(np.float32))
    with torch.no_grad():
        tp, ctp = card.model(x.to(cuda)), cpu.model(x)
    close(tp, ctp)
    (sa, ya, xa), (sb, yb, xb) = ([t.cpu() for t in mlsd.decode_centers(m)[:3]]
                                  for m in (ctp.to(cuda), ctp))
    torch.testing.assert_close(sa, sb, rtol=0, atol=1e-6)
    cut = float(sb[-1]) + 1e-6  # centres clear of the 200th score's ties
    assert ({(int(y), int(x)) for s, y, x in zip(sa, ya, xa) if s > cut}
            == {(int(y), int(x)) for s, y, x in zip(sb, yb, xb) if s > cut})
    lines = mlsd.pred_lines(img, card.model, (128, 128))
    clines = mlsd.pred_lines(img, cpu.model, (128, 128))
    assert lines.shape == clines.shape
    np.testing.assert_allclose(lines, clines, atol=1e-2)


def test_midas_card_equals_cpu(cuda):
    card, cpu = pair(midas.MidasDetector, midas.DPTHybridDepth)
    img = image((128, 128, 3), 4)
    d, cd = card.depth(img), cpu.depth(img)
    close(d, cd)
    (n01, n), (cn01, cn) = midas.depth_to_normal(d), midas.depth_to_normal(cd)
    depth, normal = card(img)
    truncation_diff("midas depth", depth, (n01 * 255).clamp(0, 255), (cn01 * 255).clamp(0, 255))
    truncation_diff("midas normal", normal, (n * 127.5 + 127.5).clamp(0, 255),
                    (cn * 127.5 + 127.5).clamp(0, 255))


def test_uniformer_card_equals_cpu(cuda):
    card, cpu = pair(uniformer.UniformerDetector, uniformer.UniFormerSeg)
    img = image((128, 128, 3), 5)
    logits, clogits = card.logits(img), cpu.logits(img)
    close(logits, clogits)
    top2 = clogits.topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > 2 * float((logits.cpu() - clogits).abs().max())
    assert torch.equal(card.labels(img).cpu()[clear], cpu.labels(img)[clear])
