"""The port's MiDaS (DPT-hybrid) and UniFormer annotators, and the annotator weight
maps of ``utils/convert.py``, against the JAX package's.

One seeded numpy state dict per net in the reference checkpoint's key names
(``seeded_state_dict``) feeds both sides. MiDaS: the numpy dict holds the raw
(unstandardised) StdConv kernels, as the dpt_hybrid file does; the JAX params come
from ``midas_params_from_torch``, which standardises each StdConv kernel once into
the flax tree, and the port loads the raw kernels and standardises once at forward
time. The He fill's filters are far from unit variance, so a side that skipped the
standardisation would fail the comparison. UniFormer: ``uniformer_params_from_torch``.
On the CPU at 64x96:

  * raw net outputs (depth, class logits): relative L2 <= 1e-4, max|d| <= 1e-3 *
    max|ref|;
  * MiDaS's depth and normal uint8 maps equal wherever the JAX float lies further
    than the floats' difference from a level boundary (within one level there);
  * UniFormer's labels and colour map equal, the pooling equal to the JAX
    ``_adaptive_avg_pool``, the palette equal;
  * ``annotator_state_dict`` of each JAX tree (from the numpy dict) gives back the
    numpy dict's keys, shapes and dtypes, bit for bit except MiDaS's standardised
    convs; ``load_annotator`` and the detectors' ``from_pretrained`` read reference
    files: CMU's flat keys, HED's ``module`` prefix, mmseg's nested ``state_dict``
    and the unused keys the JAX importers skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.annotators import hed as jh
from controllora_tpu.annotators import midas as jd
from controllora_tpu.annotators import mlsd as jm
from controllora_tpu.annotators import openpose as jo
from controllora_tpu.annotators import uniformer as ju
from controllora_tpu_torch.annotators import midas as pd
from controllora_tpu_torch.annotators import uniformer as pu
from controllora_tpu_torch.utils import convert
from test_torch_hed_mlsd import assert_truncated_equal
from test_torch_openpose import assert_close, image, numpy_state_dict

IMPORTERS = {"openpose": jo.openpose_params_from_torch,
             "openpose_hand": lambda sd: jo.openpose_params_from_torch(sd, hand=True),
             "hed": jh.hed_params_from_torch, "mlsd": jm.mlsd_params_from_torch,
             "midas": jd.midas_params_from_torch, "uniformer": ju.uniformer_params_from_torch}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def midas():
    sd = numpy_state_dict(pd.DPTHybridDepth)
    params = jd.midas_params_from_torch(sd)
    return pd.MidasDetector(sd, device="cpu"), jd.MidasDetector(params), params


def test_midas_state_dict_strict_names(midas):
    ours, _, _ = midas
    keys = list(ours.model.state_dict())
    for key in ("pretrained.model.patch_embed.backbone.stem.conv.weight",
                "pretrained.model.patch_embed.backbone.stages.2.blocks.8.conv3.weight",
                "pretrained.model.patch_embed.backbone.stages.1.blocks.0.downsample.norm.bias",
                "pretrained.model.cls_token", "pretrained.model.pos_embed",
                "pretrained.model.blocks.11.attn.qkv.weight",
                "pretrained.act_postprocess3.0.project.0.weight",
                "pretrained.act_postprocess4.4.weight", "scratch.layer4_rn.weight",
                "scratch.refinenet4.resConfUnit1.conv1.weight", "scratch.output_conv.4.bias"):
        assert key in keys, key
    w = numpy_state_dict(pd.DPTHybridDepth)["pretrained.model.patch_embed.backbone.stem.conv.weight"]
    assert abs(float(w.std()) - 1.0) > 0.5  # raw, unstandardised kernels


def test_midas_depth_matches_jax(midas):
    ours, ref_det, params = midas
    x = np.random.default_rng(1).uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(ref_det._jit(params, jnp.asarray(x)))  # the detector's own program
    with torch.no_grad():
        out = ours.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.shape == (1, 96, 96) and float(out.min()) >= 0
    assert_close(out.numpy(), ref)


def test_midas_detector_matches_jax(midas):
    ours, ref, _ = midas
    img = image((80, 96, 3), 2)
    depth, normal = ours(img)
    jdepth, jnormal = ref(img)
    assert depth.shape == (80, 96) and normal.shape == (80, 96, 3) and depth.dtype == np.uint8
    d, jdep = ours.depth(img), ref._jit(ref.params, jax.image.resize(
        jnp.asarray(img, jnp.float32) / 127.5 - 1.0, (96, 96, 3), "linear")[None])[0]
    jdep = jax.image.resize(jdep, (80, 96), "linear")
    assert_close(d.numpy(), np.asarray(jdep))
    norm01, n = pd.depth_to_normal(d)
    jnorm01, jn = jd.depth_to_normal(jdep)
    assert_close(n.numpy(), np.asarray(jn))
    assert_truncated_equal(depth, np.clip(norm01.numpy() * 255, 0, 255),
                           np.clip(np.asarray(jnorm01) * 255, 0, 255))
    assert_truncated_equal(normal, np.clip(n.numpy() * 127.5 + 127.5, 0, 255),
                           np.clip(np.asarray(jn) * 127.5 + 127.5, 0, 255))
    np.testing.assert_array_equal(jdepth, np.clip(np.asarray(jnorm01) * 255, 0, 255).astype(np.uint8))


def test_depth_to_normal_matches_jax():
    yy = np.linspace(0, 1, 32, dtype=np.float32)[:, None] * np.linspace(1, 2, 40, dtype=np.float32)
    yy = yy + 0.1 * np.sin(np.arange(40, dtype=np.float32) / 3)
    for bg in (0.0, 0.1, 0.5):
        norm01, n = pd.depth_to_normal(torch.from_numpy(yy), 2 * np.pi, bg)
        jnorm01, jn = jd.depth_to_normal(jnp.asarray(yy), 2 * np.pi, bg)
        np.testing.assert_allclose(norm01.numpy(), np.asarray(jnorm01), atol=1e-6)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(n.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def uniformer():
    sd = numpy_state_dict(pu.UniFormerSeg)
    params = ju.uniformer_params_from_torch(sd)
    return pu.UniformerDetector(sd, device="cpu"), ju.UniformerDetector(params), params


def test_uniformer_logits_and_map_match_jax(uniformer):
    ours, ref, params = uniformer
    x = np.random.default_rng(1).uniform(-2, 2, (1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ju.UniFormerSeg().apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = ours.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (1, 64, 96, 150)
    assert_close(out.numpy(), want)
    img = image((80, 90, 3), 3)
    labels = ours.labels(img).numpy()
    assert labels.shape == (80, 90) and len(np.unique(labels)) > 3
    colours = ours(img)
    assert colours.dtype == np.uint8
    np.testing.assert_array_equal(colours, ref(img))
    np.testing.assert_array_equal(colours, ours.palette[labels])


def test_uniformer_state_dict_names_and_pool():
    sd = numpy_state_dict(pu.UniFormerSeg)
    assert sd["backbone.blocks1.0.attn.weight"].shape == (64, 1, 5, 5)
    assert sd["backbone.blocks3.0.attn.qkv.weight"].shape == (960, 320)
    assert sd["decode_head.psp_modules.3.1.conv.weight"].shape == (512, 512, 1, 1)
    assert sd["decode_head.fpn_bottleneck.conv.weight"].shape == (512, 2048, 3, 3)
    assert pu.ade_palette() == ju.ade_palette()
    x = np.random.default_rng(0).normal(size=(1, 5, 7, 3)).astype(np.float32)
    for s in (1, 2, 3, 6):
        ref = np.asarray(ju._adaptive_avg_pool(jnp.asarray(x), s))
        ours = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), s)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("kind", convert.ANNOTATOR_KINDS)
def test_annotator_state_dict_round_trip(kind):
    sd = numpy_state_dict(convert._annotator_nets()[kind], seed=3)
    back = convert.annotator_state_dict(kind, IMPORTERS[kind](sd))
    assert list(back) == list(sd)
    standardised = []
    for k, v in sd.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        if not np.array_equal(back[k], v):
            standardised.append(k)
    if kind == "midas":
        assert len(standardised) == 52  # the stem, 16 blocks x 3 and 3 downsample convs
        with torch.device("meta"):
            net = pd.DPTHybridDepth()
        for k in standardised:
            assert isinstance(net.get_submodule(k.rsplit(".", 1)[0]), pd.StdConv2d), k
            w = back[k].reshape(back[k].shape[0], -1)
            np.testing.assert_allclose(w.mean(1), 0, atol=1e-5)
            np.testing.assert_allclose(w.std(1), 1, atol=1e-4)
    else:
        assert not standardised


def test_load_annotator_reads_reference_files(tmp_path):
    body = numpy_state_dict(convert._annotator_nets()["openpose"])
    flat = {k.split(".", 1)[1]: torch.from_numpy(v) for k, v in body.items()}  # CMU file
    torch.save(flat, tmp_path / "body_pose_model.pth")
    net = convert.load_annotator("openpose", str(tmp_path / "body_pose_model.pth"), "cpu")
    assert not net.training
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), body[k])

    hed = numpy_state_dict(convert._annotator_nets()["hed"])
    torch.save({k.replace("net", "module"): torch.from_numpy(v) for k, v in hed.items()},
               tmp_path / "network-bsds500.pth")
    from controllora_tpu_torch.annotators import HEDdetector, UniformerDetector

    det = HEDdetector.from_pretrained(str(tmp_path / "network-bsds500.pth"), device="cpu")
    np.testing.assert_array_equal(det.net.netCombine[0].weight.numpy(), hed["netCombine.0.weight"])

    uni = {k: torch.from_numpy(v) for k, v in numpy_state_dict(pu.UniFormerSeg).items()}
    aux = dict(uni, **{"auxiliary_head.conv_seg.weight": torch.zeros(150, 256, 1, 1)})
    torch.save({"meta": {}, "state_dict": aux}, tmp_path / "upernet_global_small.pth")
    det = UniformerDetector.from_pretrained(str(tmp_path / "upernet_global_small.pth"), "cpu")
    assert torch.equal(det.model.decode_head.conv_seg.weight, uni["decode_head.conv_seg.weight"])

    # the ViT's final norm and classifier, which the nets have no place for, go; any
    # other stray key fails the strict load
    mid = {"scratch.layer1_rn.weight": torch.ones(256, 256, 3, 3),
           "pretrained.model.norm.weight": torch.ones(768),
           "pretrained.model.head.bias": torch.ones(1000)}
    torch.save(mid, tmp_path / "dpt_hybrid-midas-501f0c75.pt")
    assert list(convert.annotator_file_state_dict(
        "midas", str(tmp_path / "dpt_hybrid-midas-501f0c75.pt"))) == ["scratch.layer1_rn.weight"]
    named = {k: torch.from_numpy(v) for k, v in body.items()}
    torch.save(dict(named, **{"model0.extra.weight": torch.ones(1)}), tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        convert.load_annotator("openpose", str(tmp_path / "bad.pth"), "cpu")
