"""The port's OpenPose annotator and the resizes it needs, against the JAX package's.

One numpy state dict per net in the CMU checkpoints' key names
(``annotators/util.py::seeded_state_dict``: He-scaled, so six CPM stages keep their
scale) feeds both sides: the JAX package through ``openpose_params_from_torch`` (no
flax init), the port through ``load_state_dict(strict=True)``. On the CPU, at small
images (the body net runs at 0.5 * 368 rows whatever the image's height):

  * ``resize_jax``'s cubic and bilinear modes against ``jax.image.resize`` (relative
    max error <= 1e-4, up and down, antialiased when shrinking), its nearest mode
    exactly, and ``resize_align_corners`` against the JAX ``_resize_align_corners``;
  * the raw PAF and heatmaps of ``infer_maps`` and the hand net's ``infer_hand`` (at
    a 64-row box, four scales): relative L2 <= 1e-4 and max|d| <= 1e-3 * max|ref|;
  * the decode on those maps: peak positions and ids, limb pairs, people and the
    skeleton canvas equal; scores within 1e-4 (they are the maps' floats);
  * the decode on the JAX tests' synthetic two-person scene, whole and exact;
  * ``decode_hand_peaks`` equal on the port's and JAX's hand maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.annotators import openpose as jo
from controllora_tpu.annotators.mlsd import _resize_align_corners
from controllora_tpu_torch.annotators import openpose as po
from controllora_tpu_torch.annotators.util import seeded_state_dict
from controllora_tpu_torch.utils.image import resize_align_corners, resize_jax
from test_openpose import synth_scene, two_person_scene

REL_L2, REL_MAX = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_state_dict(make, seed=0):
    """The seeded numpy state dict of the port's net ``make`` in checkpoint naming."""
    with torch.device("meta"):
        return seeded_state_dict(make(), seed)


def assert_close(out, ref, rel_l2=REL_L2, rel_max=REL_MAX):
    """Relative L2 error and max error relative to max|ref| within bounds."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    d = out - ref
    assert np.linalg.norm(d) <= rel_l2 * np.linalg.norm(ref), np.linalg.norm(d) / np.linalg.norm(ref)
    assert np.abs(d).max() <= rel_max * np.abs(ref).max(), np.abs(d).max() / np.abs(ref).max()


def image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def detectors():
    body = numpy_state_dict(po.BodyposeModel, 0)
    hand = numpy_state_dict(po.HandposeModel, 1)
    ours = po.OpenposeDetector(body, hand, device="cpu")
    ref = jo.OpenposeDetector(jo.openpose_params_from_torch(body),
                              jo.openpose_params_from_torch(hand, hand=True))
    return ours, ref


@pytest.mark.parametrize("method", ["cubic", "bicubic", "linear", "bilinear", "nearest"])
@pytest.mark.parametrize("src,dst", [((23, 17), (184, 136)), ((64, 48), (8, 6)),
                                     ((30, 30), (17, 45)), ((96, 128), (96, 40))])
def test_resize_jax_modes(method, src, dst):
    x = np.random.default_rng(sum(src)).normal(size=(*src, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (*dst, 5), method))
    ours = resize_jax(torch.from_numpy(x), *dst, method)
    if method == "nearest":
        np.testing.assert_array_equal(ours.numpy(), ref)
    else:
        assert np.abs(ours.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    nchw = resize_jax(torch.from_numpy(x).permute(2, 0, 1), *dst, method, dims=(-2, -1))
    np.testing.assert_array_equal(nchw.permute(1, 2, 0).numpy(), ours.numpy())


def test_resize_nearest_integer_labels():
    labels = np.random.default_rng(0).integers(0, 150, (24, 40))
    ref = np.asarray(jax.image.resize(jnp.asarray(labels, jnp.float32), (61, 97), "nearest"))
    ours = resize_jax(torch.from_numpy(labels), 61, 97, "nearest")
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("hw,out", [((6, 7), (12, 14)), ((16, 16), (32, 32)), ((1, 5), (2, 10))])
def test_resize_align_corners(hw, out):
    x = np.random.default_rng(hw[0]).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(_resize_align_corners(jnp.asarray(x), out))
    ours = resize_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), *out)
    assert np.abs(ours.permute(0, 2, 3, 1).numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_state_dicts_load_strict_in_cmu_naming():
    for make, n, first, last in (
            (po.BodyposeModel, 184, "model0.conv1_1.weight", "model6_2.Mconv7_stage6_L2.bias"),
            (po.HandposeModel, 104, "model1_0.conv1_1.weight", "model6.Mconv7_stage6.bias")):
        sd = numpy_state_dict(make)
        keys = list(sd)
        assert len(keys) == n and keys[0] == first and keys[-1] == last
        net = make()
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        with pytest.raises(RuntimeError, match="Missing key"):
            make().load_state_dict({k: torch.from_numpy(v) for k, v in list(sd.items())[1:]})
    assert "model1_1.conv5_5_CPM_L1.weight" in numpy_state_dict(po.BodyposeModel)
    assert numpy_state_dict(po.BodyposeModel)["model2_1.Mconv1_stage2_L1.weight"].shape == (
        128, 185, 7, 7)


def test_detector_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        po.OpenposeDetector()


@pytest.mark.parametrize("shape", [(96, 128, 3), (64, 64, 3)])
def test_body_maps_and_decode_match_jax(detectors, shape):
    ours, ref = detectors
    img = image(shape, shape[1])
    paf, heat = ours.infer_maps(img)
    jpaf, jheat = ref.infer_maps(img)
    assert paf.shape == (*shape[:2], 38) and heat.shape == (*shape[:2], 19)
    assert_close(paf, jpaf)
    assert_close(heat, jheat)

    peaks, jpeaks = po.find_peaks(heat[:, :, :18]), jo.find_peaks(jheat[:, :, :18])
    assert sum(map(len, peaks)) > 20  # the He fill keeps the maps above threshold
    assert [[p[:2] + p[3:] for p in part] for part in peaks] == \
        [[p[:2] + p[3:] for p in part] for part in jpeaks]
    for part, jpart in zip(peaks, jpeaks):
        np.testing.assert_allclose([p[2] for p in part], [p[2] for p in jpart], rtol=1e-4,
                                   atol=1e-4)
    conns = po.score_limbs(paf.numpy(), peaks, shape[0])
    jconns = jo.score_limbs(jpaf, jpeaks, shape[0])
    for c, jc in zip(conns, jconns):
        np.testing.assert_array_equal(c[:, [0, 1, 3, 4]], jc[:, [0, 1, 3, 4]])
        np.testing.assert_allclose(c[:, 2], jc[:, 2], rtol=1e-4, atol=1e-4)
    canvas, pose = ours(img)
    jcanvas, jpose = ref(img)
    np.testing.assert_array_equal(canvas, jcanvas)
    subset, jsubset = np.array(pose["bodies"]["subset"]), np.array(jpose["bodies"]["subset"])
    np.testing.assert_array_equal(subset[:, :18], jsubset[:, :18])
    np.testing.assert_array_equal(subset[:, -1], jsubset[:, -1])
    np.testing.assert_allclose(subset[:, -2], jsubset[:, -2], rtol=1e-4)
    np.testing.assert_allclose(pose["bodies"]["candidate"], jpose["bodies"]["candidate"],
                               rtol=1e-4, atol=1e-4)


def test_decode_synthetic_scene_exact():
    """The JAX tests' two-person scene through both decodes: every peak, limb,
    person and pixel of the skeleton equal."""
    heat, paf = synth_scene(two_person_scene())
    peaks, jpeaks = po.find_peaks(heat[:, :, :18]), jo.find_peaks(heat[:, :, :18])
    assert peaks == jpeaks and sum(map(len, peaks)) >= 12
    conns = po.score_limbs(paf, peaks, 96)
    for c, jc in zip(conns, jo.score_limbs(paf, jpeaks, 96)):
        np.testing.assert_array_equal(c, jc)
    candidate, subset = po.assemble_people(peaks, conns)
    jcandidate, jsubset = jo.assemble_people(jpeaks, conns)
    assert len(subset) == 2
    np.testing.assert_array_equal(candidate, jcandidate)
    np.testing.assert_array_equal(subset, jsubset)
    canvas = po.draw_bodypose(np.zeros((96, 96, 3), np.uint8), candidate, subset)
    jcanvas = jo.draw_bodypose(np.zeros((96, 96, 3), np.uint8), candidate, subset)
    assert canvas.any()
    np.testing.assert_array_equal(canvas, jcanvas)


def test_hand_maps_and_peaks_match_jax(detectors):
    ours, ref = detectors
    crop = image((48, 48, 3), 5)
    hm = ours.infer_hand(crop, boxsize=64)
    jhm = ref.infer_hand(crop, boxsize=64)
    assert hm.shape == (48, 48, 22)
    assert_close(hm, jhm)
    peaks, jpeaks = po.decode_hand_peaks(hm), jo.decode_hand_peaks(jhm)
    assert (peaks != 0).any()
    np.testing.assert_array_equal(peaks, jpeaks)
    canvas = po.draw_handpose(np.zeros((48, 48, 3), np.uint8), [peaks])
    np.testing.assert_array_equal(canvas, jo.draw_handpose(np.zeros((48, 48, 3), np.uint8),
                                                           [jpeaks]))


def test_hand_boxes_match_jax():
    heat, paf = synth_scene([{1: (40, 20), 2: (30, 22), 3: (24, 40), 4: (20, 60), 5: (50, 22),
                              6: (58, 40), 7: (64, 60), 8: (34, 70), 11: (46, 70)}])
    peaks = po.find_peaks(heat[:, :, :18])
    candidate, subset = po.assemble_people(peaks, po.score_limbs(paf, peaks, 96))
    for shape in ((96, 96), (70, 96), (96, 66)):
        assert po.hand_detect(candidate, subset, shape) == jo.hand_detect(candidate, subset, shape)
