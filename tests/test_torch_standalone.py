"""The port stands alone: no module of ``controllora_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package, jax, flax or optax (nor PIL, which the
card's machine lacks). The numpy modules the
port keeps its own copies of (config, tokenizer, dataset registry and fill50k,
batch_iterator, the state-dict key maps) give what the JAX package's originals give.
All comparisons here are exact.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from controllora_tpu import config as jconfig
from controllora_tpu.data import registry as jregistry
from controllora_tpu.data import tokenizer as jtokenizer
from controllora_tpu.data.fill50k import Fill50kSynthetic as JFill50k
from controllora_tpu.utils import torch_compat
from controllora_tpu_torch import config
from controllora_tpu_torch.data import registry, tokenizer
from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import derive_cross_attention_dims
from controllora_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("controllora_tpu", "jax", "flax", "optax", "PIL")

IMPORT_EVERY_MODULE = """
import importlib, pkgutil, sys
BANNED = {banned!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)
        return None

assert not [m for m in sys.modules if m.split(".")[0] in BANNED]
sys.meta_path.insert(0, Refuse())
import controllora_tpu_torch
names = [m.name for m in pkgutil.walk_packages(controllora_tpu_torch.__path__,
                                               "controllora_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), "modules")
print(" ".join(names))
"""


def test_port_imports_nothing_of_jax():
    """Every module of the port imports in a fresh interpreter whose import hook
    refuses controllora_tpu, jax, flax and optax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", IMPORT_EVERY_MODULE.format(banned=BANNED)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, names = proc.stdout.splitlines()[:2]
    assert int(count.split()[0]) >= 30, proc.stdout
    for module in ("ops.tome", "serve", "utils.png", "schedulers.ddim", "schedulers.pndm",
                   "schedulers.euler", "schedulers.unipc", "train_dreambooth",
                   "training.dreambooth", "data.fastloader", "data.hf_dataset",
                   "utils.logging", "sample", "mix_lora", "pipelines.hires", "utils.image",
                   "annotators.canny", "annotators.util", "apps.canny2image", "apps.webui",
                   "tasks", "convert_checkpoint", "data.process_datasets",
                   "annotators.openpose", "annotators.hed", "annotators.mlsd",
                   "annotators.midas", "annotators.uniformer", "apps.pose2image",
                   "parallel", "parallel.distributed", "parallel.mesh", "parallel.tp",
                   "eval_presets", "make_dataset"):
        assert f"controllora_tpu_torch.{module}" in names.split(), module


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "controllora_tpu_torch.ops" in names  # it does import the port
    bad = [n for n in names if n.split(".")[0] in BANNED]
    assert not bad, bad


def test_config_presets_equal(tmp_path):
    assert config.preset_names() == jconfig.preset_names()
    for name in config.preset_names():
        assert config.get_preset(name).to_dict() == jconfig.get_preset(name).to_dict(), name
    path = str(tmp_path / "c.json")
    config.get_preset("danbooru-sketch").save_json(path)
    assert jconfig.load_config(path).to_dict() == config.load_config(path).to_dict()


def test_tokenizer_ids_equal(tmp_path):
    texts = ["red circle with blue background", "  A photo,  of a CAT! 123 ",
             "ünïcode wörds and 'quotes'", ""]
    np.testing.assert_array_equal(tokenizer.HashTokenizer()(texts),
                                  jtokenizer.HashTokenizer()(texts))
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\nr e\nc i\nre d</w>\nci r\ncir c\ncirc le</w>\n")
    ours = tokenizer.CLIPBPETokenizer.from_files(None, str(merges))
    ref = jtokenizer.CLIPBPETokenizer.from_files(None, str(merges))
    np.testing.assert_array_equal(ours(texts[:2]), ref(texts[:2]))
    np.testing.assert_array_equal(ours(texts[:2], pad_id=0), ref(texts[:2], pad_id=0))


def test_registry_and_fill50k_items_equal():
    assert sorted(registry.DatasetBase._registry) == sorted(jregistry.DatasetBase._registry)
    ours = registry.DatasetBase.from_name("process/fill50k")(tokenizer.HashTokenizer(),
                                                             resolution=64)
    ref = JFill50k(jtokenizer.HashTokenizer(), resolution=64)
    assert len(ours) == len(ref)
    for idx in (0, 7, 49_999):
        a, b = ours[idx], ref[idx]
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_iterator_equal_with_start_step():
    """Batches of the shuffled stream, fast-forwarded by start_step, and of a dataset
    smaller than one batch (the cycling branch)."""
    for size, batch, start in ((10, 3, 2), (2, 3, 1)):
        ours = registry.batch_iterator(Fill50kSynthetic(tokenizer.HashTokenizer(), 16, size),
                                       batch, seed=5, start_step=start)
        ref = jregistry.batch_iterator(JFill50k(jtokenizer.HashTokenizer(), 16, size),
                                       batch, seed=5, start_step=start)
        for _ in range(4):
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_key_maps_equal():
    """The port's state dicts of the smoke stack and a ControlLoRA, turned into flax
    trees by the JAX importers, come back through the port's copied exporters exactly
    as through the JAX package's originals, and as they went in."""
    gen = torch.Generator().manual_seed(0)
    unet, vae, text = zoo.build_models("smoke", torch.float32, "cpu", gen)
    cfg = config.ControlLoRAConfig(
        block_out_channels=(8, 16, 16, 32), lora_block_in_channels=(32, 32, 32, 32),
        lora_block_out_channels=unet.config.block_out_channels,
        lora_cross_attention_dims=derive_cross_attention_dims(unet.config))
    control = zoo.build_control_lora(cfg, "cpu", gen)
    cases = (
        (unet, torch_compat.translate_unet, convert.flax_to_torch_unet,
         torch_compat.flax_to_torch_unet),
        (vae, torch_compat.translate_vae, convert.flax_to_torch_vae,
         torch_compat.flax_to_torch_vae),
        (text, torch_compat.translate_clip_text, convert.flax_to_torch_clip,
         torch_compat.flax_to_torch_clip),
        (control, lambda sd: torch_compat.control_lora_from_torch(sd, cfg),
         lambda t: convert.control_lora_to_torch(t, cfg),
         lambda t: torch_compat.control_lora_to_torch(t, cfg)),
    )
    for module, to_flax, ours, ref in cases:
        sd = _numpy_sd(module)
        tree = to_flax(sd)
        a, b = ours(tree), ref(tree)
        assert set(a) == set(b) == set(sd), type(module).__name__
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], sd[k])


def test_canny_data_and_launcher_copies_equal():
    """The copies of this slice: the procedural image of process/diffusiondb_canny,
    the Canny detector's sector constants, ``HWC3``, and the launchers' argument
    builders (tasks/_launch.py)."""
    import importlib

    from controllora_tpu.annotators import HWC3 as JHWC3
    from controllora_tpu.data import process_datasets as jpd
    from controllora_tpu_torch import tasks
    from controllora_tpu_torch.annotators import HWC3
    from controllora_tpu_torch.data import process_datasets as pd

    jcanny = importlib.import_module("controllora_tpu.annotators.canny")
    tcanny = importlib.import_module("controllora_tpu_torch.annotators.canny")
    assert (tcanny._TAN22, tcanny._TAN67) == (jcanny._TAN22, jcanny._TAN67)
    for idx, size in ((0, 128), (7, 576), (123, 96)):
        np.testing.assert_array_equal(pd._procedural_image(idx, size),
                                      jpd._procedural_image(idx, size))
    rgba = np.random.default_rng(0).integers(0, 256, (5, 6, 4), dtype=np.uint8)
    np.testing.assert_array_equal(HWC3(rgba), JHWC3(rgba))
    sys.path.insert(0, os.path.join(REPO, "tasks"))
    try:
        import _launch
    finally:
        sys.path.remove(os.path.join(REPO, "tasks"))
    for name in ("train_defaults", "test_defaults"):
        assert (getattr(tasks, name)("a", "process/b", "c", ["--x", "1"])
                == getattr(_launch, name)("a", "process/b", "c", ["--x", "1"]))


def test_parallel_rule_copies_equal(monkeypatch):
    """The copied rules of the parallel slice: ``validate_tp``'s verdicts and
    messages (SD2.1, SDXL) and ``build_serving_mesh``'s grammar and errors
    (``scripts/sample.py``'s); exhaustively in tests/test_torch_parallel_mesh.py."""
    import jax

    from controllora_tpu.models import zoo as jzoo
    from controllora_tpu.parallel import tp as jtp
    from controllora_tpu_torch.parallel import tp
    from controllora_tpu_torch.parallel.mesh import build_serving_mesh
    from scripts.sample import build_serving_mesh as jax_build_serving_mesh

    def verdict(fn, cfg, n):
        try:
            fn(cfg, n)
        except ValueError as e:
            return str(e)
        return None

    for ours, ref in ((zoo.SD21_UNET, jzoo.SD21_UNET), (zoo.SDXL_UNET, jzoo.SDXL_UNET)):
        for n in (2, 4):
            assert verdict(tp.validate_tp, ours, n) == verdict(jtp.validate_tp, ref, n)
    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    for spec in ("tp", "cfg,model=2"):
        with pytest.raises(SystemExit) as a:
            build_serving_mesh(spec, 2)
        with pytest.raises(SystemExit) as b:
            jax_build_serving_mesh(spec)
        assert str(a.value) == str(b.value)


# the annotators' host code and tables, copied from the JAX package verbatim
ANNOTATOR_COPIES = {
    "openpose": ("score_limbs", "assemble_people", "_draw_line", "draw_bodypose", "hand_detect",
                 "draw_handpose", "LIMB_SEQ", "PAF_IDX", "_LIMB_COLORS", "_HAND_EDGES",
                 "_VGG_TRUNK", "_HAND_TRUNK"),
    "mlsd": ("_maxfilter5", "squares_from_segments", "DEFAULT_SQUARE_PARAMS", "_IR_SETTING",
             "_FPN_SELECTED"),
    "hed": ("_BGR_MEAN", "_STAGES", "_STAGE_NAMES"),
    "uniformer": ("ade_palette", "_DIMS", "_DEPTHS", "_HEAD_DIM", "_IMAGENET_MEAN",
                  "_IMAGENET_STD"),
}


def test_annotator_copies_equal():
    """The copied numpy functions have the JAX originals' source, line for line, and
    the copied tables their values; the functions also give the same results on the
    JAX tests' synthetic scenes (decode, drawing, hand boxes, squares)."""
    import importlib
    import inspect

    for name, attrs in ANNOTATOR_COPIES.items():
        ours = importlib.import_module(f"controllora_tpu_torch.annotators.{name}")
        ref = importlib.import_module(f"controllora_tpu.annotators.{name}")
        for attr in attrs:
            a, b = getattr(ours, attr), getattr(ref, attr)
            if callable(a):
                assert inspect.getsource(a) == inspect.getsource(b), f"{name}.{attr}"
            else:
                assert a == b, f"{name}.{attr}"

    from controllora_tpu.annotators import mlsd as jm
    from controllora_tpu.annotators import openpose as jo
    from controllora_tpu_torch.annotators import mlsd as pm
    from controllora_tpu_torch.annotators import openpose as po
    from test_mlsd import _square_scene_segments
    from test_openpose import synth_scene, two_person_scene

    heat, paf = synth_scene(two_person_scene())
    peaks = jo.find_peaks(heat[:, :, :18])
    conns, jconns = po.score_limbs(paf, peaks, 96), jo.score_limbs(paf, peaks, 96)
    for a, b in zip(conns, jconns):
        np.testing.assert_array_equal(a, b)
    (cand, sub), (jcand, jsub) = po.assemble_people(peaks, conns), jo.assemble_people(peaks, conns)
    np.testing.assert_array_equal(sub, jsub)
    np.testing.assert_array_equal(
        po.draw_bodypose(np.zeros((96, 96, 3), np.uint8), cand, sub),
        jo.draw_bodypose(np.zeros((96, 96, 3), np.uint8), jcand, jsub))
    assert po.hand_detect(cand, sub, (96, 96)) == jo.hand_detect(cand, sub, (96, 96))
    hand = [np.array([[10, 12], [20, 30], [0, 0]] + [[5 + i, 40 - i] for i in range(18)])]
    np.testing.assert_array_equal(po.draw_handpose(np.zeros((64, 64, 3), np.uint8), hand),
                                  jo.draw_handpose(np.zeros((64, 64, 3), np.uint8), hand))
    for a, b in zip(pm.squares_from_segments(_square_scene_segments(), 200,
                                             pm.DEFAULT_SQUARE_PARAMS),
                    jm.squares_from_segments(_square_scene_segments(), 200,
                                             jm.DEFAULT_SQUARE_PARAMS)):
        np.testing.assert_array_equal(a, b)
