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
                   "utils.logging", "sample", "mix_lora", "pipelines.hires", "utils.image"):
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
