"""The port's dataset builders (``controllora_tpu_torch/make_dataset.py``, run as
``python -m controllora_tpu_torch.tasks make_dataset_*``) against the JAX package's
``tasks/make_dataset_fill50k.py`` and ``tasks/make_dataset_diffusiondb_canny.py`` on
the CPU, and the grayscale PNG writer they need.

Each JAX script runs as it stands, in a subprocess (PIL writes its files); the port
builds into a second directory with ``--device cpu``. Every image and guide decodes to
the same pixels, by PIL and by ``utils/png.py::decode_png``, in the same PIL mode, and
``prompt.jsonl`` is byte-equal. All comparisons are exact.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from controllora_tpu_torch import make_dataset, tasks
from controllora_tpu_torch.data.fill50k import _COLORS
from controllora_tpu_torch.data.process_datasets import _JsonlGuideDataset
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.utils.png import decode_png, encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# builder -> (JAX script, its arguments here, PIL mode of the images, of the guides)
BUILDS = {
    "fill50k": ("make_dataset_fill50k.py", ["--num", "8", "--resolution", "64"], "RGB", "RGB"),
    "diffusiondb_canny": ("make_dataset_diffusiondb_canny.py",
                          ["--num", "4", "--resolution", "64", "--seed", "3"], "RGB", "L"),
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """builder -> (the JAX script's directory, the port's directory)."""
    root = tmp_path_factory.mktemp("datasets")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for name, (script, args, _, _) in BUILDS.items():
        jax_dir, port_dir = str(root / f"jax_{name}"), str(root / f"port_{name}")
        proc = subprocess.run([sys.executable, os.path.join("tasks", script), "--out", jax_dir,
                               *args], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert tasks.main([f"make_dataset_{name}", "--out", port_dir, *args,
                           "--device", "cpu"]) == 0
        out[name] = (jax_dir, port_dir)
    return out


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_writes_the_jax_scripts_files(built, name):
    jax_dir, port_dir = built[name]
    _, args, image_mode, guide_mode = BUILDS[name]
    num = int(args[1])
    assert read(os.path.join(port_dir, "prompt.jsonl")) == read(
        os.path.join(jax_dir, "prompt.jsonl"))
    for kind, mode in (("images", image_mode), ("guides", guide_mode)):
        files = sorted(os.listdir(os.path.join(jax_dir, kind)))
        assert files == sorted(os.listdir(os.path.join(port_dir, kind)))
        assert len(files) == num
        for f in files:
            ours, theirs = (Image.open(os.path.join(d, kind, f)) for d in (port_dir, jax_dir))
            assert ours.mode == theirs.mode == mode, (kind, f)
            assert ours.size == (64, 64)
            np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
            a, b = (decode_png(read(os.path.join(d, kind, f))) for d in (port_dir, jax_dir))
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, np.asarray(ours.convert("RGB")))
    # the pairs read back as the jsonl datasets read them
    ds = _JsonlGuideDataset(HashTokenizer(), resolution=64, data_root=port_dir)
    assert len(ds) == num
    item = ds[num - 1]
    assert item["pixel_values"].shape == item["guide_values"].shape == (64, 64, 3)


def test_fill50k_writes_the_jax_rounding_not_the_palette(built):
    """The JAX script converts the [-1, 1] float32 item back with a truncating cast,
    which writes some palette levels one lower (red's 40 as 39): the port writes what
    the JAX script writes, so a port that wrote the palette colours fails here."""
    _, port_dir = built["fill50k"]
    with open(os.path.join(port_dir, "prompt.jsonl")) as f:
        records = [json.loads(line) for line in f]
    lowered = 0
    for rec in records:
        bg = rec["text"].split(" background")[0].split()[-1]
        corner = decode_png(read(os.path.join(port_dir, rec["image"])))[0, 0].astype(int)
        palette = np.array(_COLORS[bg])
        assert np.all((corner == palette) | (corner == palette - 1)), (bg, corner)
        lowered += int(np.any(corner == palette - 1))
    assert lowered >= 1


@pytest.mark.parametrize("h,w", [(1, 1), (37, 53), (64, 64)])
def test_gray_png_round_trips(h, w):
    gray = np.random.default_rng(h * w).integers(0, 256, (h, w), dtype=np.uint8)
    data = encode_png(gray)
    pil = Image.open(io.BytesIO(data))
    assert pil.mode == "L" and pil.size == (w, h)
    np.testing.assert_array_equal(np.asarray(pil), gray)
    np.testing.assert_array_equal(decode_png(data), np.repeat(gray[:, :, None], 3, axis=2))


def test_rgb_png_bytes_are_unchanged():
    """RGB output is byte for byte what the RGB-only writer gave (its SHA-256 on this
    seeded image)."""
    img = np.random.default_rng(7).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert hashlib.sha256(encode_png(img)).hexdigest() == (
        "73ec557fdb25964fb393d6f7255b9a98f9bb547f183b6db77e1dafd8c5a8d5c4")


NO_PIL = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "jax", "controllora_tpu"):
            raise ImportError("the builders imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
from controllora_tpu_torch import tasks
for name, args in (("fill50k", []), ("diffusiondb_canny", ["--seed", "1"])):
    assert tasks.main(["make_dataset_" + name, "--out", sys.argv[1] + "/" + name, "--num",
                       "2", "--resolution", "32", "--device", "cpu", *args]) == 0
"""


def test_builders_run_without_pil(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", NO_PIL, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote 2 pairs to" in proc.stdout
    for name in ("fill50k", "diffusiondb_canny"):
        assert decode_png(read(tmp_path / name / "guides" / "1.png")).shape == (32, 32, 3)


def test_tasks_routes_the_builders(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(make_dataset, "main", lambda argv: calls.append(argv) or 0)
    assert tasks.main(["make_dataset_fill50k", "--num", "3"]) == 0
    assert tasks.main(["make_dataset_diffusiondb_canny", "--seed", "2"]) == 0
    assert calls == [["fill50k", "--num", "3"], ["diffusiondb_canny", "--seed", "2"]]
    assert tasks.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert "make_dataset_fill50k" in listed and "make_dataset_diffusiondb_canny" in listed
    with pytest.raises(SystemExit, match="unknown task"):
        tasks.main(["make_dataset_nothing"])


def test_builder_flags_and_defaults_are_the_jax_scripts():
    fill = make_dataset.parse_args(["fill50k"])
    assert (fill.out, fill.num, fill.resolution, fill.device) == (
        "data/fill50k", 50_000, 512, "cuda")
    canny = make_dataset.parse_args(["diffusiondb_canny"])
    assert (canny.out, canny.num, canny.resolution, canny.seed, canny.device) == (
        "data/diffusiondb-canny", 5000, 512, 0, "cuda")


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_on_cuda_without_a_card_raises(monkeypatch, tmp_path, name):
    """No fallback: the default --device cuda where there is no card raises, and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        make_dataset.main([name, "--out", str(tmp_path / "out"), "--num", "1"])
    assert not (tmp_path / "out").exists()
