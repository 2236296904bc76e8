"""Threaded adapter stacks in the port's pipeline against the JAX package: a plain LoRA
chained beside a ControlLoRA (the ``mix_lora`` path), a second ControlLoRA
(``extra_controls``), and ToMe and DeepCache over threaded stacks; the ``sample`` and
``mix_lora`` CLIs and their image input.

Mirrors ``tests/test_pipeline.py::test_mix_lora_composition`` and
``test_multi_control_composition`` and
``tests/test_tome.py::test_pipeline_tome_threaded_matches_folded`` on the smoke stack
at 64²: the same weights on both sides (``stack``/``controls`` of
test_torch_training.py; the LoRAs through the attn-procs format), fp32, 2-step guided
renders from the same latents, atol 2e-3 on the [-1, 1] image as
test_torch_pipeline.py holds the folded render. The chain does not fold, so these
renders run each layer's adapters (the UNet's threaded path). ToMe's windows are the
JAX draws (``window_choice`` replaced). The CLIs' flags parse as the scripts' do;
``utils/image.py`` reads PNGs (RGB, gray, RGBA) as PIL's ``convert`` does and resizes
within one level of PIL's bicubic.
"""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu_torch import mix_lora, sample
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.ops import tome
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.pipelines import merge_extra_controls
from controllora_tpu_torch.training.checkpoint import save_control_lora
from controllora_tpu_torch.utils import convert, image
from controllora_tpu_torch.utils.png import decode_png, encode_png
from scripts.mix_lora import parse_args as jax_mix_args
from scripts.sample import parse_args as jax_sample_args
from test_torch_dreambooth import jax_loras, port_loras
from test_torch_pipeline import SPEED, jax_choice, make_guide
from test_torch_training import controls, stack  # noqa: F401 (fixtures)

ATOL = 2e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file (see tests/test_torch_train_families.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes(stack, controls):  # noqa: F811
    """(JAX pipeline, port pipeline) over the smoke stack with the v1 ControlLoRA."""
    jcl, jparams, port = controls["v1"]
    return (JPipeline(stack["unet"], stack["vae"], stack["text"], JHashTokenizer(),
                      stack["frozen"], jcl, jparams),
            StableDiffusionControlLoRAPipeline(stack["tu"], stack["tv"], stack["tc"],
                                               HashTokenizer(), port, device="cpu"))


def latents(seed=7):
    return np.random.default_rng(seed).normal(size=(1, 8, 8, 4)).astype(np.float32)


KW = dict(num_inference_steps=2, return_array=True)


@pytest.mark.parametrize("where", ["pre", "post"])
def test_mix_lora_matches_jax(pipes, where):
    """A LoRA with every factor nonzero chained before (after) every ControlLoRA
    adapter: the threaded render against the JAX one."""
    jpipe, pipe = pipes
    jad, lat = jax_loras(6), latents()
    ref = jpipe("x", guide=make_guide(), latents=jnp.asarray(lat), extra_loras=jad,
                extra_loras_where=where, **KW)[0]
    out = pipe("x", guide=make_guide(), latents=lat, extra_loras=port_loras(jad),
               extra_loras_where=where, **KW)[0]
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"mix {where}: max|delta| {err}"
    base = pipe("x", guide=make_guide(), latents=lat, **KW)[0]
    assert np.abs(out - base).max() > 1e-5  # the LoRA reaches the image


@pytest.mark.parametrize("speed", [{}, SPEED], ids=["exact", "tome+deepcache"])
def test_fresh_lora_chain_equals_folded(pipes, speed):
    """Fresh LoRAs (zero up factors) are exact no-ops: chained beside the ControlLoRA
    they force the threaded path, which equals the folded render, also under ToMe
    (the control states merge with the hidden states' map) and DeepCache (the
    shallow evals run threaded stacks)."""
    _, pipe = pipes
    fresh = tlora.make_plain_lora_adapters(torch.Generator().manual_seed(9), 4,
                                           pipe.unet.config)
    kw = dict(KW, guide=make_guide(), latents=latents(), **speed)
    folded = pipe("a house", **kw)[0]
    threaded = pipe("a house", extra_loras=fresh, **kw)[0]
    np.testing.assert_allclose(threaded, folded, atol=ATOL)


def test_threaded_tome_deepcache_matches_jax(pipes, monkeypatch):
    """ToMe 0.5 at every level that tiles and DeepCache 2 over a threaded stack (a
    nonzero LoRA chained before the ControlLoRA) against the JAX render, with the JAX
    window draws."""
    jpipe, pipe = pipes
    monkeypatch.setattr(tome, "window_choice", jax_choice)
    jad, lat = jax_loras(7), latents(3)
    ref = jpipe("x", guide=make_guide(), latents=jnp.asarray(lat), extra_loras=jad,
                **KW, **SPEED)[0]
    out = pipe("x", guide=make_guide(), latents=lat, extra_loras=port_loras(jad),
               **KW, **SPEED)[0]
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"threaded ToMe + DeepCache: max|delta| {err}"


def test_extra_controls_matches_jax(pipes, controls):  # noqa: F811
    """A second (v2) ControlLoRA with its own guide joins every chain after the first:
    against the JAX triple (control, params, guide); the render depends on the second
    guide."""
    jpipe, pipe = pipes
    jcl2, jparams2, port2 = controls["v2"]
    lat, guide2 = latents(), -make_guide()
    ref = jpipe("x", guide=make_guide(), latents=jnp.asarray(lat),
                extra_controls=[(jcl2, jparams2, guide2)], **KW)[0]
    out = pipe("x", guide=make_guide(), latents=lat, extra_controls=[(port2, guide2)],
               **KW)[0]
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"extra controls: max|delta| {err}"
    other = pipe("x", guide=make_guide(), latents=lat,
                 extra_controls=[(port2, make_guide())], **KW)[0]
    assert np.abs(other - out).max() > 1e-5
    with pytest.raises(ValueError, match="extra_controls guide batch 2"):
        pipe("x", guide=make_guide(), latents=lat, num_inference_steps=1,
             extra_controls=[(port2, np.stack([guide2] * 2))])
    stacks = {"a": tlora.AdapterStack(main=tlora.AttnAdapter(params={}))}
    second = tlora.AttnAdapter(params={})
    merged = merge_extra_controls(stacks, {"a": tlora.AdapterStack(main=second),
                                           "b": tlora.AdapterStack()})
    assert merged["a"].post == (second,) and "b" not in merged


@pytest.mark.parametrize("cli", ["sample", "mix_lora"])
def test_cli_flags_match_scripts(cli):
    """Every flag of scripts/<cli>.py, with its default, plus --device (and, for
    sample, --dist_backend, the process-group flag of --serving_mesh)."""
    argv = [] if cli == "sample" else ["--control_lora_dir", "c", "--lora_weights", "l",
                                       "--prompt", "p"]
    ours, ref = {"sample": (sample.parse_args, jax_sample_args),
                 "mix_lora": (mix_lora.parse_args, jax_mix_args)}[cli]
    got, want = vars(ours(argv)), vars(ref(argv))
    assert got.pop("device") == "cuda"
    if cli == "sample":
        assert got.pop("dist_backend") is None
    assert got == want
    if cli == "sample":
        full = ["--scheduler", "euler", "--strength", "0.5", "--prediction_type",
                "v_prediction", "--refiner_variant", "sdxl-refiner", "--denoising_split",
                "0.7", "--tome_ratio", "0.5", "--deepcache_interval", "2",
                "--model_variant", "smokexl", "--resume_from_checkpoint", "latest"]
        assert vars(ours(full + ["--device", "cpu", "--serving_mesh", "cfg"])) == dict(
            vars(ref(full + ["--serving_mesh", "cfg"])), device="cpu", dist_backend=None)


def png_bytes(arr, mode, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, format=fmt)
    return buf.getvalue()


def test_image_io_matches_pil(tmp_path):
    """RGB, gray and RGBA PNGs read as PIL's convert("RGB"); the bicubic resize within
    one level of PIL's, up and down; masks as PIL's convert("L"); a JPEG is refused."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    for mode in ("RGB", "L", "RGBA"):
        path = tmp_path / f"{mode}.png"
        path.write_bytes(png_bytes(src, mode))
        pil = Image.open(path)
        np.testing.assert_array_equal(image.read_png(str(path)), np.asarray(pil.convert("RGB")))
        for size in ((32, 32), (64, 96), (100, 60)):
            want = np.asarray(pil.convert("RGB").resize(size[::-1], Image.BICUBIC), np.int16)
            got = image.resize_bicubic(image.read_png(str(path)), *size).astype(np.int16)
            assert got.shape == want.shape and np.abs(got - want).max() <= 1, (mode, size)
        want_l = np.asarray(pil.convert("L").resize((64, 64), Image.BICUBIC), np.float32) / 255
        got_l = image.load_mask(str(path), 64)
        assert np.abs(got_l - want_l).max() <= 1.0 / 255 + 1e-7, mode
    rgb = np.asarray(Image.open(tmp_path / "RGB.png").resize((64, 64), Image.BICUBIC),
                     np.float32) / 127.5 - 1.0
    assert np.abs(image.load_image(str(tmp_path / "RGB.png"), 64) - rgb).max() <= 1 / 127.5 + 1e-6
    jpeg = tmp_path / "guide.jpg"
    jpeg.write_bytes(png_bytes(src, "RGB", "JPEG"))
    with pytest.raises(ValueError, match="not a PNG.*no PIL"):
        image.read_png(str(jpeg))


def test_sample_and_mix_lora_clis(tmp_path, controls, capsys):  # noqa: F811
    """On the CPU at 64²: ``sample`` from a run's checkpoint (re-saving the run-root
    artifact) with a chained LoRA, an init image and a mask, writing a 3-panel
    montage; ``python -m controllora_tpu_torch.mix_lora`` from a .safetensors LoRA
    written by the port's writer, with a PNG guide."""
    run = tmp_path / "run"
    save_control_lora(str(run / "checkpoint-2" / "control_lora"), controls["v1"][2])
    torch.save({}, run / "checkpoint-2" / "train_state.pt")
    lora = tlora.make_plain_lora_adapters(torch.Generator().manual_seed(3), 4,
                                          zoo.SMOKE_UNET)
    for a in lora.values():
        for pair in a.params.values():
            pair["up"] += 0.02
    lora_path = str(tmp_path / "pytorch_lora_weights.safetensors")
    convert.save_state_dict(convert.attn_procs_to_torch(lora), lora_path)
    pic = np.random.default_rng(1).integers(0, 256, (80, 80, 3), dtype=np.uint8)
    (tmp_path / "init.png").write_bytes(encode_png(pic))
    mask = np.zeros((80, 80, 3), np.uint8)
    mask[:, :40] = 255
    (tmp_path / "mask.png").write_bytes(encode_png(mask))

    out = tmp_path / "samples"
    sample.main(["--model_variant", "smoke", "--control_lora_dir", str(run),
                 "--resume_from_checkpoint", "latest", "--lora_weights", lora_path,
                 "--resolution", "64", "--num_inference_steps", "3",
                 "--num_validation_images", "1", "--init_image", str(tmp_path / "init.png"),
                 "--mask_image", str(tmp_path / "mask.png"), "--strength", "0.7",
                 "--output_dir", str(out), "--device", "cpu"])
    said = capsys.readouterr().out
    assert "sampling from training checkpoint-2" in said and "re-saved final artifact" in said
    assert (run / "config.json").exists()
    assert decode_png((out / "0.png").read_bytes()).shape == (64, 192, 3)

    mixed = tmp_path / "mix"
    proc = subprocess.run(
        [sys.executable, "-m", "controllora_tpu_torch.mix_lora", "--model_variant", "smoke",
         "--control_lora_dir", str(run), "--lora_weights", lora_path, "--where", "post",
         "--prompt", "a sks circle", "--guide_image", str(tmp_path / "init.png"),
         "--resolution", "64", "--num_inference_steps", "2", "--output_dir", str(mixed),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded 20 plain LoRA adapters + ControlLoRA" in proc.stdout
    assert decode_png((mixed / "0.png").read_bytes()).shape == (64, 64, 3)
