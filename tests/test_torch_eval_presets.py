"""``python -m controllora_tpu_torch.eval_presets`` against ``scripts/eval_presets.py``.

* Its ``PRESETS`` table and flags equal the JAX script's (``--device`` added, default
  cuda).
* A 2-step CPU training run through the port's train CLI, then the evaluation at
  ``--num_eval 3 --num_inference_steps 2``: the report has exactly the keys of the JAX
  script's report (``docs/presets_quality_r5.json``), ``exact`` reads 0 error and
  retrieval 1.0, the ``--report`` file holds the printed line, and the montage PNG
  decodes to (2 + 4 presets) rows of 3 images.
* On that artifact, the port's report equals ``scripts/eval_presets.main([
  "--control_lora_dir", ...])``'s: the JAX script's frozen stack goes into the port
  through the construction seam (``build_pipeline``). That stack has the tree of
  ``random_frozen`` with the seeded numpy values of ``tests/test_torch_families.py``'s
  ``filled`` (``random_frozen`` replaced: its init program takes half a minute to
  compile on the CPU), and
  the JAX initial-latent draws (``text_to_image.draw_noise``) and ToMe window draws
  (``window_choice``) are injected. The latent metrics agree within 1e-3 relative
  plus one unit of the report's rounding, retrieval accuracy exactly, the u8 drift
  and the VAE round trip's circle-fit errors within 0.5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu_torch import eval_presets
from controllora_tpu_torch.ops import tome
from controllora_tpu_torch.pipelines import text_to_image
from controllora_tpu_torch.utils.png import decode_png
from scripts import eval_presets as jax_eval_presets
from test_torch_families import filled
from test_torch_pipeline import jax_choice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = ["--num_eval", "3", "--num_inference_steps", "2"]
# report fields compared within 1e-3 relative, with the unit each is rounded to
LATENT = {"latent_rel_err_vs_exact_mean": 1e-4, "latent_rel_err_vs_exact_max": 1e-4,
          "guide_sensitivity": 1e-4, "latent_nrmse_vs_gt_mean": 0.1}
PIXEL = ("drift_vs_exact_u8_mean", "drift_vs_exact_u8_max")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file (see tests/test_torch_train_families.py), and
    autograd on, whatever an earlier file in this worker left: `trained` runs the train
    CLI, and tests/test_parity_fixtures.py switches autograd off process-wide."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.enable_grad():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["--output_dir", "/o"],
    ["--output_dir", "/o", "--control_lora_dir", "/r", "--train_steps", "300",
     "--train_batch_size", "4", "--resolution", "128", "--num_eval", "3",
     "--num_inference_steps", "5", "--guidance_scale", "7.5", "--seed", "7",
     "--report", "/o/r.json"]], ids=["defaults", "every-flag"])
def test_presets_and_flags_equal_scripts_eval_presets(argv):
    assert eval_presets.PRESETS == jax_eval_presets.PRESETS
    ours, ref = vars(eval_presets.parse_args(argv)), vars(jax_eval_presets.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(output dir, report) of the port's 2-step CPU train + evaluation."""
    out = str(tmp_path_factory.mktemp("presets"))
    report = eval_presets.main(["--output_dir", out, "--device", "cpu", "--train_steps",
                                "2", "--report", os.path.join(out, "report.json")] + EVAL)
    return out, report


def test_cpu_train_and_eval_report(trained, capsys):
    out, report = trained
    with open(os.path.join(REPO, "docs", "presets_quality_r5.json")) as f:
        jax_report = json.load(f)
    assert list(report) == list(jax_report)
    for name, entry in jax_report["presets"].items():
        assert list(report["presets"][name]) == list(entry), name
    assert report["train_dir"] == os.path.join(out, "train")
    assert {"config.json", "diffusion_pytorch_model.bin"} <= set(os.listdir(report["train_dir"]))
    exact = report["presets"]["exact"]
    assert exact["latent_rel_err_vs_exact_mean"] == exact["latent_rel_err_vs_exact_max"] == 0.0
    assert exact["exact_retrieval_acc"] == 1.0 and exact["drift_vs_exact_u8_max"] == 0.0
    assert all(np.isfinite(e["guide_sensitivity"]) for e in report["presets"].values())
    with open(os.path.join(out, "report.json")) as f:
        assert json.loads(f.read()) == report
    with open(report["montage"], "rb") as f:
        montage = decode_png(f.read())
    assert montage.shape == ((2 + len(eval_presets.PRESETS)) * 64, 3 * 64, 3)


def jax_noise(generator, shape):
    """The JAX pipeline's initial latents for ``rng=PRNGKey(seed)``: the second half
    of its first split, for the seed the port's generator was seeded with."""
    key = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
    return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))


def test_report_equals_jax_script_on_one_artifact(trained, tmp_path, monkeypatch):
    from controllora_tpu.data.tokenizer import HashTokenizer
    from controllora_tpu.models import zoo as jzoo
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
    from controllora_tpu_torch.training.checkpoint import load_control_lora
    from controllora_tpu_torch.utils import convert

    run_dir = trained[1]["train_dir"]
    made, random_frozen = [], jzoo.random_frozen

    def filled_frozen(*args, **kw):
        made.append(filled(jax.eval_shape(lambda: random_frozen(*args, **kw)), 5))
        return made[-1]

    monkeypatch.setattr(jzoo, "random_frozen", filled_frozen)
    ref = jax_eval_presets.main(["--control_lora_dir", run_dir, "--output_dir",
                                 str(tmp_path / "jax")] + EVAL)
    assert len(made) == 1

    def jax_stack_pipeline(args, run):
        """The JAX script's frozen stack, converted into the port."""
        frozen = made[0]
        tu, tv, tc = zoo.build_models("smoke", torch.float32, "cpu")
        convert.load_unet(tu, frozen["unet"])
        convert.load_vae(tv, frozen["vae"])
        convert.load_clip(tc, frozen["text"])
        control, _ = load_control_lora(run, "cpu")
        return StableDiffusionControlLoRAPipeline(
            tu, tv, tc, HashTokenizer(), control, scheduler=DPMSolverMultistepScheduler(),
            device="cpu")

    monkeypatch.setattr(eval_presets, "build_pipeline", jax_stack_pipeline)
    monkeypatch.setattr(text_to_image, "draw_noise", jax_noise)
    monkeypatch.setattr(tome, "window_choice", jax_choice)
    ours = eval_presets.main(["--control_lora_dir", run_dir, "--output_dir",
                              str(tmp_path / "port"), "--device", "cpu"] + EVAL)

    assert list(ours) == list(ref)
    for key in ("train_dir", "num_eval", "resolution", "num_inference_steps",
                "pixel_fit_valid", "pixel_fit_note"):
        assert ours.get(key) == ref.get(key), key
    for key in ("vae_roundtrip_center_err_px", "vae_roundtrip_radius_err_px"):
        assert abs(ours[key] - ref[key]) <= 0.5, (key, ours[key], ref[key])
    for name, want in ref["presets"].items():
        got = ours["presets"][name]
        assert list(got) == list(want)
        assert got["tome_ratio"] == want["tome_ratio"]
        assert got["deepcache_interval"] == want["deepcache_interval"]
        assert got["exact_retrieval_acc"] == want["exact_retrieval_acc"], name
        for key, unit in LATENT.items():
            assert abs(got[key] - want[key]) <= 1e-3 * abs(want[key]) + unit, \
                (name, key, got[key], want[key])
        for key in PIXEL:
            assert abs(got[key] - want[key]) <= 0.5, (name, key, got[key], want[key])
