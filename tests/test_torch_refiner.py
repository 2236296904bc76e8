"""The trajectory window of the port's pipeline and the SDXL base -> refiner ensemble
against the JAX package.

Mirrors ``tests/test_refiner.py``. ``denoising_end`` with ``return_latents`` stops the
base mid-grid and hands its raw state-frame latents to a second pipeline, which
continues from ``denoising_start`` without re-noising. Splitting one model's
trajectory is exact for the samplers without history (DDIM, Euler: the port against
itself to 1e-5), and the base latents and the continued image match the JAX split
(atol 2e-3 on the [-1, 1] image; the latents, whose scale is ~1, to 2e-3 too). The
full ensemble runs ``smokexl`` [0, 0.6) then ``smokeref`` (5 size ids, aesthetic
scores) on weights filled as test_torch_families.py fills them. The
``python -m controllora_tpu_torch.sample --refiner_variant`` CLI runs it at 64² with
a plain LoRA on the base. Every ValueError of the window is the JAX call's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu import schedulers as jsch
from controllora_tpu_torch import sample
from controllora_tpu_torch import schedulers as tsch
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.utils import convert
from controllora_tpu_torch.utils.png import decode_png
from test_torch_families import filled
from test_torch_training import stack  # noqa: F401 (a fixture)

ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file (see tests/test_torch_train_families.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xl():
    """(JAX pipeline, port pipeline) for smokexl and for smokeref, unguided, on the
    same filled weights."""
    out = {}
    for seed, variant in enumerate(("smokexl", "smokeref")):
        unet, vae, text = jzoo.build_models(variant, dtype=jnp.float32)
        frozen = filled(jax.eval_shape(lambda: jzoo.random_frozen(
            jax.random.PRNGKey(0), unet, vae, text, latent_size=8,
            param_dtype=jnp.float32)), seed)
        tu, tv, tc = zoo.build_models(variant, torch.float32, "cpu")
        convert.load_unet(tu, frozen["unet"])
        convert.load_vae(tv, frozen["vae"])
        convert.load_clip(tc, frozen["text"])
        out[variant] = (JPipeline(unet, vae, text, JHashTokenizer(), frozen),
                        StableDiffusionControlLoRAPipeline(tu, tv, tc, HashTokenizer(),
                                                           device="cpu"))
    return out


@pytest.mark.parametrize("sampler", ["ddim", "euler"])
def test_ensemble_split_is_exact_for_stateless_samplers(stack, sampler):  # noqa: F811
    """[0, 0.5) then [0.5, 1) on the same model equals the unsplit render (port
    against itself); the mid-grid latents equal the JAX split's."""
    jcls, tcls = {"ddim": (jsch.DDIMScheduler, tsch.DDIMScheduler),
                  "euler": (jsch.EulerDiscreteScheduler, tsch.EulerDiscreteScheduler)}[sampler]
    pipe = StableDiffusionControlLoRAPipeline(stack["tu"], stack["tv"], stack["tc"],
                                              HashTokenizer(), scheduler=tcls(), device="cpu")
    lat = np.random.default_rng(5).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = dict(num_inference_steps=6)
    full = pipe("p", latents=lat, return_array=True, **kw)[0]
    mid = pipe("p", latents=lat, denoising_end=0.5, return_latents=True, **kw)[0]
    assert mid.shape == (8, 8, 4)
    cont = pipe("p", latents=mid[None], denoising_start=0.5, return_array=True, **kw)[0]
    np.testing.assert_allclose(full, cont, atol=1e-5)
    jpipe = JPipeline(stack["unet"], stack["vae"], stack["text"], JHashTokenizer(),
                      stack["frozen"], scheduler=jcls())
    ref = jpipe("p", latents=jnp.asarray(lat), denoising_end=0.5, return_latents=True,
                **kw)[0]
    err = float(np.abs(mid - ref).max())
    assert err <= ATOL, f"{sampler} mid-grid latents max|delta| {err}"


def test_base_to_refiner_ensemble_matches_jax(xl):
    """smokexl [0, 0.6) of a 5-step DPM-Solver++ grid, then smokeref [0.6, 1) with
    the aesthetic scores: the hand-off latents and the refined image against JAX."""
    (jbase, base), (jref, ref_pipe) = xl["smokexl"], xl["smokeref"]
    lat0 = np.random.default_rng(6).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = dict(num_inference_steps=5, height=64, width=64)
    jmid = jbase("p", latents=jnp.asarray(lat0), denoising_end=0.6, return_latents=True,
                 **kw)[0]
    mid = base("p", latents=lat0, denoising_end=0.6, return_latents=True, **kw)[0]
    err = float(np.abs(mid - jmid).max())
    assert mid.shape == (8, 8, 4) and err <= ATOL, f"base latents max|delta| {err}"
    refined = jref("p", latents=jnp.asarray(jmid)[None], denoising_start=0.6,
                   return_array=True, **kw)[0]
    out = ref_pipe("p", latents=mid[None], denoising_start=0.6, return_array=True, **kw)[0]
    err = float(np.abs(out - refined).max())
    assert out.shape == (64, 64, 3) and err <= ATOL, f"refined max|delta| {err}"
    other = ref_pipe("p", latents=mid[None], denoising_start=0.6, return_array=True,
                     aesthetic_score=2.0, **kw)[0]
    assert np.abs(other - out).max() > 1e-6  # the score conditions the refiner


def test_refiner_img2img(xl):
    """The refiner alone as an img2img stage over an image (port-only, as
    tests/test_refiner.py): finite, and conditioned by the aesthetic score."""
    pipe = xl["smokeref"][1]
    img = np.clip(np.random.RandomState(3).uniform(-0.5, 0.5, (64, 64, 3)), -1, 1)
    a, b = (pipe("p", image=img.astype(np.float32), strength=0.4, num_inference_steps=5,
                 aesthetic_score=s, return_array=True,
                 generator=torch.Generator().manual_seed(4))[0] for s in (6.0, 2.0))
    assert a.shape == (64, 64, 3) and np.isfinite(a).all()
    assert np.abs(a - b).max() > 1e-6


def test_denoising_validation(stack):  # noqa: F811
    """The JAX call's ValueErrors, on the port (tests/test_refiner.py's matches)."""
    pipe = StableDiffusionControlLoRAPipeline(stack["tu"], stack["tv"], stack["tc"],
                                              HashTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="latents"):
        pipe("p", denoising_start=0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe("p", denoising_start=0.5, image=np.zeros((64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="empty or"):
        pipe("p", num_inference_steps=4, denoising_end=0.05)
    with pytest.raises(ValueError, match="empty or"):
        pipe("p", num_inference_steps=4, latents=np.zeros((1, 8, 8, 4), np.float32),
             denoising_start=0.75, denoising_end=0.5)
    with pytest.raises(ValueError, match="num_images"):
        pipe("p", latents=np.zeros((2, 8, 8, 4), np.float32), num_images=3)


def test_sample_cli_base_to_refiner(tmp_path, capsys):
    """``python -m controllora_tpu_torch.sample --model_variant smokexl
    --refiner_variant smokeref`` at 64² with a plain LoRA file on the base: two
    images; with --mask_image, or the refused --serving_mesh, it stops with the
    reason; the checkpoint-directory flags parse."""
    lora = tlora.make_plain_lora_adapters(torch.Generator().manual_seed(2), 4,
                                          zoo.SMOKEXL_UNET)
    path = str(tmp_path / "pytorch_lora_weights.safetensors")
    convert.save_state_dict(convert.attn_procs_to_torch(lora), path)
    out = tmp_path / "out"
    base = ["--model_variant", "smokexl", "--lora_weights", path, "--prompt", "a toy",
            "--resolution", "64", "--num_inference_steps", "5", "--device", "cpu"]
    sample.main(base + ["--refiner_variant", "smokeref", "--denoising_split", "0.6",
                        "--num_validation_images", "2", "--output_dir", str(out)])
    for i in range(2):
        img = decode_png((out / f"{i}.png").read_bytes())
        assert img.shape == (64, 64, 3)
    assert "two-stage render: base [0, 0.6) -> refiner" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="repaint the preserved region"):
        sample.main(base + ["--refiner_variant", "smokeref", "--init_image", path,
                            "--mask_image", path])
    with pytest.raises(SystemExit):
        sample.parse_args(["--serving_mesh", "x"])
    assert "--serving_mesh is not taken by the port" in capsys.readouterr().err
    args = sample.parse_args(["--pretrained_model_name_or_path", "a",
                              "--refiner_model_path", "b"])
    assert (args.pretrained_model_name_or_path, args.refiner_model_path) == ("a", "b")
