"""End-to-end parity of the port's guided pipeline and serving engine.

A guided 64² render with 2 DPM-Solver++ steps goes through the JAX pipeline and the
port with the same weights, the same injected latents and the HashTokenizer, fp32
throughout. atol 2e-3 on the [-1, 1] image: differences in summation order through
CLIP, hint encoder, fold, 2 CFG UNet evals and the VAE stay well under it. The same
bound holds for the serving accelerations together (ToMe 0.5 at every level that
tiles, DeepCache interval 2: one full and one shallow step), with DPM-Solver++ and
with Euler, whose UNet input is rescaled; the port's ToMe windows are then the JAX
draws (``window_choice`` replaced).
"""

import os
import subprocess
import sys

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.config import ControlLoRAConfig
from controllora_tpu.data.tokenizer import HashTokenizer
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.control_lora import ControlLoRA as JControlLoRA
from controllora_tpu.models.unet import derive_cross_attention_dims
from controllora_tpu.ops import tome as jtome
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu.schedulers import EulerDiscreteScheduler as JEuler
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.ops import tome
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.schedulers import EulerDiscreteScheduler
from controllora_tpu_torch.serving import BatchingEngine
from controllora_tpu_torch.serving.engine import request_latents
from controllora_tpu_torch.utils import convert

TINY_CONTROL = ControlLoRAConfig(
    block_out_channels=(8, 16, 16, 32),
    lora_block_in_channels=(32, 32, 32, 32),
    lora_block_out_channels=(32, 64, 96, 96),
    lora_cross_attention_dims=derive_cross_attention_dims(jzoo.SMOKE_UNET),
)
COMMON = dict(num_inference_steps=2, height=64, width=64, return_array=True)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) over the same smoke weights."""
    unet, vae, text = jzoo.build_models("smoke", dtype=jnp.float32)
    frozen = jzoo.random_frozen(jax.random.PRNGKey(0), unet, vae, text,
                                latent_size=8, param_dtype=jnp.float32)
    cl = JControlLoRA(TINY_CONTROL)
    cp = jax.tree.map(lambda x: x + 0.01, cl.init(jax.random.PRNGKey(1), image_size=64))
    jpipe = JPipeline(unet, vae, text, HashTokenizer(), frozen, cl, cp)

    tu, tv, tc = zoo.build_models("smoke", dtype=torch.float32, device="cpu")
    convert.load_unet(tu, frozen["unet"])
    convert.load_vae(tv, frozen["vae"])
    convert.load_clip(tc, frozen["text"])
    tcl = convert.load_control_lora(zoo.build_control_lora(TINY_CONTROL, "cpu"), cp)
    return jpipe, StableDiffusionControlLoRAPipeline(tu, tv, tc, HashTokenizer(), tcl,
                                                     device="cpu")


def make_guide():
    g = np.zeros((64, 64, 3), np.float32) - 1.0
    g[20:40, 20:40] = 1.0
    return g


def test_guided_render_matches_jax(pipes):
    jpipe, pipe = pipes
    lat = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = dict(guide=make_guide(), num_inference_steps=2, latents=lat,
              return_array=True)
    ref = jpipe("a red square", latents=jnp.asarray(lat),
                **{k: v for k, v in kw.items() if k != "latents"})[0]
    out = pipe("a red square", **kw)[0]
    assert out.shape == (64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=2e-3)
    unguided = pipe("a red square", latents=lat, num_inference_steps=2,
                    return_array=True)[0]
    assert np.abs(unguided - out).max() > 1e-3  # the guide reaches the image


def jax_choice(seed, timestep, index, prefix, block, nsy, nsx):
    """The JAX package's ToMe window draw for a step, module and block: the key of
    ``step_key`` folded with crc32(prefix) and the block index (JAX ``unet.py``
    :476-498), drawn as ``build_merge`` draws it (``tome.py`` :90)."""
    key = jtome.step_key(seed, jnp.asarray(timestep), index)
    key = jax.random.fold_in(key, zlib.crc32(prefix.encode()) & 0x7FFFFFFF)
    key = jax.random.fold_in(key, block)
    return torch.from_numpy(np.array(jax.random.randint(key, (nsy, nsx), 0, 4)))


SPEED = dict(tome_ratio=0.5, tome_min_tokens=0, deepcache_interval=2)


@pytest.mark.parametrize("sampler", ["dpm++", "euler"])
def test_tome_deepcache_render_matches_jax(pipes, monkeypatch, sampler):
    jpipe, pipe = pipes
    if sampler == "euler":
        jpipe = JPipeline(jpipe.unet, jpipe.vae, jpipe.text_encoder, jpipe.tokenizer,
                          jpipe.frozen, jpipe.control_lora, jpipe.control_params,
                          scheduler=JEuler())
        pipe = StableDiffusionControlLoRAPipeline(
            pipe.unet, pipe.vae, pipe.text_encoder, pipe.tokenizer, pipe.control_lora,
            scheduler=EulerDiscreteScheduler(), device="cpu")
    monkeypatch.setattr(tome, "window_choice", jax_choice)
    lat = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = dict(guide=make_guide(), num_inference_steps=2, return_array=True)
    ref = jpipe("a red square", latents=jnp.asarray(lat), **kw, **SPEED)[0]
    out = pipe("a red square", latents=lat, **kw, **SPEED)[0]
    err = float(np.abs(out - ref).max())
    assert out.shape == (64, 64, 3) and err <= 2e-3, f"max|delta| {err}"
    exact = pipe("a red square", latents=lat, **kw)[0]
    assert np.abs(exact - out).max() > 1e-3  # the accelerations change the render


def test_speed_knob_validation(pipes):
    _, pipe = pipes
    for bad in (dict(tome_ratio=0.8), dict(tome_ratio=-0.1), dict(deepcache_interval=0)):
        with pytest.raises(ValueError):
            pipe("x", num_inference_steps=2, height=64, width=64, **bad)


def test_uint8_output_and_generator(pipes):
    _, pipe = pipes
    a = pipe("x", guide=make_guide(), num_inference_steps=2,
             generator=torch.Generator().manual_seed(3))[0]
    b = pipe("x", guide=make_guide(), num_inference_steps=2,
             generator=torch.Generator().manual_seed(3))[0]
    assert a.dtype == np.uint8 and a.shape == (64, 64, 3)
    np.testing.assert_array_equal(a, b)


def engine_matches_solo(pipe, speed):
    """3 requests submitted together render as one padded batch of 4, and each image
    equals the request's solo render (same seed -> same latents)."""
    eng = BatchingEngine(pipe, max_wait_ms=3000.0, buckets=(1, 2, 4), pipe_kwargs=speed,
                         device="cpu")
    try:
        futs = [eng.submit(f"prompt {i}", seed=100 + i, guide=make_guide(), **COMMON)
                for i in range(3)]
        results = [f.result(timeout=600) for f in futs]
    finally:
        eng.stop()
    assert eng.stats["batches"] == 1
    assert eng.stats["batch_sizes"] == {4: 1}
    assert eng.stats["padded_slots"] == 1
    for i, img in enumerate(results):
        ref = pipe(f"prompt {i}", guide=make_guide(), num_inference_steps=2,
                   latents=request_latents(100 + i, 64, 64), return_array=True, **speed)[0]
        np.testing.assert_allclose(img, ref, atol=5e-4)


def test_engine_coalesces_and_matches_solo(pipes):
    _, pipe = pipes
    with pytest.raises(ValueError):
        BatchingEngine(pipe, device="meta")  # not the pipeline's device
    engine_matches_solo(pipe, {})


def test_engine_batch_independent_under_tome_deepcache(pipes):
    """The same under ToMe + DeepCache: the merge maps are per row and the window
    draws do not depend on the batch."""
    engine_matches_solo(pipes[1], SPEED)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import controllora_tpu_torch\n"
        "import controllora_tpu_torch.pipelines, controllora_tpu_torch.serving\n"
        "import controllora_tpu_torch.models.zoo, controllora_tpu_torch.utils.convert\n"
        "import controllora_tpu_torch.ops.flash_attention\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
