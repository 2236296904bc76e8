"""The serving presets (ToMe, DeepCache, both) on SD2.1 and SDXL against the JAX package.

On ``smoke2`` (Linear ``proj_in``/``proj_out``, v-prediction DPM-Solver++) and
``smokexl`` (attention-free level 0, dual towers, ``text_time``), from the same
weights (``tests/test_torch_families.py``'s ``stacks``, ``controls`` and ``pipes``:
JAX shapes filled from numpy, loaded through ``utils/convert.py``), a 2-step guided
64² render under each of ``turbo`` (ToMe 0.5 at every level that tiles, with
``tome_min_tokens=0``, and DeepCache interval 2: one full and one shallow step),
``tome`` alone and ``dc2`` alone matches the JAX pipeline's to atol 2e-3 on the
[-1, 1] image, fp32 throughout, with the port's ToMe windows replaced by the JAX
draws (``window_choice``, as ``tests/test_torch_pipeline.py`` does for SD1.5). The
engine's batch of 2 (per-image prompts: their pooled vectors and size ids follow the
rows) equals each request rendered alone under the same settings, and SD2.1's
v-prediction reaches the shallow steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu_torch.ops import tome
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
from controllora_tpu_torch.serving import BatchingEngine
from test_torch_families import build_stacks, controls, make_guide, pipes  # noqa: F401
from test_torch_pipeline import jax_choice

ATOL = 2e-3
SPEEDS = {"turbo": dict(tome_ratio=0.5, tome_min_tokens=0, deepcache_interval=2),
          "tome": dict(tome_ratio=0.5, tome_min_tokens=0),
          "dc2": dict(deepcache_interval=2)}
VARIANTS = ("smoke2", "smokexl")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file (see tests/test_torch_train_families.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stacks():
    """test_torch_families.py's stacks (which ``controls`` and ``pipes`` take) of the
    two families alone."""
    return build_stacks(VARIANTS)


@pytest.fixture(scope="module")
def latents():
    return np.random.default_rng(2).normal(size=(1, 8, 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def references(pipes, latents):  # noqa: F811
    """The JAX pipeline's render under (variant, preset), made once each."""
    memo = {}

    def ref(variant, preset):
        if (variant, preset) not in memo:
            jpipe = pipes[variant][0]
            memo[variant, preset] = jpipe(
                "a red square", guide=make_guide(), latents=jnp.asarray(latents),
                num_inference_steps=2, return_array=True, **SPEEDS[preset])[0]
        return memo[variant, preset]

    return ref


@pytest.mark.parametrize("preset", list(SPEEDS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_preset_render_matches_jax(pipes, references, latents, monkeypatch,  # noqa: F811
                                   variant, preset):
    monkeypatch.setattr(tome, "window_choice", jax_choice)
    pipe = pipes[variant][1]
    kw = dict(guide=make_guide(), latents=latents, num_inference_steps=2,
              return_array=True)
    out = pipe("a red square", **kw, **SPEEDS[preset])[0]
    err = float(np.abs(out - references(variant, preset)).max())
    assert out.shape == (64, 64, 3) and err <= ATOL, f"{variant} {preset}: max|delta| {err}"
    exact = pipe("a red square", **kw)[0]
    assert np.abs(exact - out).max() > 1e-3  # the preset changes the render


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_batch_equals_each_alone_under_turbo(pipes, variant):  # noqa: F811
    """Two requests with their own prompts in one engine batch under ToMe + DeepCache
    render what each renders alone: the merge maps are per row, the window draws do
    not depend on the batch, and each row keeps its pooled vector (SDXL)."""
    pipe = pipes[variant][1]
    reqs = [("a red square", 1), ("a blue circle", 2)]
    common = dict(guide=make_guide(), num_inference_steps=2, height=64, width=64,
                  return_array=True)
    eng = BatchingEngine(pipe, max_wait_ms=2000.0, buckets=(1, 2),
                         pipe_kwargs=SPEEDS["turbo"])
    try:
        futs = [eng.submit(p, seed=seed, **common) for p, seed in reqs]
        batched = [f.result(timeout=300) for f in futs]
        assert eng.stats["batch_sizes"] == {2: 1}
        alone = [eng.submit(p, seed=seed, **common).result(timeout=300) for p, seed in reqs]
    finally:
        eng.stop()
    assert eng.stats["errors"] == 0
    for a, b in zip(batched, alone):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert np.abs(batched[0] - batched[1]).max() > 1e-3


def test_sd21_keeps_v_prediction_under_deepcache(pipes, references, latents):  # noqa: F811
    """The shallow steps' output is read as v as the full steps' is: the v-prediction
    render under DeepCache matches the JAX v-prediction render, and the same stack
    sampled as epsilon-prediction lands elsewhere."""
    vpipe = pipes["smoke2"][1]
    assert vpipe.scheduler.schedule.prediction_type == "v_prediction"
    eps_pipe = StableDiffusionControlLoRAPipeline(
        vpipe.unet, vpipe.vae, vpipe.text_encoder, vpipe.tokenizer, vpipe.control_lora,
        scheduler=DPMSolverMultistepScheduler(), device="cpu")
    kw = dict(guide=make_guide(), latents=latents, num_inference_steps=2,
              return_array=True, **SPEEDS["dc2"])
    ref = references("smoke2", "dc2")
    v_err = float(np.abs(vpipe("a red square", **kw)[0] - ref).max())
    eps_gap = float(np.abs(eps_pipe("a red square", **kw)[0] - ref).max())
    assert v_err <= ATOL < 10 * ATOL < eps_gap, (v_err, eps_gap)
    assert vpipe.scheduler.schedule.prediction_type == "v_prediction"
