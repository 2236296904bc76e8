"""img2img, inpaint and the hires fix of the port's pipeline against the JAX package.

Mirrors ``tests/test_img2img.py`` on the smoke stack at 64² (128² for the hires
pass): the same weights (``stack``/``controls`` of test_torch_training.py, the port's
seeded smoke stack and a perturbed v1 ControlLoRA carried to the JAX side), the
HashTokenizer, fp32, guided renders. The port's Gaussian draws are the JAX
package's: ``text_to_image.draw_noise`` is replaced by the draw the JAX call makes
for its key (``jax.random.split(rng)[1]``), as ``window_choice`` is replaced for
ToMe. atol 2e-3 on the [-1, 1] image, as test_torch_pipeline.py holds the
text-to-image render; the latent mask's resize equals ``jax.image.resize(...,
"linear")`` to 1e-6. Each sampler (and each strength) is one JAX program to compile,
so the JAX side runs once per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.models.vae import decode_per_image
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu.pipelines import hires_fix as j_hires_fix
from controllora_tpu import schedulers as jsch
from controllora_tpu_torch import schedulers as tsch
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline, hires_fix
from controllora_tpu_torch.pipelines import text_to_image
from test_torch_pipeline import make_guide
from test_torch_training import controls, stack  # noqa: F401 (fixtures)

ATOL = 2e-3
SAMPLERS = {"dpm++": (jsch.DPMSolverMultistepScheduler, tsch.DPMSolverMultistepScheduler),
            "ddim": (jsch.DDIMScheduler, tsch.DDIMScheduler),
            "pndm": (jsch.PNDMScheduler, tsch.PNDMScheduler),
            "euler": (jsch.EulerDiscreteScheduler, tsch.EulerDiscreteScheduler),
            "unipc": (jsch.UniPCMultistepScheduler, tsch.UniPCMultistepScheduler)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file (see tests/test_torch_train_families.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pipes(stack, controls, sampler="dpm++"):  # noqa: F811
    """(JAX pipeline, port pipeline) over the same smoke weights and v1 ControlLoRA."""
    jcl, jparams, port = controls["v1"]
    jcls, tcls = SAMPLERS[sampler]
    jpipe = JPipeline(stack["unet"], stack["vae"], stack["text"], JHashTokenizer(),
                      stack["frozen"], jcl, jparams, scheduler=jcls())
    pipe = StableDiffusionControlLoRAPipeline(stack["tu"], stack["tv"], stack["tc"],
                                              HashTokenizer(), port, scheduler=tcls(),
                                              device="cpu")
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes(stack, controls):  # noqa: F811
    return make_pipes(stack, controls)


def jax_draws(monkeypatch, *keys):
    """The port's draw_noise returns, call by call, the draws the JAX pipeline makes
    from each key: ``normal(split(key)[1], shape)``."""
    queue = list(keys)

    def draw(generator, shape):
        key = jax.random.split(queue.pop(0))[1]
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    monkeypatch.setattr(text_to_image, "draw_noise", draw)


def init_image(seed=7, size=64):
    """A smooth image in [-1, 1] (tests/test_img2img.py's)."""
    small = np.random.RandomState(seed).uniform(-0.8, 0.8, (8, 8, 3)).astype(np.float32)
    return np.clip(np.asarray(jax.image.resize(jnp.asarray(small), (size, size, 3),
                                               "linear")), -1.0, 1.0)


def half_mask():
    m = np.zeros((64, 64), np.float32)
    m[:, :32] = 1.0
    return m


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_img2img_matches_jax(stack, controls, monkeypatch, sampler):  # noqa: F811
    """Each sampler's frame: the init noised to its start point (Euler: x0 + sigma *
    noise, the others add_noise), a 2-step suffix of a 4-step grid (DPM-Solver++ and
    UniPC start their order-1 warm-up there)."""
    jpipe, pipe = make_pipes(stack, controls, sampler)
    img, key = init_image(), jax.random.PRNGKey(2)
    kw = dict(guide=make_guide(), image=img, strength=0.6, num_inference_steps=4,
              return_array=True)
    ref = jpipe("a red square", rng=key, **kw)[0]
    jax_draws(monkeypatch, key)
    out = pipe("a red square", **kw)[0]
    err = float(np.abs(out - ref).max())
    assert out.shape == (64, 64, 3) and err <= ATOL, f"{sampler}: max|delta| {err}"


def test_img2img_strength_and_batch(pipes):
    """Port-only, as tests/test_img2img.py: a low strength ends closer to the init
    than a high one (in latent space: the random smoke VAE's round trip alone is far
    from the image); a batch of 2 draws different noise per image."""
    _, pipe = pipes
    img = init_image()
    init = pipe.encode_image(img[None]).permute(0, 2, 3, 1).numpy()[0]
    lo, hi = (pipe("p", image=img, strength=s, num_inference_steps=8, return_latents=True,
                   generator=torch.Generator().manual_seed(1))[0] for s in (0.3, 0.9))
    assert np.abs(lo - init).mean() < np.abs(hi - init).mean()
    outs = pipe("p", image=img, strength=0.5, num_inference_steps=4, num_images=2,
                return_array=True)
    assert len(outs) == 2 and np.abs(outs[0] - outs[1]).mean() > 1e-4


def test_zero_strength_is_vae_roundtrip(pipes, stack):  # noqa: F811
    """Strength 0 runs no step: the exact round trip of the port's own encode and
    decode, and the JAX round trip within ATOL."""
    jpipe, pipe = pipes
    img = init_image()
    out = pipe("p", image=img, strength=0.0, num_inference_steps=8, return_array=True)[0]
    with torch.inference_mode():
        own = pipe.vae.decode(pipe.encode_image(img[None])).permute(0, 2, 3, 1).numpy()[0]
    np.testing.assert_allclose(out, own, atol=1e-6)
    ref = np.asarray(decode_per_image(stack["vae"], stack["frozen"]["vae"],
                                      jpipe._encode_image(jnp.asarray(img)[None])))[0]
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_inpaint_matches_jax(pipes, monkeypatch):
    """A half mask against the JAX render; port-only: its unmasked latent columns
    equal the init latents (the last re-injection is the clean init), a full mask
    equals img2img and an empty one the VAE round trip."""
    jpipe, pipe = pipes
    img, key = init_image(), jax.random.PRNGKey(5)
    kw = dict(guide=make_guide(), image=img, strength=0.9, num_inference_steps=6)
    ref = jpipe("p", mask=half_mask(), rng=key, return_array=True, **kw)[0]
    jax_draws(monkeypatch, key, key)
    out = pipe("p", mask=half_mask(), return_array=True, **kw)[0]
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"inpaint max|delta| {err}"
    lat = pipe("p", mask=half_mask(), return_latents=True, **kw)[0]
    init = pipe.encode_image(img[None]).permute(0, 2, 3, 1).numpy()[0]
    # column 4 straddles the mask edge (a soft blend); 5+ are outside the repaint
    np.testing.assert_allclose(lat[:, 5:], init[:, 5:], atol=1e-5)
    assert np.abs(lat[:, :4] - init[:, :4]).mean() > 1e-3

    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    monkeypatch.setattr(text_to_image, "draw_noise",
                        lambda g, shape: torch.randn(shape, generator=g))
    full = pipe("p", mask=np.ones((64, 64), np.float32), generator=gen(),
                return_array=True, **kw)[0]
    plain = pipe("p", generator=gen(), return_array=True, **kw)[0]
    np.testing.assert_allclose(full, plain, atol=1e-5)
    kept = pipe("p", mask=np.zeros((64, 64), np.float32), return_array=True, **kw)[0]
    roundtrip = pipe("p", **dict(kw, strength=0.0), return_array=True)[0]
    np.testing.assert_allclose(kept, roundtrip, atol=1e-5)


@pytest.mark.parametrize("shape,size", [((64, 64), (8, 8)), ((512, 512), (64, 64)),
                                        ((96, 160), (12, 20)), ((64, 64, 3), (8, 8))])
def test_latent_mask_matches_jax_resize(shape, size):
    """The antialiased bilinear resize equals jax.image.resize(m, (lh, lw), "linear")
    on hard and soft masks."""
    rng = np.random.default_rng(shape[0])
    soft = rng.uniform(0, 1, shape).astype(np.float32)
    hard = (soft > 0.5).astype(np.float32)
    for m in (soft, hard):
        got = text_to_image.latent_mask(m, *size)
        assert got.shape == (1, 1) + size
        m2 = m[..., 0] if m.ndim == 3 else m
        ref = np.clip(np.asarray(jax.image.resize(jnp.asarray(m2), size, "linear")), 0, 1)
        np.testing.assert_allclose(got[0, 0].numpy(), ref, atol=1e-6)


def test_hires_fix_matches_jax(pipes, monkeypatch):
    """Base 64² render, 2x bilinear upscale, img2img at 128² (the guide resized per
    pass) against JAX hires_fix with its two keys' draws; then port-only: the target
    snaps to the UNet's 64-px grain and a second run is equal."""
    jpipe, pipe = pipes
    key = jax.random.PRNGKey(9)
    kw = dict(guide=make_guide(), height=64, width=64, scale=2.0, strength=0.5,
              num_inference_steps=4, return_array=True)
    ref = j_hires_fix(jpipe, "p", rng=key, **kw)[0]
    jax_draws(monkeypatch, *jax.random.split(key))
    out = hires_fix(pipe, "p", **kw)[0]
    err = float(np.abs(out - ref).max())
    assert out.shape == (128, 128, 3) and err <= ATOL, f"hires max|delta| {err}"
    monkeypatch.undo()
    a, b = (hires_fix(pipe, "p", generator=torch.Generator().manual_seed(4), **kw)[0]
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    odd = hires_fix(pipe, "p", **dict(kw, scale=1.4, guide=None))
    assert odd[0].shape == (64, 64, 3)


def test_img2img_rejects_conflicts(pipes):
    _, pipe = pipes
    img = init_image()
    with pytest.raises(ValueError, match="latents"):
        pipe("p", image=img, latents=np.zeros((1, 8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="image"):
        pipe("p", mask=np.ones((64, 64), np.float32))
    with pytest.raises(ValueError, match="num_images"):
        pipe("p", image=np.stack([img, img]), num_images=3, num_inference_steps=2)
