"""The port's training of the other model families against the JAX package on the
CPU: one ControlLoRA train step of ``smoke2`` (SD2.1-shaped, v-prediction) and of
``smokexl`` (SDXL-shaped: dual text towers, ``text_time`` size ids), the shared text
conditioning, and the train CLI on those variants with validation on.

Weights and inputs as tests/test_torch_families.py makes them (numpy fills of the
JAX trees, carried into the port by ``utils/convert.py``); the JAX trainer's own
draws (posterior sample, noise, t) are injected as tests/test_torch_training.py
does. Everything is fp32: the loss is held to 2e-6 relative, the concatenated
adapter gradient to 1.5e-3 relative L2, the conditioning to 1e-4 * max(1, max|ref|).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.data.tokenizer import HashTokenizer
from controllora_tpu.training import trainer as jtrainer
from controllora_tpu.training.conditioning import (
    resolve_text_conditioning as j_resolve_text_conditioning,
)
from controllora_tpu.utils.torch_compat import control_lora_to_torch
from controllora_tpu_torch import train as cli
from controllora_tpu_torch.training import trainer as ttrainer
from controllora_tpu_torch.training.conditioning import resolve_text_conditioning
from controllora_tpu_torch.utils.png import decode_png
from controllora_tpu.models import zoo as jzoo
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.utils import convert
from test_torch_families import controls, filled  # noqa: F401 (controls: a fixture)
from test_torch_modules import assert_close, make_guides, nchw

LOSS_REL, GRAD_REL = 2e-6, 1.5e-3


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file: the suite runs several workers on the host's
    cores, and this file's many small CPU ops, spread over every core, contend with
    the other workers' and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Autograd on whatever the worker's state (see tests/test_torch_training.py)."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def stacks():
    """test_torch_families.py's stacks, for the two families trained here."""
    out = {}
    for variant in ("smoke2", "smokexl"):
        unet, vae, text = jzoo.build_models(variant, dtype=jnp.float32)
        frozen = filled(jax.eval_shape(lambda: jzoo.random_frozen(
            jax.random.PRNGKey(0), unet, vae, text, latent_size=8,
            param_dtype=jnp.float32)), 0)
        tu, tv, tc = zoo.build_models(variant, torch.float32, "cpu")
        convert.load_unet(tu, frozen["unet"])
        convert.load_vae(tv, frozen["vae"])
        convert.load_clip(tc, frozen["text"])
        out[variant] = dict(unet=unet, vae=vae, text=text, frozen=frozen, tu=tu, tv=tv, tc=tc)
    return out


def batch_for(variant, source):
    """A batch of 2 at 128² (guides) / 16² latents: ids (and tower 2's 0-padded ids
    for the dual encoder), and pixels or cached VAE moments."""
    rng = np.random.default_rng(40)
    tok = HashTokenizer()
    texts = ["a red circle", "a blue square on green"]
    batch = {"guide_values": make_guides(2), "input_ids": tok(texts).astype(np.int32)}
    if variant == "smokexl":
        batch["input_ids2"] = tok(texts, pad_id=0).astype(np.int32)
    if source == "pixel_values":
        batch["pixel_values"] = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    else:
        batch["latent_mean"] = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
        batch["latent_logvar"] = rng.uniform(-3, 0, (2, 16, 16, 4)).astype(np.float32)
    return batch


@pytest.mark.parametrize("variant,prediction_type,snr_gamma,source", [
    ("smoke2", "v_prediction", 5.0, "pixel_values"),
    ("smokexl", "epsilon", None, "latent_moments"),
])
def test_family_train_step_matches_jax(stacks, controls, variant, prediction_type,  # noqa: F811
                                       snr_gamma, source):
    """One step's loss and every adapter gradient against
    jax.value_and_grad(ControlLoRATrainer._loss_fn): SD2.1-shaped v-prediction with
    min-SNR weighting through a VAE encode; SDXL-shaped text_time with the dual
    towers (ids and tower 2's ids) and the default size ids, from cached moments."""
    s = stacks[variant]
    jcl, params, port = controls[variant]
    batch = batch_for(variant, source)
    jt = jtrainer.ControlLoRATrainer(jcl, s["unet"], s["frozen"], vae=s["vae"],
                                     text_encoder=s["text"], remat_unet=False,
                                     prediction_type=prediction_type, snr_gamma=snr_gamma)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, s["frozen"], jbatch, key)
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    draws = dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (2, 16, 16, 4)))),
                 noise=nchw(np.array(jax.random.normal(k_noise, (2, 16, 16, 4)))),
                 timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000))))
    tt = ttrainer.ControlLoRATrainer(port, s["tu"], s["tv"], s["tc"], remat_unet=False,
                                     prediction_type=prediction_type, snr_gamma=snr_gamma)
    loss = tt.loss(ttrainer.to_device_batch(batch, "cpu"), **draws)
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, tt.grads(loss)))
    ref = control_lora_to_torch(grads_ref, port.config)
    assert set(ref) == set(grads)
    loss_err = abs(loss.item() - float(loss_ref)) / abs(float(loss_ref))
    assert loss_err <= LOSS_REL, f"loss: relative {loss_err}"
    out = np.concatenate([grads[n].detach().numpy().ravel() for n in names])
    want = np.concatenate([np.asarray(ref[n], np.float32).ravel() for n in names])
    assert np.linalg.norm(want) > 0
    rel = float(np.linalg.norm(out - want) / np.linalg.norm(want))
    assert rel <= GRAD_REL, f"adapter gradient: relative L2 {rel}"


@pytest.mark.parametrize("case", ["ids, default time_ids", "ids2, given time_ids",
                                  "precomputed", "smoke2"])
def test_resolve_text_conditioning_matches_jax(stacks, case):  # noqa: F811
    """(context, added kwargs) against the JAX resolver: the dual tower's (ctx,
    pooled) from one id set or two, size ids from the batch or (res, res, 0, 0, res,
    res) from the latents, precomputed context + pooled; a UNet without text_time
    gets no added kwargs. A text_time UNet without a pooled vector raises the JAX
    package's ValueError."""
    variant = "smoke2" if case == "smoke2" else "smokexl"
    s = stacks[variant]
    rng = np.random.default_rng(1)
    tok = HashTokenizer()
    latents = rng.normal(size=(2, 12, 10, 4)).astype(np.float32)
    batch = {"input_ids": tok(["a", "b c"]).astype(np.int32)}
    if case == "ids2, given time_ids":
        batch["input_ids2"] = tok(["a", "b c"], pad_id=0).astype(np.int32)
        batch["time_ids"] = rng.uniform(0, 512, (2, 6)).astype(np.float32)
    if case == "precomputed":
        batch = {"encoder_hidden_states": rng.normal(size=(2, 77, 64)).astype(np.float32),
                 "pooled_text_embeds": rng.normal(size=(2, 32)).astype(np.float32)}
    ref_ctx, ref_added = j_resolve_text_conditioning(
        {k: jnp.asarray(v) for k, v in batch.items()}, s["text"], s["frozen"]["text"],
        s["unet"].config, jnp.asarray(latents))
    tbatch = ttrainer.to_device_batch(batch, "cpu")
    with torch.no_grad():
        ctx, added = resolve_text_conditioning(tbatch, s["tc"], s["tu"].config,
                                               nchw(latents))
    assert_close(ctx, ref_ctx, "context")
    assert set(added) == set(ref_added) == (set() if variant == "smoke2" else
                                            {"added_text_embeds", "added_time_ids"})
    for k in added:
        assert_close(added[k], ref_added[k], k)
    if case == "ids, default time_ids":
        np.testing.assert_array_equal(added["added_time_ids"][0].numpy(),
                                      [96, 80, 0, 0, 96, 80])
    if case == "precomputed":
        del tbatch["pooled_text_embeds"]
        with pytest.raises(ValueError, match="pooled_text_embeds"):
            resolve_text_conditioning(tbatch, s["tc"], s["tu"].config, nchw(latents))


def test_train_cli_sdxl_family_with_validation(tmp_path, capsys):
    """The CLI trains the SDXL-shaped smoke stack (text_time, dual towers, the
    ControlLoRA re-derived: an adapter-free level 0) for 3 steps on the native data
    plane, logs every step to metrics.jsonl and renders the validation montage
    (image | guide | sample) at step 2."""
    out = tmp_path / "run"
    cli.main(["--model_variant", "smokexl", "--resolution", "64", "--train_batch_size",
              "2", "--max_train_steps", "3", "--log_every", "1", "--validation_steps", "2",
              "--validation_prompt", "a red circle", "--checkpointing_steps", "0",
              "--output_dir", str(out), "--device", "cpu"])
    stdout = capsys.readouterr().out
    assert "data plane: native fastloader" in stdout and "nan" not in stdout
    assert "validation image at step 2" in stdout
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2, 3]
    img = decode_png((out / "images" / "validation-2.png").read_bytes())
    assert img.shape == (64, 192, 3) and img.std() > 0
    assert (out / "diffusion_pytorch_model.bin").exists()

