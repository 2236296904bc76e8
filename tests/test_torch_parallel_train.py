"""The port's data-parallel training against the JAX package on the CPU, on 2 gloo
ranks (``tests/torch_parallel_workers.py``):

* one dp step of the smoke ControlLoRA trainer, each rank on its 2 rows of a global
  batch of 4 with the global draws injected (JAX's own key split), against
  ``jax.value_and_grad(ControlLoRATrainer._loss_fn)`` at the global batch: the
  reported loss and the all-reduced gradients, as ``__graft_entry__.py`` holds the
  JAX dp step to its 1-device step (loss rtol 1e-5; gradients rtol 2e-3, atol 5e-6);
  the parameters after the step equal on both ranks, bit for bit;
* the same for the DreamBooth trainer with prior preservation (each rank's batch is
  its instance rows, then its class rows): loss rtol 1e-5, gradients rtol 2e-3 and
  atol 5e-6, equal parameters;
* ``train.main`` on the 2 ranks for 2 steps at 64² (``--train_batch_size 2`` a rank):
  rank 0 alone writes, and its saved ControlLoRA equals a 1-process run's with
  ``--train_batch_size 4`` within 2e-5 (a tenth of the 2 steps' update at lr 1e-4;
  the gradients differ in summation order only, measured 3.8e-6); the same for
  ``train_dreambooth.main`` with prior preservation (batch 1 a rank against 2, the
  class images sampled by rank 0 alone).

Weights: the smoke stack and ControlLoRA of tests/test_torch_training.py (the port's
seeded init, translated into the JAX trees); the LoRAs of
tests/test_torch_dreambooth.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.training import trainer as jtrainer
from controllora_tpu.training.dreambooth import DreamBoothLoRATrainer as JDreamBooth
from controllora_tpu.utils import torch_compat
from controllora_tpu.utils.torch_compat import control_lora_to_torch
from controllora_tpu_torch import train, train_dreambooth
from controllora_tpu_torch.utils import convert
from test_torch_dreambooth import jax_loras, port_loras, write_png
from test_torch_modules import make_guides, nchw
from test_torch_training import controls, stack  # noqa: F401 (fixtures)
from torch_parallel_workers import Ranks

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, CLI_ATOL = 1e-5, 2e-3, 5e-6, 2e-5
N = 4  # the global batch


@pytest.fixture(autouse=True)
def grad_enabled():
    """Autograd on whatever the worker's state (see tests/test_torch_training.py):
    the 1-process CLI runs here train in this process."""
    with torch.enable_grad():
        yield


def jax_draws(key, n, hw):
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    return dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (n, hw, hw, 4)))),
                noise=nchw(np.array(jax.random.normal(k_noise, (n, hw, hw, 4)))),
                timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (n,), 0, 1000))))


def cli_argv(out, batch):
    return ["--model_variant", "smoke", "--resolution", "64", "--train_batch_size",
            str(batch), "--max_train_steps", "2", "--output_dir", out, "--device", "cpu",
            "--mixed_precision", "no", "--log_every", "1", "--checkpointing_steps", "2"]


def db_argv(root, out, batch):
    return ["--model_variant", "smoke", "--resolution", "64", "--instance_data_dir",
            str(root / "instance"), "--instance_prompt", "a sks toy",
            "--with_prior_preservation", "--class_prompt", "a toy", "--class_data_dir",
            str(root / f"class-{out}"), "--sample_class_images", "--num_class_images", "2",
            "--train_batch_size", str(batch), "--max_train_steps", "2",
            "--lr_warmup_steps", "0", "--checkpointing_steps", "0", "--mixed_precision",
            "no", "--output_dir", str(root / out), "--device", "cpu"]


@pytest.fixture(scope="module")
def run(stack, controls, tmp_path_factory):  # noqa: F811
    """(JAX references, each rank's results, the job's directory): the ranks run while
    this process computes the JAX side."""
    root = tmp_path_factory.mktemp("dp")
    (root / "instance").mkdir()
    for i in range(4):
        write_png(root / "instance" / f"{i}.png", i, 64, 64)
    cl, params, port = controls["v1"]
    rng = np.random.default_rng(40)
    batch = {"guide_values": make_guides(N),
             "input_ids": rng.integers(0, 49408, (N, 77)).astype(np.int32),
             "pixel_values": rng.uniform(-1, 1, (N, 128, 128, 3)).astype(np.float32)}
    db_batch = {"pixel_values": rng.uniform(-1, 1, (N, 64, 64, 3)).astype(np.float32),
                "input_ids": rng.integers(0, 49408, (N, 77)).astype(np.int32),
                "class_pixel_values": rng.uniform(-1, 1, (N, 64, 64, 3)).astype(np.float32),
                "class_input_ids": rng.integers(0, 49408, (N, 77)).astype(np.int32)}
    jad = jax_loras(4)
    key, db_key = jax.random.PRNGKey(7), jax.random.PRNGKey(9)
    blob = {"smoke": dict(unet=stack["tu"].state_dict(), vae=stack["tv"].state_dict(),
                          text=stack["tc"].state_dict(), control=port.state_dict(),
                          control_cfg=port.config)}
    job = dict(kind="train", stacks=blob, batch=batch, draws=jax_draws(key, N, 16),
               loras={name: a.params for name, a in port_loras(jad).items()},
               db_batch=db_batch, db_draws=jax_draws(db_key, 2 * N, 8),
               train_argv=cli_argv(str(root / "dp"), 2) + ["--dist_backend", "gloo"],
               db_argv=db_argv(root, "db-dp", 1) + ["--dist_backend", "gloo"])
    ranks = Ranks(2, str(root / "job"), job)

    jt = jtrainer.ControlLoRATrainer(cl, stack["unet"], stack["frozen"], vae=stack["vae"],
                                     text_encoder=stack["text"], remat_unet=False)
    loss, grads = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, stack["frozen"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jdb = JDreamBooth(stack["unet"], stack["frozen"], vae=stack["vae"],
                      text_encoder=stack["text"], rank=4, remat_unet=False,
                      with_prior_preservation=True, prior_loss_weight=0.7)
    jdb._specs = {k: a.spec for k, a in jad.items()}
    full = {"pixel_values": np.concatenate([db_batch["pixel_values"],
                                            db_batch["class_pixel_values"]]),
            "input_ids": np.concatenate([db_batch["input_ids"], db_batch["class_input_ids"]])}
    db_loss, db_grads = jax.jit(jax.value_and_grad(jdb._loss_fn))(
        {k: a.params for k, a in jad.items()}, stack["frozen"],
        {k: jnp.asarray(v) for k, v in full.items()}, db_key)
    refs = dict(loss=float(loss), grads=control_lora_to_torch(grads, port.config),
                db_loss=float(db_loss), loras=port_loras(jad),
                db_grads=torch_compat.attn_procs_to_torch(db_grads))
    return refs, ranks.results(), root


def close(name, got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"{name}: {bad.sum()} of {bad.size} outside rtol {rtol} atol " \
        f"{atol}; max|delta| {np.abs(got - want).max()}"


def test_dp_controllora_step_matches_jax_global_batch(run):
    refs, results, _ = run
    assert [r["coords"] for r in results] == [{"data": 0}, {"data": 1}]
    for res in results:
        out = res["control"]
        close("loss", out["loss"], refs["loss"], LOSS_RTOL, 0.0)
        assert set(out["grads"]) == set(refs["grads"])
        assert max(float(np.abs(v).max()) for v in refs["grads"].values()) > 0
        for name, g in out["grads"].items():
            close(name, g.numpy(), refs["grads"][name], GRAD_RTOL, GRAD_ATOL)


def test_dp_controllora_params_equal_across_ranks(run):
    _, results, _ = run
    a, b = (r["control"]["params"] for r in results)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any((a[k] != 0).any() for k in a)


def test_dp_dreambooth_step_matches_jax_global_batch(run):
    """Prior preservation under dp: rank r trains on instance rows 2r, 2r+1 and class
    rows 2r, 2r+1; the mean of the ranks' instance + 0.7 * class losses is the global
    loss, and the averaged gradient the global gradient."""
    refs, results, _ = run
    for res in results:
        out = res["dreambooth"]
        close("loss", out["loss"], refs["db_loss"], LOSS_RTOL, 0.0)
        it = iter(out["grads"])  # the trainer's order: processors, projections, factors
        got = convert.attn_procs_to_torch({
            name: {proj: {w: next(it) for w in pair} for proj, pair in a.params.items()}
            for name, a in refs["loras"].items()})
        names = list(refs["db_grads"])
        assert list(got) == names
        assert max(float(np.abs(v).max()) for v in refs["db_grads"].values()) > 0
        for k in names:
            close(k, got[k], refs["db_grads"][k], GRAD_RTOL, GRAD_ATOL)
    a, b = (r["dreambooth"]["params"] for r in results)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_cli_dp_equals_double_batch(run, tmp_path):
    """``train.main`` on 2 ranks x batch 2 against 1 process x batch 4: rank 0 alone
    wrote the run (metrics, checkpoint, artifact; run_meta records the global
    batch), and the saved ControlLoRAs agree."""
    _, _, root = run
    dp = root / "dp"
    assert json.loads((dp / "run_meta.json").read_text())["global_batch"] == 4
    assert (dp / "checkpoint-2").is_dir() and (dp / "README.md").exists()
    lines = (dp / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    train.main(cli_argv(str(tmp_path / "one"), 4))
    ours = convert.load_state_dict(str(dp / "diffusion_pytorch_model.bin"))
    ref = convert.load_state_dict(str(tmp_path / "one" / "diffusion_pytorch_model.bin"))
    assert set(ours) == set(ref)
    for k in ref:
        close(k, ours[k], ref[k], 0.0, CLI_ATOL)


def test_dreambooth_cli_dp_equals_double_batch(run):
    """``train_dreambooth.main`` with prior preservation on 2 ranks x batch 1 against
    1 process x batch 2: rank 0 alone sampled the 2 class images (the others waited at
    a barrier) and wrote the LoRA, which agrees with the 1-process run's."""
    _, _, root = run
    assert sorted(os.listdir(root / "class-db-dp")) == ["class-0.png", "class-1.png"]
    train_dreambooth.main(db_argv(root, "db-one", 2))
    name = "pytorch_lora_weights.safetensors"
    ours = convert.load_state_dict(str(root / "db-dp" / name))
    ref = convert.load_state_dict(str(root / "db-one" / name))
    assert list(ours) == list(ref)
    for k in ref:
        close(k, ours[k], ref[k], 0.0, CLI_ATOL)
