"""The trainer's fuller configuration in the port against the JAX package on the CPU:
UNet remat under the three policies, 8-bit AdamW, the resumable train state through
the CLI (bitwise resume, pruning, the run_meta seed rule, SIGTERM), and the VAE
latent cache.

Inputs come from a numpy seed; the smoke stacks and weights are those of
tests/test_torch_training.py. fp32 throughout; each test states its bound.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from controllora_tpu.data.fill50k import Fill50kSynthetic as JFill50k
from controllora_tpu.data.latent_cache import LatentCachedDataset as JLatentCache
from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.training import trainer as jtrainer
from controllora_tpu.utils.torch_compat import control_lora_to_torch
from controllora_tpu_torch import train as cli
from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
from controllora_tpu_torch.data.latent_cache import LatentCachedDataset
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.training import adam8bit
from controllora_tpu_torch.training import trainer as ttrainer
from controllora_tpu_torch.training.checkpoint import (
    checkpoint_step_dirs,
    load_control_lora,
    restore_train_state,
)
from test_torch_modules import assert_close, make_guides, nchw
from test_torch_training import controls, grad_enabled, stack  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------- remat


def _batch(seed=50):
    rng = np.random.default_rng(seed)
    return {"guide_values": make_guides(2),
            "input_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
            "latent_mean": rng.normal(size=(2, 16, 16, 4)).astype(np.float32),
            "latent_logvar": rng.uniform(-3, 0, (2, 16, 16, 4)).astype(np.float32)}


def _draws(key, b=2):
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    return dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (b, 16, 16, 4)))),
                noise=nchw(np.array(jax.random.normal(k_noise, (b, 16, 16, 4)))),
                timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (b,), 0, 1000))))


def test_remat_policies_match_no_remat_and_jax(stack, controls):  # noqa: F811
    """Loss and every adapter gradient with the UNet rematerialised under `nothing`,
    `dots` and `dots_all` equal the run without remat exactly (the recompute repeats
    the same ops), and equal jax.value_and_grad of the JAX loss with remat_unet=True
    (policy dots) within 1e-4 * max(1, max|ref|). The policies differ in what the
    backward recomputes: FlopCounterMode sees the forward projections (addmm) again
    only under `nothing`, and the batched attention products (bmm) again under both
    `nothing` and `dots`."""
    cl, params, port = controls["v1"]
    batch = _batch()
    key = jax.random.PRNGKey(11)
    jt = jtrainer.ControlLoRATrainer(cl, stack["unet"], stack["frozen"], vae=stack["vae"],
                                     text_encoder=stack["text"], remat_unet=True,
                                     remat_policy="dots")
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, stack["frozen"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ref = control_lora_to_torch(grads_ref, port.config)
    tbatch = ttrainer.to_device_batch(batch, "cpu")
    results, flops = {}, {}
    for policy in (None, "nothing", "dots", "dots_all"):
        tt = ttrainer.ControlLoRATrainer(port, stack["tu"], stack["tv"], stack["tc"],
                                         remat_unet=policy is not None,
                                         remat_policy=policy or "dots")
        loss = tt.loss(tbatch, **_draws(key))
        with FlopCounterMode(display=False) as counter:
            grads = tt.grads(loss)
        results[policy] = (loss.detach(), grads)
        flops[policy] = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    base_loss, base_grads = results[None]
    for policy in ("nothing", "dots", "dots_all"):
        loss, grads = results[policy]
        assert torch.equal(loss, base_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads)), policy
    names = [n for n, _ in port.named_parameters()]
    assert_close(results["dots"][0], np.asarray(loss_ref), "loss")
    for name, g in zip(names, results["dots"][1]):
        assert_close(g, ref[name], name)
    assert "aten.addmm" not in flops[None] and "aten.addmm" in flops["nothing"]
    assert "aten.addmm" not in flops["dots"] and "aten.addmm" not in flops["dots_all"]
    assert flops["dots"]["aten.bmm"] > flops[None]["aten.bmm"] == flops["dots_all"]["aten.bmm"]


# ---------------------------------------------------------------------------- 8-bit AdamW


def test_adam8bit_matches_jax():
    """Clip + 8-bit AdamW + schedule over 3 updates on seeded gradients (some clipped,
    some not), against the JAX make_optimizer(use_8bit=True): the int8 codes of both
    moments equal, their per-block scales and the params within 1e-6, and the fp32
    moments of the leaf under min_quantize_size within 1e-7. The leaves are laid out
    alike on both sides (1-D and 2-D), so the blocks hold the same elements."""
    shapes = {"big": (64, 100), "exact": (4096,), "small": (10, 3)}
    params = {k: np.random.default_rng(i).normal(size=s).astype(np.float32)
              for i, (k, s) in enumerate(shapes.items())}
    kw = dict(learning_rate=1e-2, max_grad_norm=1.0, lr_schedule="linear", total_steps=6,
              use_8bit=True)
    tx = jtrainer.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ttrainer.make_optimizer(tp.values(), **kw)
    assert isinstance(opt.adamw, adam8bit.AdamW8bit)
    for i in range(3):
        grads = {k: np.random.default_rng(100 + i).normal(size=s).astype(np.float32)
                 * (0.01 if i % 2 else 3.0) for k, s in shapes.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, updates)
        opt.step([torch.from_numpy(grads[k]) for k in tp])
    jstate = state[1][0]
    assert int(jstate.count) == 3
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        st = opt.adamw.state[p]
        assert float(st["step"]) == 3
        if k == "small":
            assert "exp_avg_q" not in st
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(jstate.mu[k]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jstate.nu[k]),
                                       rtol=0, atol=1e-7)
            continue
        for name, moment in (("exp_avg", jstate.mu[k]), ("exp_avg_sq", jstate.nu[k])):
            np.testing.assert_array_equal(st[f"{name}_q"].numpy(), np.asarray(moment.q))
            np.testing.assert_allclose(st[f"{name}_scale"].numpy(), np.asarray(moment.scale),
                                       rtol=1e-6, atol=0)
            assert st[f"{name}_q"].dtype == torch.int8


def test_adam8bit_quantize_round_trip():
    """Codes of the power maps: exact at 0 and at the block absmax, small entries keep
    a code (the reason for the power map), and the padding of the last block is 0."""
    x = torch.tensor([0.0, 1e-4, -0.5, 2.0] + [0.01] * 300)
    codes, scale = adam8bit.quantize(x, adam8bit.M_POWER)
    assert codes.shape == (2, 256) and scale.shape == (2, 1)
    # 127 * sqrt(0.25) = 63.5 rounds half to even, as jnp.round does
    assert codes[0, :4].tolist() == [0, 1, -64, 127] and codes[1, 48:].abs().sum() == 0
    back = adam8bit.dequantize(codes, scale, x.shape, adam8bit.M_POWER)
    assert back[3] == 2.0 and back[0] == 0.0 and abs(back[2] + 0.5) < 0.02


# ---------------------------------------------------------------------------- CLI state

# the warmup (3 steps) spans the resume point, and its length does not depend on
# --max_train_steps (a decaying schedule would differ between a 2- and a 4-step run)
SMOKE = ["--model_variant", "smoke", "--resolution", "64", "--train_batch_size", "2",
         "--log_every", "1", "--device", "cpu", "--use_8bit_adam", "--lr_scheduler",
         "constant_with_warmup", "--lr_warmup_steps", "3", "--learning_rate", "1e-3"]


def _adapters(path):
    model, _ = load_control_lora(str(path), device="cpu")
    return model.state_dict()


def test_cli_resume_is_bitwise(tmp_path, capsys):
    """4 steps straight against 2 steps, then --resume_from_checkpoint latest for 2
    more: the final adapters are bitwise equal (params, 8-bit moments, schedule,
    noise generator and the data stream's fast-forward all restored). The resumed run
    passes another --seed: the seed in run_meta.json wins. The straight run keeps
    checkpoints every step with --checkpoints_total_limit 2: only the newest two stay,
    and each holds the adapter artifact of its step."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    cli.main(SMOKE + ["--max_train_steps", "4", "--checkpointing_steps", "1",
                      "--checkpoints_total_limit", "2", "--output_dir", str(straight)])
    assert [s for s, _ in checkpoint_step_dirs(str(straight))] == [3, 4]
    state, at = restore_train_state(str(straight))
    assert at == 4 and state["step"] == 4
    last = _adapters(straight / "checkpoint-4" / "control_lora")
    cli.main(SMOKE + ["--max_train_steps", "2", "--checkpointing_steps", "2",
                      "--output_dir", str(split)])
    assert [s for s, _ in checkpoint_step_dirs(str(split))] == [2]
    capsys.readouterr()
    cli.main(SMOKE + ["--max_train_steps", "4", "--checkpointing_steps", "0",
                      "--resume_from_checkpoint", "latest", "--seed", "7",
                      "--output_dir", str(split)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "using the recorded seed" in out
    assert "step 1:" not in out and "step 3:" in out and "step 4:" in out
    a, b = _adapters(straight), _adapters(split)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], last[k]), k


def test_cli_sigterm_saves_and_exits_0(tmp_path):
    """SIGTERM during a run: the CLI finishes the step, writes checkpoint-<step>, says
    so and exits 0."""
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "controllora_tpu_torch.train", *SMOKE,
         "--max_train_steps", "10000", "--checkpointing_steps", "0",
         "--output_dir", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        line = ""
        while not line.startswith("step 1:") and time.time() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()[-2000:]
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    assert "received SIGTERM" in stdout and "preempted at step" in stdout
    steps = [s for s, _ in checkpoint_step_dirs(str(out))]
    assert len(steps) == 1 and steps[0] >= 1 and f"preempted at step {steps[0]}" in stdout
    assert not (out / "diffusion_pytorch_model.bin").exists()


@pytest.mark.parametrize("steps,traced", [(9, True), (8, False)])
def test_cli_profile_traces_steps_3_to_8(tmp_path, capsys, steps, traced):
    """--profile records steps start+3 to start+8 (scripts/train.py's window) into one
    trace under <output_dir>/profile, with the host spans of those steps beside it in
    spans.json (Chrome trace events); a run that ends before step start+8 writes
    neither. --no_remat parses and leaves remat off."""
    out = tmp_path / "run"
    args = SMOKE + ["--train_batch_size", "1", "--max_train_steps", str(steps),
                    "--checkpointing_steps", "0", "--profile", "--no_remat",
                    "--output_dir", str(out)]
    ns = cli.parse_args(args)
    assert ns.no_remat and not ns.gradient_checkpointing
    cli.main(args)
    said = capsys.readouterr().out
    traces = list((out / "profile").glob("*.pt.trace.json")) if traced else []
    assert (f"profiler trace written to {out}/profile" in said) == traced
    if traced:
        assert len(traces) == 1
        with open(traces[0]) as f:
            assert json.load(f)["traceEvents"]
        with open(out / "profile" / "spans.json") as f:
            events = json.load(f)["traceEvents"]
        steps_traced = [e for e in events if e["name"] == "train.step"]
        assert len(steps_traced) == 5 and all(e["ph"] == "X" for e in events)
        assert {"train.forward", "train.backward", "train.optimizer",
                "train.upload"} <= {e["name"] for e in events}
    else:
        assert not (out / "profile").exists()


# ---------------------------------------------------------------------------- latent cache


def test_latent_cache_matches_jax_and_files_interchange(stack, tmp_path):  # noqa: F811
    """Moments of a 4-item fill50k through the port's LatentCachedDataset against the
    JAX one on the same VAE weights (stored fp16 on both sides: within 2e-3 * max(1,
    max|ref|), a few fp16 ulps); a cache file written by either is read by the other
    without an encode (the reader gets no VAE); both refuse a dataset that is not
    deterministic."""
    ours = LatentCachedDataset(Fill50kSynthetic(HashTokenizer(), resolution=64, size=4),
                               stack["tv"], batch_size=3, cache_path=str(tmp_path / "t.npz"),
                               verbose=False)
    ref = JLatentCache(JFill50k(JHashTokenizer(), resolution=64, size=4), stack["vae"],
                       stack["frozen"]["vae"], batch_size=3,
                       cache_path=str(tmp_path / "j.npz"), verbose=False)
    assert ours.mean.shape == ref.mean.shape == (4, 8, 8, 4) and ours.mean.dtype == np.float16
    for name in ("mean", "logvar"):
        want = getattr(ref, name).astype(np.float32)
        err = np.abs(getattr(ours, name).astype(np.float32) - want).max()
        assert err <= 2e-3 * max(1.0, float(np.abs(want).max())), (name, err)
    item = ours[2]
    assert set(item) == {"latent_mean", "latent_logvar", "guide_values", "input_ids"}
    from_jax = LatentCachedDataset(Fill50kSynthetic(HashTokenizer(), resolution=64, size=4),
                                   None, cache_path=str(tmp_path / "j.npz"), verbose=False)
    np.testing.assert_array_equal(from_jax.mean, ref.mean)
    from_port = JLatentCache(JFill50k(JHashTokenizer(), resolution=64, size=4), None, None,
                             cache_path=str(tmp_path / "t.npz"), verbose=False)
    np.testing.assert_array_equal(from_port.logvar, ours.logvar)

    class Augmented(Fill50kSynthetic):
        name = ""  # not registered: process/fill50k stays the plain dataset
        deterministic = False

    with pytest.raises(ValueError, match="deterministic"):
        LatentCachedDataset(Augmented(HashTokenizer(), resolution=64, size=2), stack["tv"])
    with pytest.raises(ValueError, match="deterministic"):
        JLatentCache(Augmented(HashTokenizer(), resolution=64, size=2), None, None)


def test_cli_cache_latents_and_max_train_samples(tmp_path, capsys):
    """--cache_latents --max_train_samples 6 with remat: the cache covers the 6
    samples, is saved where --latent_cache_path says, and a second run loads it."""
    cache = tmp_path / "cache.npz"
    args = SMOKE + ["--max_train_steps", "2", "--checkpointing_steps", "0",
                    "--cache_latents", "--latent_cache_path", str(cache),
                    "--max_train_samples", "6", "--gradient_checkpointing",
                    "--remat_policy", "dots_all"]
    cli.main(args + ["--output_dir", str(tmp_path / "a")])
    with np.load(cache) as z:
        assert z["mean"].shape == (6, 8, 8, 4)
    capsys.readouterr()
    cli.main(args + ["--output_dir", str(tmp_path / "b")])
    assert "latent cache: loaded" in capsys.readouterr().err
    a, b = _adapters(tmp_path / "a"), _adapters(tmp_path / "b")
    assert all(torch.equal(a[k], b[k]) for k in a)
