"""The port's training slice against the JAX package on the CPU: threaded adapter
chains, the threaded UNet, the VAE encoder, DDPM noising, one train step's loss and
adapter gradients, the optimizer and lr schedules, the artifact and the CLI.

Inputs come from a numpy seed; weights from the port's seeded init, carried into
the JAX trees by the torch_compat importers (cheaper here than compiling the JAX
inits); random draws from JAX's own keys (replayed as the JAX trainer splits them).
The JAX side runs jitted. Everything is fp32: the bound is
max|delta| <= 1e-4 * max(1, max|ref|) unless a test states another.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from controllora_tpu.models import lora as jlora
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.control_lora import ControlLoRA as JControlLoRA
from controllora_tpu.models.unet import CrossAttention as JCrossAttention
from controllora_tpu.schedulers import DDPMScheduler as JDDPM
from controllora_tpu.schedulers.common import DiffusionSchedule as JSchedule
from controllora_tpu.training import trainer as jtrainer
from controllora_tpu.utils.torch_compat import (
    control_lora_from_torch,
    control_lora_to_torch,
    translate_clip_text,
    translate_unet,
    translate_vae,
)
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import CrossAttention
from controllora_tpu_torch.ops.folding import fold_adapters
from controllora_tpu_torch.schedulers import DDPMScheduler
from controllora_tpu_torch.training import trainer as ttrainer
from controllora_tpu_torch.training.checkpoint import load_control_lora, save_control_lora
from controllora_tpu_torch.utils import convert
from test_torch_modules import CONTROLS, assert_close, make_guides, nchw, nhwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.7


@pytest.fixture(autouse=True)
def grad_enabled():
    """Autograd on for every test, whatever the process state: a test file run earlier
    in the same worker may have switched it off process-wide
    (scripts/dump_fixtures_torch.py does, through tests/test_parity_fixtures.py)."""
    with torch.enable_grad():
        yield


def rand(shape, seed, low=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, 1.0, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def numpy_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def stack():
    """The port's smoke stack (fp32, seeded) and the JAX stack with its weights."""
    tu, tv, tc = zoo.build_models("smoke", torch.float32, "cpu",
                                  torch.Generator().manual_seed(0))
    unet, vae, text = jzoo.build_models("smoke", dtype=jnp.float32)
    frozen = {"unet": translate_unet(numpy_sd(tu)), "vae": translate_vae(numpy_sd(tv)),
              "text": translate_clip_text(numpy_sd(tc))}
    return dict(unet=unet, vae=vae, text=text, frozen=frozen, tu=tu, tv=tv, tc=tc)


@pytest.fixture(scope="module")
def controls():
    """Per version: (JAX ControlLoRA, its params, the port), every port parameter
    +0.01 (fresh `up` factors are zero)."""
    out = {}
    for name, cfg in CONTROLS.items():
        port = zoo.build_control_lora(cfg, "cpu", generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            for p in port.parameters():
                p.add_(0.01)
        out[name] = (JControlLoRA(cfg), control_lora_from_torch(numpy_sd(port), cfg), port)
    return out


# ---------------------------------------------------------------------------- layers


def _adapter(kind, hidden, cross, seed, channels=12, **flags):
    """A JAX adapter (params +0.01, so `up` is nonzero) and its port twin; control
    adapters get a batch-1 control map of `channels` channels over 64 positions."""
    spec = jlora.AdapterSpec(kind=kind, **flags)
    control = rand((1, 64, channels), seed + 100) if spec.is_control else None
    params = jlora.init_adapter_params(jax.random.PRNGKey(seed), hidden, cross, 4, spec,
                                       control_rank=3, control_channels=channels)
    params = jax.tree.map(lambda x: x + 0.01, params)
    jad = jlora.AttnAdapter(params=params, control=None if control is None
                            else jnp.asarray(control), spec=spec)
    tad = tlora.AttnAdapter(params=to_t(params), spec=tlora.AdapterSpec(kind=kind, **flags),
                            control=None if control is None else torch.from_numpy(control))
    return jad, tad


V1 = dict(post_add=False, concat_hidden=False, control_self_add=False)
V2 = dict(concat_hidden=True, control_self_add=False, key_skipped=True, value_skipped=True)
STACKS = {
    "v1": lambda h, x: {"main": _adapter("control_v1", h, x, 1, **V1)},
    "v2": lambda h, x: {"main": _adapter("control_v2", h, x, 2, **V2)},
    "pre+v1+post": lambda h, x: {
        "pre": [_adapter("lora", h, x, 3)],
        "main": _adapter("control_v1", h, x, 4, channels=h, post_add=True,
                         concat_hidden=True, control_self_add=True),
        "post": [_adapter("lora", h, x, 5, post_add=True)]},
}


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("kind", list(STACKS))
def test_threaded_cross_attention(kind, cross):
    """One attention layer with a threaded AdapterStack (self and cross attention),
    lora_scale 0.7: covers the v1/v2 control math, the unscaled pre/post value LoRAs,
    post_add, concat_hidden and control self-add."""
    heads, dim_head, hidden = 2, 16, 32
    xdim = 24 if cross else None
    parts = STACKS[kind](hidden, xdim)
    j = lambda name: parts[name][0] if name in parts else None  # noqa: E731
    jstack = jlora.AdapterStack(main=j("main"), pre=tuple(a[0] for a in parts.get("pre", [])),
                                post=tuple(a[0] for a in parts.get("post", [])))
    tstack = tlora.AdapterStack(main=parts["main"][1],
                                pre=tuple(a[1] for a in parts.get("pre", [])),
                                post=tuple(a[1] for a in parts.get("post", [])))
    h = rand((2, 64, hidden), 10)
    ctx = rand((2, 77, xdim), 11) if cross else None
    layer = JCrossAttention(heads, dim_head, xdim)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(h), jctx, jstack, SCALE)["params"]
    ref = layer.apply({"params": params}, jnp.asarray(h), jctx, jstack, SCALE)
    port = CrossAttention(hidden, heads, dim_head, xdim)
    sd = {f"{n}.weight": np.asarray(params[n]["kernel"]).T for n in ("to_q", "to_k", "to_v")}
    sd["to_out.0.weight"] = np.asarray(params["to_out_0"]["kernel"]).T
    sd["to_out.0.bias"] = np.asarray(params["to_out_0"]["bias"])
    convert.load_numpy_state_dict(port, sd)
    with torch.no_grad():
        out = port(torch.from_numpy(h), None if ctx is None else torch.from_numpy(ctx),
                   tstack, SCALE)
    assert_close(out, ref, f"{kind} attention")


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_threaded_unet(stack, controls, version):
    """The threaded UNet against the JAX threaded UNet, and threaded == folded inside
    the port, at lora_scale 0.7 with per-image guides under the CFG batch."""
    cl, params, port = controls[version]
    g = make_guides(2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(4, 77, 768)).astype(np.float32)
    t = np.array([10, 300, 600, 900])
    jad = cl(params, jnp.asarray(g), jzoo.SMOKE_UNET)
    ref = jax.jit(stack["unet"].apply)({"params": stack["frozen"]["unet"]}, jnp.asarray(x),
                                       jnp.asarray(t), jnp.asarray(ctx), jad, SCALE)
    args = (nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        adapters = port.adapters_for(nchw(g), zoo.SMOKE_UNET)
        threaded = stack["tu"](*args, adapters=adapters, lora_scale=SCALE)
        weights, biases = fold_adapters(stack["tu"], adapters, SCALE)
        folded = functional_call(stack["tu"], weights, args, {"biases": biases})
    assert_close(nhwc(threaded), ref, "threaded unet")
    assert_close(folded, threaded, "folded vs threaded")
    with pytest.raises(ValueError, match="not both"):
        stack["tu"](*args, biases=biases, adapters=adapters)


def test_vae_encode(stack):
    """encode_moments, and encode with injected posterior noise (and the mean)."""
    px = rand((2, 64, 64, 3), 20, low=-1.0)
    noise = rand((2, 8, 8, 4), 21)
    vae, p = stack["vae"], {"params": stack["frozen"]["vae"]}
    ref_m, ref_lv = vae.apply(p, jnp.asarray(px), method=vae.encode_moments)
    with torch.no_grad():
        m, lv = stack["tv"].encode_moments(nchw(px))
        z = stack["tv"].encode(nchw(px), noise=nchw(noise))
        z_mean = stack["tv"].encode(nchw(px))
    assert_close(nhwc(m), ref_m, "mean")
    assert_close(nhwc(lv), ref_lv, "logvar")
    ref_z = np.asarray(ref_m) + np.exp(0.5 * np.asarray(ref_lv)) * noise
    assert_close(nhwc(z), ref_z * vae.config.scaling_factor, "sample")
    assert_close(nhwc(z_mean), np.asarray(ref_m) * vae.config.scaling_factor, "mean sample")


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddpm_training_math(prediction_type):
    x0, noise = rand((3, 8, 8, 4), 30), rand((3, 8, 8, 4), 31)
    t = np.array([0, 500, 999])
    js = JDDPM(JSchedule.create(prediction_type=prediction_type))
    from controllora_tpu_torch.schedulers.common import DiffusionSchedule

    ts = DDPMScheduler(DiffusionSchedule.create(prediction_type=prediction_type))
    targs = (torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    jargs = (jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    assert_close(ts.schedule.add_noise(*targs), js.add_noise(*jargs), "add_noise")
    assert_close(ts.schedule.get_velocity(*targs), js.get_velocity(*jargs), "velocity")
    assert_close(ts.training_target(*targs), js.training_target(*jargs), "target")
    acp = js.schedule.alphas_cumprod[t]
    assert_close(ts.schedule.snr(targs[2]), acp / (1.0 - acp), "snr")


# ---------------------------------------------------------------------------- step


@pytest.mark.parametrize("version,snr_gamma,prediction_type,source,adapter_bf16", [
    ("v1", None, "epsilon", "pixel_values", False),
    ("v2", 5.0, "v_prediction", "latent_moments", False),
    ("v1", None, "epsilon", "latent_moments", True),
])
def test_train_step_loss_and_grads(stack, controls, version, snr_gamma, prediction_type,
                                   source, adapter_bf16):
    """One step's loss and every adapter gradient against
    jax.value_and_grad(ControlLoRATrainer._loss_fn): v1 and v2, snr_gamma None and
    5.0, epsilon and v-prediction, latents from a VAE encode (posterior sample) or
    from cached moments; then DDPM noising, CLIP, hint encoder, threaded UNet. JAX's
    own draws are injected: the key split (sample, noise, t) as `_loss_fn` does it.

    adapter_bf16: both trainers cast the adapter factors and control maps to bf16
    (``adapter_compute_dtype``, --adapter_compute_bf16) over the fp32 stack. The two
    sides round the same products to bf16 in different summation orders, so the loss
    is held to 2e-6 relative and the concatenated gradient to 1.5e-3 relative L2
    (about 4e-7 and 7e-4 here); a port that skipped the cast would miss both bounds
    (about 5e-6 and 2.7e-3)."""
    cl, params, port = controls[version]
    rng = np.random.default_rng(40)
    batch = {"guide_values": make_guides(2),
             "input_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32)}
    if source == "pixel_values":
        batch["pixel_values"] = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    else:
        batch["latent_mean"] = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
        batch["latent_logvar"] = rng.uniform(-3, 0, (2, 16, 16, 4)).astype(np.float32)
    jt = jtrainer.ControlLoRATrainer(cl, stack["unet"], stack["frozen"], vae=stack["vae"],
                                     text_encoder=stack["text"], remat_unet=False,
                                     prediction_type=prediction_type, snr_gamma=snr_gamma,
                                     adapter_compute_dtype=jnp.bfloat16 if adapter_bf16
                                     else None)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, stack["frozen"], jbatch, key)
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    draws = dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (2, 16, 16, 4)))),
                 noise=nchw(np.array(jax.random.normal(k_noise, (2, 16, 16, 4)))),
                 timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000))))

    tt = ttrainer.ControlLoRATrainer(port, stack["tu"], stack["tv"], stack["tc"],
                                     remat_unet=False, prediction_type=prediction_type, snr_gamma=snr_gamma,
                                     adapter_compute_dtype=torch.bfloat16 if adapter_bf16
                                     else None)
    loss = tt.loss(ttrainer.to_device_batch(batch, "cpu"), **draws)
    grads = dict(zip([n for n, _ in port.named_parameters()], tt.grads(loss)))
    ref = control_lora_to_torch(grads_ref, port.config)
    assert set(ref) == set(grads)
    assert max(float(np.abs(v).max()) for v in ref.values()) > 0
    if adapter_bf16:
        loss_err = abs(loss.item() - float(loss_ref)) / abs(float(loss_ref))
        assert loss_err <= 2e-6, f"loss: relative {loss_err}"
        out = np.concatenate([g.detach().numpy().ravel() for g in grads.values()])
        want = np.concatenate([np.asarray(ref[n], np.float32).ravel() for n in grads])
        rel = float(np.linalg.norm(out - want) / np.linalg.norm(want))
        assert rel <= 1.5e-3, f"adapter gradient: relative L2 {rel}"
        return
    assert_close(loss.detach(), np.asarray(loss_ref), "loss")
    for name, g in grads.items():
        assert_close(g, ref[name], name)


def test_flash_route_train_step_matches_jax(stack, controls, monkeypatch):
    """One fp32 train step with every self-attention on the flash route, against the
    JAX step with its Pallas flash kernels (forward and backward) in interpret mode:
    the smoke stack's self-attentions at head dims 8, 16 and 24 (levels 0-2; L 256, 64
    and 16 at 128², padded to the JAX blocks and KV-masked there). The port runs its UNet with attention_backend="flash"
    (FlashAttention: on the CPU the plain K2 and K3/K4, whose fp32 route the card
    runs in csrc/flash_attn_fp32.cu); the JAX side takes _flash wherever q and kv have
    one length. Loss and every adapter gradient within 1e-4 * max(1, max|ref|)."""
    import functools

    from controllora_tpu.ops import attention as jattention
    from controllora_tpu.ops import pallas_attention_vjp as jvjp

    padded = jvjp.flash_attention_padded
    monkeypatch.setattr(jvjp, "flash_attention_padded",
                        lambda q, k, v, block_q=512, block_k=512, interpret=False:
                        padded(q, k, v, block_q, block_k, True))
    monkeypatch.setattr(jattention, "_use_flash", lambda q_len, kv_len, backend: q_len == kv_len)
    tu = stack["tu"]
    monkeypatch.setattr(tu, "forward", functools.partial(type(tu).forward, tu,
                                                         attention_backend="flash"))
    cl, params, port = controls["v1"]
    rng = np.random.default_rng(41)
    batch = {"guide_values": make_guides(2),
             "input_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
             "latent_mean": rng.normal(size=(2, 16, 16, 4)).astype(np.float32),
             "latent_logvar": rng.uniform(-3, 0, (2, 16, 16, 4)).astype(np.float32)}
    jt = jtrainer.ControlLoRATrainer(cl, stack["unet"], stack["frozen"], vae=stack["vae"],
                                     text_encoder=stack["text"], remat_unet=False)
    key = jax.random.PRNGKey(8)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, stack["frozen"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    draws = dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (2, 16, 16, 4)))),
                 noise=nchw(np.array(jax.random.normal(k_noise, (2, 16, 16, 4)))),
                 timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000))))
    tt = ttrainer.ControlLoRATrainer(port, tu, stack["tv"], stack["tc"], remat_unet=False)
    loss = tt.loss(ttrainer.to_device_batch(batch, "cpu"), **draws)
    grads = dict(zip([n for n, _ in port.named_parameters()], tt.grads(loss)))
    ref = control_lora_to_torch(grads_ref, port.config)
    assert max(float(np.abs(v).max()) for v in ref.values()) > 0
    assert_close(loss.detach(), np.asarray(loss_ref), "loss")
    for name, g in grads.items():
        assert_close(g, ref[name], name)


# ---------------------------------------------------------------------------- optimizer


@pytest.mark.parametrize("name", ttrainer.LR_SCHEDULES)
def test_lr_schedules(name):
    kw = dict(lr_schedule=name, warmup_steps=5, total_steps=40, num_cycles=3, power=2.0)
    ref = jtrainer.make_lr_schedule(3e-4, **kw)
    factor = ttrainer.make_lr_schedule(3e-4, **kw)
    for n in range(50):
        want = float(ref(n)) if callable(ref) else ref
        assert abs(3e-4 * factor(n) - want) <= 1e-6 * 3e-4, (name, n)


@pytest.mark.parametrize("accumulation", [1, 2])
def test_optimizer_matches_optax(accumulation):
    """Clip + AdamW (+ accumulation) over 3 updates with the same gradients: the
    params match optax's chain(clip_by_global_norm, adamw) within 1e-6. The gradient
    scale varies so that some updates clip and some do not."""
    shapes = {"a": (8, 4), "b": (4, 16), "c": (16,)}
    params = {k: rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    kw = dict(learning_rate=1e-2, max_grad_norm=1.0, lr_schedule="cosine", warmup_steps=1,
              total_steps=6, grad_accumulation_steps=accumulation)
    tx = jtrainer.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ttrainer.make_optimizer(tp.values(), **kw)
    for i in range(3 * accumulation):
        grads = {k: rand(s, 100 + i) * (0.05 if i % 2 else 3.0) for k, s in shapes.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        updated = opt.step([torch.from_numpy(grads[k]) for k in tp])
        assert updated == ((i + 1) % accumulation == 0)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_unported_options_raise():
    """What the port still refuses: unknown remat policies, and the SDXL refiner in
    the train CLI, which the JAX CLI does not train either. (text_time conditioning
    and column datasets train now: tests/test_torch_train_families.py and
    tests/test_torch_train_data.py.)"""
    with pytest.raises(ValueError, match="remat_policy"):
        ttrainer.ControlLoRATrainer(torch.nn.Linear(1, 1), None, remat_policy="offload")
    from controllora_tpu_torch import train as cli

    with pytest.raises(SystemExit):
        cli.parse_args(["--model_variant", "sdxl-refiner"])


# ---------------------------------------------------------------------------- artifact


def test_artifact_round_trip(controls, tmp_path):
    _, params, port = controls["v2"]
    save_control_lora(str(tmp_path), port)
    back, cfg = load_control_lora(str(tmp_path), device="cpu")
    assert cfg.to_dict() == port.config.to_dict()
    for (n, a), (m, b) in zip(port.state_dict().items(), back.state_dict().items()):
        assert n == m and torch.equal(a, b)


def _env():
    # a clean interpreter: the repo on the path and nothing else preloaded
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def test_train_cli_smoke_artifact_loads_in_jax(tmp_path):
    """Three steps of the port's CLI on the smoke stack; the artifact it writes loads
    into the JAX package's load_control_lora with the saved values."""
    from controllora_tpu.training.checkpoint import load_control_lora as j_load

    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "controllora_tpu_torch.train", "--model_variant", "smoke",
         "--resolution", "64", "--train_batch_size", "2", "--max_train_steps", "3",
         "--log_every", "1", "--output_dir", str(out), "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("step ") == 3 and "nan" not in proc.stdout
    jparams, cfg = j_load(str(out))
    port, _ = load_control_lora(str(out), device="cpu")
    ref = control_lora_to_torch(jparams, cfg)
    assert set(ref) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_train_module_imports_no_jax():
    code = ("import sys, controllora_tpu_torch.train, controllora_tpu_torch.training.trainer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
