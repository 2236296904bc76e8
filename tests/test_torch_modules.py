"""Module parity of the PyTorch port against the JAX package on the CPU.

The same seeded inputs (numpy) and the same weights (JAX init -> torch_compat
exporters -> strict load) go through each JAX module and its port. Everything runs
in fp32, so the only differences are summation order: the bound is
max|delta| <= 1e-4 * max(1, max|ref|) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from controllora_tpu.config import ControlLoRAConfig
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.control_lora import ControlLoRA as JControlLoRA
from controllora_tpu.models.unet import derive_cross_attention_dims
from controllora_tpu.ops.folding import fold_adapters as j_fold_adapters
from controllora_tpu.schedulers.dpmsolver import DPMSolverMultistepScheduler as JDPM
from controllora_tpu.utils.torch_compat import control_lora_to_torch, flax_to_torch_unet
from controllora_tpu_torch.models import unet as t_unet
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.control_lora import adapter_spec_for
from controllora_tpu_torch.ops.folding import fold_adapters
from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
from controllora_tpu_torch.utils import convert

_TINY = dict(
    block_out_channels=(8, 16, 16, 32),
    lora_block_in_channels=(32, 32, 32, 32),
    lora_block_out_channels=(32, 64, 96, 96),
    lora_cross_attention_dims=derive_cross_attention_dims(jzoo.SMOKE_UNET),
)
TINY_CONTROL = ControlLoRAConfig(**_TINY)  # v1, the `base` preset's math
TINY_CONTROL_V2 = ControlLoRAConfig(
    **_TINY, lora_control_version=2, lora_concat_hidden=True,
    lora_control_self_add=False, lora_key_states_skipped=True,
    lora_value_states_skipped=True, lora_pre_conv_skipped=True,
)
CONTROLS = {"v1": TINY_CONTROL, "v2": TINY_CONTROL_V2}


def assert_close(out, ref, what=""):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max|delta| {err} > {bound}"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def stack():
    """JAX smoke stack (fp32) and its port with the same weights."""
    unet, vae, text = jzoo.build_models("smoke", dtype=jnp.float32)
    frozen = jzoo.random_frozen(jax.random.PRNGKey(0), unet, vae, text,
                                latent_size=8, param_dtype=jnp.float32)
    tu, tv, tc = zoo.build_models("smoke", dtype=torch.float32, device="cpu")
    convert.load_unet(tu, frozen["unet"])
    convert.load_vae(tv, frozen["vae"])
    convert.load_clip(tc, frozen["text"])
    return dict(unet=unet, vae=vae, text=text, frozen=frozen, tu=tu, tv=tv, tc=tc)


@pytest.fixture(scope="module")
def controls():
    """Per version: (JAX ControlLoRA, its params perturbed by +0.01, the port)."""
    out = {}
    for name, cfg in CONTROLS.items():
        cl = JControlLoRA(cfg)
        # fresh adapters have zero `up` factors; perturb so every bias is nonzero
        params = jax.tree.map(lambda x: x + 0.01, cl.init(jax.random.PRNGKey(1),
                                                          image_size=64))
        port = convert.load_control_lora(
            zoo.build_control_lora(cfg, "cpu", generator=torch.Generator().manual_seed(0)),
            params)
        out[name] = (cl, params, port)
    return out


def make_guides(n):
    """128² guides: at 64² the deepest hint stage normalises groups of 4 values of
    one channel, which is ill-conditioned in fp32 for either implementation (both
    stray ~3e-3 from a float64 run there), not a port error."""
    rng = np.random.default_rng(7)
    return rng.uniform(-1, 1, size=(n, 128, 128, 3)).astype(np.float32)


def test_unet_adapter_free(stack):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 768)).astype(np.float32)
    t = np.array([10, 500])
    ref = stack["unet"].apply({"params": stack["frozen"]["unet"]}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = stack["tu"](nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert_close(nhwc(out), ref, "unet")


def test_clip_text_encoder(stack):
    ids = np.random.default_rng(1).integers(0, 49408, (2, 77)).astype(np.int32)
    ref = stack["text"].apply({"params": stack["frozen"]["text"]}, jnp.asarray(ids))
    with torch.no_grad():
        out = stack["tc"](torch.from_numpy(ids).long())
    assert_close(out, ref, "clip")


@pytest.mark.parametrize("batch", [1, 2])
def test_vae_decode(stack, batch):
    z = np.random.default_rng(2).normal(size=(batch, 8, 8, 4)).astype(np.float32)
    vae = stack["vae"]
    ref = vae.apply({"params": stack["frozen"]["vae"]}, jnp.asarray(z), method=vae.decode)
    with torch.no_grad():
        out = stack["tv"].decode(nchw(z))
    assert_close(nhwc(out), ref, "vae decode")


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_hint_encoder(controls, version):
    cl, params, port = controls[version]
    g = make_guides(2)
    refs = cl.apply(params, jnp.asarray(g))
    with torch.no_grad():
        outs = port.apply(nchw(g))
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == torch.float32
        assert_close(o, r, f"control bucket {i}")


def _fold_both(stack, controls, version, n_guides):
    cl, params, port = controls[version]
    g = make_guides(n_guides)
    jw, jb = j_fold_adapters(stack["frozen"]["unet"],
                             cl(params, jnp.asarray(g), jzoo.SMOKE_UNET), 0.7)
    with torch.no_grad():
        tw, tb = fold_adapters(stack["tu"], port.adapters_for(nchw(g), zoo.SMOKE_UNET),
                               0.7)
    return jw, jb, tw, tb


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_fold_adapters(stack, controls, version):
    """Folded weights (through the diffusers export) and every FoldedBias field."""
    jw, jb, tw, tb = _fold_both(stack, controls, version, 1)
    ref_sd = flax_to_torch_unet(jw)
    assert tw, "nothing folded"
    for key, w in tw.items():
        assert_close(w, ref_sd[key], key)
    unchanged = flax_to_torch_unet(stack["frozen"]["unet"])
    changed = {k for k in ref_sd if not np.array_equal(ref_sd[k], unchanged[k])}
    assert changed == set(tw)
    assert set(tb) == set(jb)
    for name in jb:
        for field in ("q_bias", "k_bias", "v_bias", "out_bias"):
            r, o = getattr(jb[name], field), getattr(tb[name], field)
            assert (r is None) == (o is None), (name, field)
            if r is not None:
                assert float(np.abs(np.asarray(r)).max()) > 0, (name, field)
                assert_close(o, r, f"{name}.{field}")


@pytest.mark.parametrize("version,n_guides", [("v1", 1), ("v1", 2), ("v2", 2)])
def test_folded_unet(stack, controls, version, n_guides):
    """Folded UNet eval on the CFG batch 2n: batch-1 biases broadcast, per-image
    biases tile to [uncond || cond]."""
    jw, jb, tw, tb = _fold_both(stack, controls, version, n_guides)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2 * n_guides, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2 * n_guides, 77, 768)).astype(np.float32)
    t = np.full((2 * n_guides,), 300)
    ref = stack["unet"].apply({"params": jw}, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), jb)
    with torch.no_grad():
        out = functional_call(stack["tu"], tw, (nchw(x), torch.from_numpy(t),
                                                torch.from_numpy(ctx)), {"biases": tb})
    assert_close(nhwc(out), ref, "folded unet")


def test_dpm_tables_and_steps():
    rng = np.random.default_rng(4)
    jd, td = JDPM(), DPMSolverMultistepScheduler()
    for a, b in zip(jd.tables(20), td.tables(20)):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    js, ts = jd.init_state(jnp.asarray(x)), td.init_state(torch.from_numpy(x))
    tables = jd.tables(3)
    td.set_timesteps(3)
    for i in range(3):
        eps = rng.normal(size=x.shape).astype(np.float32)
        js = jd.step(js, jnp.asarray(eps), jnp.int32(i), 3, tables)
        ts = td.step(ts, torch.from_numpy(eps), i)
        assert_close(ts.sample, js.sample, f"step {i}")


def test_conversion_round_trip_strict(stack, controls):
    """Loaded weights export back to the same diffusers keys and values, and a
    missing key fails the strict load."""
    ref = flax_to_torch_unet(stack["frozen"]["unet"])
    sd = stack["tu"].state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    _, params, port = controls["v1"]
    ref = control_lora_to_torch(params, TINY_CONTROL)
    assert set(port.state_dict()) == set(ref)
    bad = dict(ref)
    bad.pop(next(iter(bad)))
    fresh = zoo.build_control_lora(TINY_CONTROL, "cpu", generator=torch.Generator())
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.load_numpy_state_dict(fresh, bad)


def test_name_tables_match():
    from controllora_tpu.models import unet as j_unet

    for cfg in (jzoo.SMOKE_UNET, j_unet.UNetConfig()):
        tcfg = t_unet.UNetConfig(**{f: getattr(cfg, f) for f in (
            "block_out_channels", "layers_per_block", "attention_head_dim")})
        names = t_unet.attention_processor_names(tcfg)
        assert names == j_unet.attention_processor_names(cfg)
        assert t_unet.derive_cross_attention_dims(tcfg) == \
            j_unet.derive_cross_attention_dims(cfg)
        for n in names:
            assert t_unet.processor_hidden_size(n, tcfg) == \
                j_unet.processor_hidden_size(n, cfg)
            assert t_unet.processor_bucket(n, 4) == j_unet.processor_bucket(n, 4)


def test_adapter_spec_pins_self_add_off():
    spec = adapter_spec_for(ControlLoRAConfig(lora_control_self_add=True), 0)
    assert spec.kind == "control_v1" and not spec.control_self_add
