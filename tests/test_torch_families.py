"""The port's SD2.1, SDXL and SDXL-refiner families against the JAX package on the CPU.

The configurations equal the JAX ones field by field, and so do the processor
inventories (140 processors for SDXL). At smoke widths (``smoke2``, ``smokexl``,
``smokeref``) the same weights (JAX init -> ``utils/convert.py``) and the same numpy
inputs go through each JAX module and its port in fp32: the UNet forwards with
``text_time`` (6 and 5 ids) and Linear projections, the gelu, penultimate and
projection towers and the dual encoder (tower 2 with its 0-padded ids), to 1e-4
relative L2 (and the UNet's ``attention_backend`` reaches each of its attentions); the folded weights and biases of ``smokexl`` (an adapter-free bucket, a
depth-weighted layout) to the JAX ``fold_adapters`` within 1e-4 * max(1, max|ref|).
A 2-step guided 64² render of ``smoke2`` (v-prediction DPM-Solver++) and of
``smokexl`` matches the JAX pipeline to atol 2e-3 on the [-1, 1] image, as
test_torch_pipeline.py holds SD1.5's; the engine's batch of per-image prompts on
``smokexl`` equals each render alone.

The JAX parameter trees take their shapes from ``jax.eval_shape`` of the JAX inits
and their values from a numpy generator (``filled``): every leaf random, biases and
adapter ``up`` factors included, and no init program to compile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.config import ControlLoRAConfig as JControlLoRAConfig
from controllora_tpu.data.tokenizer import HashTokenizer
from controllora_tpu.models import unet as junet
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.control_lora import ControlLoRA as JControlLoRA
from controllora_tpu.ops.folding import fold_adapters as j_fold_adapters
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu.schedulers import DPMSolverMultistepScheduler as JDPM
from controllora_tpu.schedulers.common import DiffusionSchedule as JSchedule
from controllora_tpu.utils import torch_compat
from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.models import unet as tunet
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.control_lora import config_for_unet
from controllora_tpu_torch.ops import flash_attention as fa
from controllora_tpu_torch.ops.folding import fold_adapters
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
from controllora_tpu_torch.schedulers.common import DiffusionSchedule
from controllora_tpu_torch.serving import BatchingEngine
from controllora_tpu_torch.utils import convert

CONFIGS = ("SD21_UNET", "SD21_CLIP", "SMOKE2_UNET", "SMOKE2_CLIP", "SDXL_UNET",
           "SDXL_CLIP1", "SDXL_CLIP2", "SDXL_VAE", "SMOKEXL_UNET", "SMOKEXL_CLIP1",
           "SMOKEXL_CLIP2", "SDXL_REFINER_UNET", "SMOKEREF_UNET")
# diffusers' parameter counts of the published UNets
UNET_PARAMS = {"sd15": 859_520_964, "sd21": 865_910_724, "sdxl": 2_567_463_684}
# a 4-stage hint pyramid (/8, the latent grid) with per-family buckets; the JAX
# SDXL tests' hint encoder
HINT = dict(block_out_channels=(8, 8, 16, 16), norm_num_groups=8,
            lora_block_in_channels=(16, 16, 16, 16))


def filled(shapes, seed):
    """A parameter tree of the given shapes with seeded numpy values: kernels and
    LoRA ``down`` factors N(0, 1/fan_in), ``up`` factors a tenth of that, embeddings
    N(0, 1/width), norm scales 1 + N(0, 0.01), biases N(0, 0.0025)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        z = rng.standard_normal(shape).astype(np.float32)
        if name in ("kernel", "down"):
            return z * np.prod(shape[:-1]) ** -0.5
        if name == "up":
            return 0.1 * z * shape[0] ** -0.5
        if name == "embedding":
            return z * shape[-1] ** -0.5
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "bias":
            return 0.05 * z
        raise KeyError(jax.tree_util.keystr(path))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_equal_jax(name):
    ours, ref = getattr(zoo, name), getattr(jzoo, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref), name


@pytest.mark.parametrize("variant,count", [("sd21", 32), ("sdxl", 140), ("sdxl-refiner", 88)])
def test_processor_names_equal_jax(variant, count):
    cfg = zoo.VARIANTS[variant][0]
    jcfg = {"sd21": jzoo.SD21_UNET, "sdxl": jzoo.SDXL_UNET,
            "sdxl-refiner": jzoo.SDXL_REFINER_UNET}[variant]
    names = tunet.attention_processor_names(cfg)
    assert names == junet.attention_processor_names(jcfg) and len(names) == count
    assert tunet.derive_cross_attention_dims(cfg) == junet.derive_cross_attention_dims(jcfg)


def test_build_models_builds_every_variant():
    """All eight variants build (on the meta device: shapes only), with diffusers'
    parameter counts for the published UNets and every parameter of the new modules
    (Linear projections, add_embedding, text_projection, both towers) seeded."""
    assert sorted(zoo.VARIANTS) == sorted(["sd15", "sd21", "sdxl", "sdxl-refiner", "smoke",
                                           "smoke2", "smokexl", "smokeref"])
    for variant in zoo.VARIANTS:
        unet, vae, text = zoo.build_models(variant, torch.bfloat16, "meta")
        n = sum(p.numel() for p in unet.parameters())
        assert n == UNET_PARAMS.get(variant, n), (variant, n)
        dual = isinstance(zoo.VARIANTS[variant][2], tuple)
        assert hasattr(text, "te2") == dual
        if unet.config.addition_embed_type:
            assert unet.add_embedding.linear_1.in_features == \
                unet.config.projection_class_embeddings_input_dim
    assert zoo.SDXL_VAE.scaling_factor == 0.13025
    unet, _, text = zoo.build_models("smokexl", torch.float32, "cpu",
                                     torch.Generator().manual_seed(0))
    for name, p in list(unet.named_parameters()) + list(text.named_parameters()):
        if p.dim() >= 2:
            assert p.abs().sum() > 0, name


def build_stacks(variants):
    """Per smoke variant: the JAX modules, their fp32 random frozen tree, and the
    port's modules loaded from it."""
    out = {}
    for variant in variants:
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


@pytest.fixture(scope="module")
def stacks():
    return build_stacks(("smoke2", "smokexl", "smokeref"))


def added_inputs(unet_config, pooled_dim, b, rng):
    """Pooled text and size ids for a text_time UNet: 6 ids (SDXL), 5 (refiner)."""
    n_ids = ((unet_config.projection_class_embeddings_input_dim - pooled_dim)
             // unet_config.addition_time_embed_dim)
    pooled = (0.5 * rng.normal(size=(b, pooled_dim))).astype(np.float32)
    ids = [64.0, 64.0, 0.0, 0.0] + ([64.0, 64.0] if n_ids == 6 else [6.0])
    return pooled, np.tile(np.array([ids], np.float32), (b, 1))


@pytest.mark.parametrize("variant", ["smoke2", "smokexl", "smokeref"])
def test_unet_forward_matches_jax(stacks, variant, monkeypatch):
    s = stacks[variant]
    cfg = s["tu"].config
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([10, 500])
    jkw, kw = {}, {}
    if cfg.addition_embed_type == "text_time":
        pooled, ids = added_inputs(cfg, 32, 2, rng)
        jkw = dict(added_text_embeds=jnp.asarray(pooled), added_time_ids=jnp.asarray(ids))
        kw = dict(added_text_embeds=torch.from_numpy(pooled),
                  added_time_ids=torch.from_numpy(ids))
    ref = jax.jit(s["unet"].apply)({"params": s["frozen"]["unet"]}, jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(ctx), **jkw)
    with torch.no_grad():
        out = s["tu"](nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), **kw)
        err = rel_l2(out.permute(0, 2, 3, 1).numpy(), ref)
        assert err <= 1e-4, f"{variant}: relative L2 {err}"
        # attention_backend reaches every attention: "flash" takes K2's wrapper,
        # whose CPU branch is the plain version
        calls = []
        plain = fa.flash_attention
        monkeypatch.setattr(fa, "flash_attention", lambda *a: calls.append(1) or plain(*a))
        routed = s["tu"](nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         attention_backend="flash", **kw)
        assert len(calls) == len(tunet.attention_processor_names(cfg))
        assert rel_l2(routed.numpy(), out.numpy()) <= 1e-5
        if kw:
            # a width mismatch fails loudly; so does a missing conditioning
            with pytest.raises(ValueError, match="projection_class_embeddings_input_dim"):
                s["tu"](nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        added_text_embeds=kw["added_text_embeds"][:, :-1],
                        added_time_ids=kw["added_time_ids"])
            with pytest.raises(ValueError, match="text_time"):
                s["tu"](nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))


@pytest.mark.parametrize("variant", ["smoke2", "smokexl", "smokeref"])
def test_text_towers_match_jax(stacks, variant):
    """smoke2: a gelu tower; smokeref: penultimate + projection, (ctx, pooled);
    smokexl: the dual encoder with tower 2's 0-padded ids (the pad positions reach
    the context, the EOS-pooled vector does not see them)."""
    s = stacks[variant]
    tok = HashTokenizer()
    texts = ["a red square on blue", ""]
    ids, ids2 = tok(texts), tok(texts, pad_id=0)
    args = (ids, ids2) if variant == "smokexl" else (ids,)
    ref = jax.jit(s["text"].apply)({"params": s["frozen"]["text"]}, *map(jnp.asarray, args))
    with torch.no_grad():
        out = s["tc"](*(torch.from_numpy(a).long() for a in args))
    ref, out = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
    assert len(out) == len(ref) == (1 if variant == "smoke2" else 2)
    for o, r in zip(out, ref):
        assert rel_l2(o.numpy(), r) <= 1e-4
    if variant == "smokexl":
        with torch.no_grad():
            shared = s["tc"](torch.from_numpy(ids).long())
        assert (shared[0][..., 32:] - out[0][..., 32:]).abs().max() > 1e-6
        torch.testing.assert_close(shared[1], out[1], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def controls(stacks):
    """Per smoke2 and smokexl: (JAX ControlLoRA, its params, the port's) with the
    hint encoder HINT and buckets re-derived for the UNet."""
    out = {}
    for seed, variant in enumerate(("smoke2", "smokexl"), 3):
        cfg = config_for_unet(ControlLoRAConfig(**HINT), stacks[variant]["tu"].config)
        jcl = JControlLoRA(JControlLoRAConfig.from_dict(cfg.to_dict()))
        params = filled(jax.eval_shape(lambda: jcl._init_impl(jax.random.PRNGKey(0), 64)),
                        seed)
        port = convert.load_control_lora(zoo.build_control_lora(cfg, "cpu"), params)
        out[variant] = (jcl, params, port)
    return out


def test_config_for_unet():
    """SD1.5 keeps the `base` layout; SD2.1 its 32 slots at 1024-d; SDXL gets 3
    buckets of 140 slots with an adapter-free level 0; the refiner 4 with two."""
    from controllora_tpu_torch.config import get_preset

    base = get_preset("base")
    assert config_for_unet(base, tunet.UNetConfig()) == base
    sd21 = config_for_unet(base, zoo.SD21_UNET)
    assert sum(map(len, sd21.lora_cross_attention_dims)) == 32
    assert {d for b in sd21.lora_cross_attention_dims for d in b} == {None, 1024}
    sdxl = config_for_unet(base, zoo.SDXL_UNET)
    assert sdxl.lora_block_out_channels == (320, 640, 1280)
    assert sdxl.lora_block_in_channels == (256, 256, 256)
    assert [len(b) for b in sdxl.lora_cross_attention_dims] == [0, 20, 120]
    ref = config_for_unet(base, zoo.SDXL_REFINER_UNET)
    assert [len(b) for b in ref.lora_cross_attention_dims] == [0, 40, 40, 8]
    port = zoo.build_control_lora(sdxl, "meta")
    assert len(port.lora_layers[0]) == 0 and len(port.lora_layers[2]) == 120


def test_folded_smokexl_matches_jax(stacks, controls):
    s = stacks["smokexl"]
    jcl, params, port = controls["smokexl"]
    guide = np.random.default_rng(7).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    jweights, jbiases = jax.jit(lambda u, p, g: j_fold_adapters(u, jcl(p, g, s["unet"].config)))(
        s["frozen"]["unet"], params, jnp.asarray(guide))
    with torch.no_grad():
        weights, biases = fold_adapters(s["tu"], port.adapters_for(nchw(guide),
                                                                   s["tu"].config))
    assert sorted(biases) == sorted(jbiases) and len(biases) == 22
    assert not any(n.startswith("down_blocks.0") for n in biases)  # adapter-free level 0
    folded = convert.flax_to_torch_unet(jweights)
    assert weights and all(k in folded for k in weights)
    for name, w in weights.items():
        ref = folded[name]
        bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(w.numpy() - ref).max()) <= bound, name
    for name, b in biases.items():
        for field in ("q_bias", "k_bias", "v_bias", "out_bias"):
            ours, ref = getattr(b, field), getattr(jbiases[name], field)
            assert (ours is None) == (ref is None), (name, field)
            if ref is not None:
                ref = np.asarray(ref)
                bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
                assert float(np.abs(ours.numpy() - ref).max()) <= bound, (name, field)


def make_guide():
    g = np.zeros((64, 64, 3), np.float32) - 1.0
    g[20:40, 20:40] = 1.0
    return g


@pytest.fixture(scope="module")
def pipes(stacks, controls):
    """Per family: (JAX pipeline, port pipeline) over the same weights and
    ControlLoRA; smoke2 samples v-prediction DPM-Solver++."""
    out = {}
    for variant in ("smoke2", "smokexl"):
        s = stacks[variant]
        jcl, params, port = controls[variant]
        vpred = variant == "smoke2"
        jsch = JDPM(JSchedule.create(prediction_type="v_prediction")) if vpred else None
        sch = (DPMSolverMultistepScheduler(DiffusionSchedule.create(
            prediction_type="v_prediction")) if vpred else None)
        out[variant] = (
            JPipeline(s["unet"], s["vae"], s["text"], HashTokenizer(), s["frozen"], jcl,
                      params, scheduler=jsch),
            StableDiffusionControlLoRAPipeline(s["tu"], s["tv"], s["tc"], HashTokenizer(),
                                               port, scheduler=sch, device="cpu"))
    return out


@pytest.mark.parametrize("variant", ["smoke2", "smokexl"])
def test_guided_render_matches_jax(pipes, variant):
    jpipe, pipe = pipes[variant]
    lat = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = dict(guide=make_guide(), num_inference_steps=2, return_array=True)
    ref = jpipe("a red square", latents=jnp.asarray(lat), **kw)[0]
    out = pipe("a red square", latents=lat, **kw)[0]
    err = float(np.abs(out - ref).max())
    assert out.shape == (64, 64, 3) and err <= 2e-3, f"{variant}: max|delta| {err}"
    unguided = pipe("a red square", latents=lat, num_inference_steps=2,
                    return_array=True)[0]
    assert np.abs(unguided - out).max() > 1e-3  # the guide reaches the image


def test_text_time_ids_and_pooled_encoders(stacks, pipes):
    """6 ids for SDXL, 5 with the aesthetic scores for the refiner; per-image pooled
    pairs; a text_time UNet with a tower that has no pooled head is an error."""
    _, pipe = pipes["smokexl"]
    assert pipe.text_time_ids(torch.zeros(2, 32), 1024, 768, 6.0, 2.5).tolist() == \
        [[1024, 768, 0, 0, 1024, 768]] * 2
    ctx, pooled = pipe.encode_prompt(["a", "b", "c"], ["", "", "x"])
    assert ctx.shape == (2, 3, 77, 64) and pooled.shape == (2, 3, 32)
    s = stacks["smokeref"]
    ref = StableDiffusionControlLoRAPipeline(s["tu"], s["tv"], s["tc"], HashTokenizer(),
                                             device="cpu")
    assert ref.text_time_ids(torch.zeros(2, 32), 64, 64, 7.0, 1.5).tolist() == \
        [[64, 64, 0, 0, 1.5], [64, 64, 0, 0, 7.0]]
    lat = np.random.default_rng(3).normal(size=(1, 8, 8, 4)).astype(np.float32)
    a, b = (ref("x", latents=lat, num_inference_steps=1, return_array=True,
                aesthetic_score=score)[0] for score in (6.0, 3.0))
    assert np.isfinite(a).all() and np.abs(a - b).max() > 1e-6  # the score conditions
    bad = StableDiffusionControlLoRAPipeline(s["tu"], s["tv"], stacks["smoke2"]["tc"],
                                             HashTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="pooled-projection text encoder"):
        bad("x", latents=lat, num_inference_steps=1)


def test_engine_batch_equals_each_alone(pipes):
    """Per-image prompts on smokexl carry their own pooled vectors: a batch of 2
    renders what each request renders alone."""
    _, pipe = pipes["smokexl"]
    reqs = [("a red square", 1), ("a blue circle", 2)]
    common = dict(guide=make_guide(), num_inference_steps=2, height=64, width=64,
                  return_array=True)
    eng = BatchingEngine(pipe, max_wait_ms=2000.0, buckets=(1, 2))
    try:
        futs = [eng.submit(p, seed=seed, **common) for p, seed in reqs]
        batched = [f.result(timeout=300) for f in futs]
        assert eng.stats["batch_sizes"] == {2: 1}
        alone = [eng.submit(p, seed=seed, **common).result(timeout=300) for p, seed in reqs]
    finally:
        eng.stop()
    for a, b in zip(batched, alone):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert np.abs(batched[0] - batched[1]).max() > 1e-3


def test_key_maps_round_trip_family_modules(stacks):
    """2-D proj_in/proj_out, add_embedding and text_projection go from the port's
    state dicts through the JAX importers and back through the port's copied
    exporters unchanged, as through the JAX package's originals."""
    s = stacks["smokexl"]
    sd = {k: v.numpy() for k, v in s["tu"].state_dict().items()}
    assert sd["down_blocks.1.attentions.0.proj_in.weight"].ndim == 2
    tree = torch_compat.translate_unet(sd)
    for export in (convert.flax_to_torch_unet, torch_compat.flax_to_torch_unet):
        back = export(tree)
        assert set(back) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k])
    for tower in ("te1", "te2"):
        sd = {k: v.numpy() for k, v in getattr(s["tc"], tower).state_dict().items()}
        assert ("text_projection.weight" in sd) == (tower == "te2")
        back = convert.flax_to_torch_clip(torch_compat.translate_clip_text(sd))
        assert set(back) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k])
