"""The port's serving mesh against the JAX package on the CPU: guided renders on
gloo ranks (``tests/torch_parallel_workers.py``, one process a rank) over the
'data', 'cfg', 'cfg,model=2' and 'data,cfg' meshes (SD1.5 smoke) and 'cfg,model=2'
(SDXL smoke), each rank's images against the JAX pipeline's single-device render and
the port's 1-process render, and ToMe + DeepCache on cfg,model=2 against the port's
1-process render of them, as inpainting on data,cfg; the BatchingEngine on a data mesh through
``serve.MeshLeader`` / ``serve.follow``; ``sample.main`` under ``--serving_mesh cfg``;
and the mesh refusals with the JAX messages.

Weights: the smoke stacks' JAX parameter trees (the shapes of ``random_frozen``,
seeded numpy fills, as tests/test_torch_families.py makes them) loaded into both.
64², 2 DPM-Solver++ steps, CFG 7, batch 2, fp32. The initial noise is the port's
generator draw for the whole batch (each rank keeps its rows), handed to JAX as
``latents``. Bounds: 2e-3 on the [-1, 1] image against JAX (``__graft_entry__.py``'s);
against the port's 1-process render the mesh changes only summation order (the cfg
split's (1 - g) eps_u + g eps_c, the tensor-parallel partial sums), held to
PORT_BOUND (measured at most 1.7e-5 on this host; the 'data' mesh differs too, by
its batch of 1 a rank). The rank processes run while the test process renders the
references.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.config import ControlLoRAConfig as JControlLoRAConfig
from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.control_lora import ControlLoRA as JControlLoRA
from controllora_tpu.models.unet import derive_cross_attention_dims
from controllora_tpu.parallel import make_serving_mesh as jax_serving_mesh
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu_torch import sample
from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.control_lora import config_for_unet
from controllora_tpu_torch.parallel import make_serving_mesh
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.serving.engine import request_latents
from controllora_tpu_torch.training.checkpoint import save_control_lora
from controllora_tpu_torch.utils import convert
from controllora_tpu_torch.utils.png import decode_png
from test_torch_families import HINT, filled
from torch_parallel_workers import Ranks

JAX_BOUND, PORT_BOUND = 2e-3, 1e-4
SEED, STEPS, CFG_SCALE = 11, 2, 7.0
CONTROL = {"smoke": dict(block_out_channels=(8, 16, 16, 32),
                         lora_block_in_channels=(32, 32, 32, 32),
                         lora_block_out_channels=(32, 64, 96, 96),
                         lora_cross_attention_dims=derive_cross_attention_dims(
                             jzoo.SMOKE_UNET)),
           "smokexl": HINT}
# name: (variant, ranks, cfg, model) -> mesh shape
CASES = {
    "data-smoke": ("smoke", 2, False, 1),
    "cfg-smoke": ("smoke", 2, True, 1),
    "cfg,model=2-smoke": ("smoke", 4, True, 2),
    "data,cfg-smoke": ("smoke", 4, True, 1),
    "cfg,model=2-smokexl": ("smokexl", 4, True, 2),
    "tome+deepcache-cfg,model=2-smoke": ("smoke", 4, True, 2),
    "inpaint-data,cfg-smoke": ("smoke", 4, True, 1),
}
# ToMe's window draws depend on the step, the module and the grid, not on the batch
# (ops/tome.py::window_choice), so a rank's half of the CFG batch merges as the same
# rows of the 1-process batch do: held to the port's 1-process render of the same
# accelerations (whose JAX parity, with the JAX draws, is tests/test_torch_pipeline.py's)
SPEED = dict(tome_ratio=0.5, tome_min_tokens=0, deepcache_interval=2)
# inpainting (img2img + mask): the encoded init image and the noise are the whole
# batch's, sliced per 'data' rank; the JAX pipeline draws its noise from jax.random, so
# this case is held to the port's 1-process render (whose JAX parity is
# tests/test_torch_img2img.py's)
_RNG = np.random.default_rng(5)
PAINT = dict(image=_RNG.uniform(-1, 1, (64, 64, 3)).astype(np.float32), strength=0.7,
             mask=(_RNG.uniform(0, 1, (64, 64)) > 0.5).astype(np.float32))
EXTRA = {"tome+deepcache-cfg,model=2-smoke": SPEED, "inpaint-data,cfg-smoke": PAINT}
JAX_CASES = [name for name in CASES if name not in EXTRA]
SHAPES = {"data-smoke": {"data": 2}, "cfg-smoke": {"data": 1, "cfg": 2},
          "cfg,model=2-smoke": {"data": 1, "cfg": 2, "model": 2},
          "data,cfg-smoke": {"data": 2, "cfg": 2},
          "cfg,model=2-smokexl": {"data": 1, "cfg": 2, "model": 2},
          "tome+deepcache-cfg,model=2-smoke": {"data": 1, "cfg": 2, "model": 2},
          "inpaint-data,cfg-smoke": {"data": 2, "cfg": 2}}
SERVE_SEEDS, SERVE_PROMPTS = (3, 4), ("a red square", "a blue square")


def make_guide():
    g = np.zeros((64, 64, 3), np.float32) - 1.0
    g[20:40, 20:40] = 1.0
    return g


KW = dict(guide=make_guide(), num_images=2, num_inference_steps=STEPS,
          guidance_scale=CFG_SCALE, return_array=True)


@pytest.fixture(scope="module")
def stacks():
    """Per variant: (JAX pipeline, port pipeline) over the same weights."""
    out = {}
    for seed, variant in enumerate(("smoke", "smokexl")):
        unet, vae, text = jzoo.build_models(variant, dtype=jnp.float32)
        frozen = filled(jax.eval_shape(lambda: jzoo.random_frozen(
            jax.random.PRNGKey(0), unet, vae, text, latent_size=8,
            param_dtype=jnp.float32)), seed)
        tu, tv, tc = zoo.build_models(variant, torch.float32, "cpu")
        convert.load_unet(tu, frozen["unet"])
        convert.load_vae(tv, frozen["vae"])
        convert.load_clip(tc, frozen["text"])
        cfg = config_for_unet(ControlLoRAConfig(**CONTROL[variant]), tu.config)
        jcl = JControlLoRA(JControlLoRAConfig.from_dict(cfg.to_dict()))
        params = filled(jax.eval_shape(lambda: jcl._init_impl(jax.random.PRNGKey(0), 64)),
                        seed + 10)
        port = convert.load_control_lora(zoo.build_control_lora(cfg, "cpu"), params)
        out[variant] = dict(
            jax=JPipeline(unet, vae, text, JHashTokenizer(), frozen, jcl, params),
            port=StableDiffusionControlLoRAPipeline(tu, tv, tc, HashTokenizer(), port,
                                                    device="cpu"),
            jparts=(unet, vae, text, frozen, jcl, params),
            blob=dict(unet=tu.state_dict(), vae=tv.state_dict(), text=tc.state_dict(),
                      control=port.state_dict(), control_cfg=cfg))
    return out


def noise(n=2):
    """The port's draw for the whole batch (``draw_noise``), NHWC."""
    return torch.randn((n, 8, 8, 4), generator=torch.Generator().manual_seed(SEED)).numpy()


@pytest.fixture(scope="module")
def launched(stacks, tmp_path_factory):
    """Every case on 4 gloo ranks, then the engine and the sample CLI, started."""
    root = tmp_path_factory.mktemp("mesh")
    control_dir = str(root / "control")
    save_control_lora(control_dir, stacks["smoke"]["port"].control_lora)
    job = dict(kind="render", stacks={v: s["blob"] for v, s in stacks.items()},
               cases=[dict(name=name, variant=v, world=w, cfg=cfg, model=m,
                           prompt="a red square", seed=SEED,
                           kw=dict(KW, **EXTRA.get(name, {})))
                      for name, (v, w, cfg, m) in CASES.items()],
               serve=dict(case="data,cfg-smoke", prompts=SERVE_PROMPTS, seeds=SERVE_SEEDS,
                          kw=dict(guide=make_guide(), num_inference_steps=STEPS,
                                  guidance_scale=CFG_SCALE, height=64, width=64)),
               sample_argv=sample_argv(control_dir, str(root / "sample" / "rank{rank}"))
               + ["--serving_mesh", "cfg", "--dist_backend", "gloo"])
    return Ranks(4, str(root / "job"), job), root, control_dir


@pytest.fixture(scope="module")
def references(stacks, launched):
    """Per variant: the JAX single-device render and the port's 1-process render."""
    out = {}
    for variant, s in stacks.items():
        jax_kw = {k: v for k, v in KW.items() if k != "num_images"}
        out[variant] = dict(
            jax=np.stack(s["jax"]("a red square", latents=jnp.asarray(noise()), **jax_kw)),
            port=np.stack(s["port"]("a red square",
                                    generator=torch.Generator().manual_seed(SEED), **KW)))
    for name, extra in EXTRA.items():
        out[name] = dict(port=np.stack(stacks["smoke"]["port"](
            "a red square", generator=torch.Generator().manual_seed(SEED), **KW, **extra)))
    return out


@pytest.fixture(scope="module")
def ranks(launched, references):
    """(each rank's results, the job's directory, the ControlLoRA artifact)."""
    job, root, control_dir = launched
    return job.results(), root, control_dir


def sample_argv(control_dir, out):
    return ["--model_variant", "smoke", "--control_lora_dir", control_dir, "--resolution",
            "64", "--num_inference_steps", "2", "--num_validation_images", "1",
            "--device", "cpu", "--output_dir", out]


def members(results, name):
    return [(r, res[name]) for r, res in enumerate(results) if name in res]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_render_matches_jax(ranks, references, name):
    """Every member rank returns all images (gathered over 'data' in order), each
    within 2e-3 of the JAX single-device render."""
    variant, world = CASES[name][:2]
    got = members(ranks[0], name)
    assert [r for r, _ in got] == list(range(world))
    ref = references[variant]["jax"]
    for r, res in got:
        assert res["images"].shape == (2, 64, 64, 3)
        err = float(np.abs(res["images"] - ref).max())
        assert err <= JAX_BOUND, f"{name} rank {r}: max|delta| {err} against JAX"


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_render_matches_port(ranks, references, stacks, name):
    """The same renders against the port's 1-process render (PORT_BOUND), and the
    ranks' coordinates tile the mesh as the JAX ``make_serving_mesh`` does."""
    variant, world, cfg, model = CASES[name]
    jmesh = jax_serving_mesh(jax.devices()[:world], cfg=cfg, model=model)
    assert dict(jmesh.shape) == SHAPES[name]
    got = members(ranks[0], name)
    ref = references[name if name in EXTRA else variant]["port"]
    assert [r for r, _ in got] == list(range(world))
    for r, res in got:
        err = float(np.abs(res["images"] - ref).max())
        assert err <= PORT_BOUND, f"{name} rank {r}: max|delta| {err} against 1 process"
        where = np.argwhere(np.array(jmesh.devices).reshape(-1) == jax.devices()[r])[0][0]
        want = np.unravel_index(where, tuple(SHAPES[name].values()))
        assert tuple(res["coords"][a] for a in SHAPES[name]) == tuple(want)


def test_engine_on_data_mesh(ranks, stacks):
    """Two guided requests with one guide through the BatchingEngine over
    ``serve.MeshLeader`` on a data 2 x cfg 2 mesh: buckets snap to the data axis, the
    guide fingerprint groups them into one batch of 2, the followers make the one
    call, and each image is the 1-process render of the same per-image batch."""
    results = ranks[0]
    served = results[0]["serve"]
    assert served["stats"]["batch_sizes"] == {2: 1} and served["stats"]["mesh"] == \
        {"data": 2, "cfg": 2}
    assert [res["serve_calls"] for res in results[1:]] == [1, 1, 1]
    pipe = stacks["smoke"]["port"]
    lat = np.concatenate([request_latents(s, 64, 64) for s in SERVE_SEEDS])
    ref = pipe(list(SERVE_PROMPTS), negative_prompt=["", ""], guide=make_guide(),
               latents=lat, num_inference_steps=STEPS, guidance_scale=CFG_SCALE,
               height=64, width=64)
    for img, want in zip(served["images"], ref):
        assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
        assert np.abs(img.astype(int) - want).max() <= 1


def test_sample_cli_on_cfg_mesh(ranks):
    """``sample.main --serving_mesh cfg`` on 4 ranks: ranks 0 and 1 render (2 and 3
    stay outside the mesh), rank 0 alone writes; its montage equals the 1-process
    CLI's within one level."""
    _, root, control_dir = ranks
    assert os.listdir(root / "sample" / "rank0") == ["0.png"]
    assert sorted(os.listdir(root / "sample")) == ["rank0"]
    sample.main(sample_argv(control_dir, str(root / "single")))
    a = decode_png((root / "sample" / "rank0" / "0.png").read_bytes()).astype(int)
    b = decode_png((root / "single" / "0.png").read_bytes()).astype(int)
    assert a.shape == b.shape == (64, 192, 3) and np.abs(a - b).max() <= 1


# ---------------------------------------------------------------------------- refusals


def jax_error(stacks, variant, mesh, **kw):
    unet, vae, text, frozen, jcl, params = stacks[variant]["jparts"]
    with pytest.raises(ValueError) as e:
        JPipeline(unet, vae, text, JHashTokenizer(), frozen, jcl, params,
                  mesh=mesh)("x", **kw)
    return str(e.value)


def port_error(stacks, variant, mesh, **kw):
    p = stacks[variant]["port"]
    with pytest.raises(ValueError) as e:
        StableDiffusionControlLoRAPipeline(p.unet, p.vae, p.text_encoder, HashTokenizer(),
                                           p.control_lora, device="cpu", mesh=mesh)("x", **kw)
    return str(e.value)


def lora(stacks):
    return tlora.make_plain_lora_adapters(torch.Generator().manual_seed(0), 2,
                                          stacks["smoke"]["port"].unet.config)


@pytest.mark.parametrize("what", ["batch", "guides", "threaded", "heads", "heads-xl"])
def test_mesh_refusals_match_jax(stacks, what):
    """The JAX pipeline's mesh refusals, message for message, raised before any
    collective (so a mesh without a process group shows them): a batch the 'data'
    axis does not divide, per-image guides on a data mesh, a threaded stack (a LoRA
    chained before the ControlLoRA) under tensor parallelism, and heads the 'model'
    axis does not divide (SD1.5 smoke at 8; SDXL smoke at 4, where the 2-head level 0
    is attention-free and does not count)."""
    guide = make_guide()
    if what == "batch":
        kw = dict(guide=guide, num_images=3, num_inference_steps=1)
        cfg, model, world = False, 1, 2
    elif what == "guides":
        kw = dict(guide=np.stack([guide, guide]), num_images=2, num_inference_steps=1)
        cfg, model, world = False, 1, 2
    elif what == "threaded":
        kw = dict(guide=guide, num_inference_steps=1)
        cfg, model, world = False, 2, 2
    else:
        kw = dict(num_inference_steps=1)
        cfg, model, world = False, (8 if what == "heads" else 4), 8
    variant = "smokexl" if what == "heads-xl" else "smoke"
    jmesh = jax_serving_mesh(jax.devices()[:world], cfg=cfg, model=model)
    mesh = make_serving_mesh(world, cfg=cfg, model=model)
    assert mesh.shape == dict(jmesh.shape)
    if what == "threaded":
        from controllora_tpu.models import lora as jlora

        jad = {n: jlora.AttnAdapter(params=jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                                        a.params),
                                    spec=jlora.AdapterSpec(kind="lora"))
               for n, a in lora(stacks).items()}
        want = jax_error(stacks, variant, jmesh, extra_loras=jad, **kw)
        got = port_error(stacks, variant, mesh, extra_loras=lora(stacks), **kw)
    elif what.startswith("heads"):
        with pytest.raises(ValueError) as e:
            unet, vae, text, frozen, jcl, params = stacks[variant]["jparts"]
            JPipeline(unet, vae, text, JHashTokenizer(), frozen, mesh=jmesh)
        want = str(e.value)
        p = stacks[variant]["port"]
        with pytest.raises(ValueError) as e:
            StableDiffusionControlLoRAPipeline(p.unet, p.vae, p.text_encoder,
                                               HashTokenizer(), device="cpu", mesh=mesh)
        got = str(e.value)
    else:
        want = jax_error(stacks, variant, jmesh, **kw)
        got = port_error(stacks, variant, mesh, **kw)
    assert got == want


def test_tp_unet_refuses_threaded_stack(stacks):
    """A tensor-parallel UNet's attention refuses an AdapterStack with the JAX
    message (``models/unet.py`` :226-232)."""
    from controllora_tpu_torch.models.unet import CrossAttention

    attn = CrossAttention(32, 4, 8, tp_size=2)
    stack = next(iter(lora(stacks).values()))
    with pytest.raises(ValueError, match="supports folded adapter stacks only"):
        attn(torch.zeros(1, 4, 32), None, tlora.AdapterStack(main=stack))
