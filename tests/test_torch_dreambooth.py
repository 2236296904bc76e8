"""The port's DreamBooth-LoRA slice against the JAX package on the CPU: the plain
LoRA adapters, the trainer's loss and LoRA gradient (with and without prior
preservation), the diffusers attn-procs format and its .safetensors / .bin files,
the DreamBooth dataset, a render with ``extra_loras``, and the CLI end to end.

Weights come from the JAX side (the smoke stack of tests/test_torch_training.py and
tests/test_torch_pipeline.py; LoRA factors from ``make_plain_lora_adapters`` with
every ``up`` moved off zero), carried into the port by ``attn_procs_to_torch`` /
``attn_procs_from_torch``; the JAX trainer's own draws are injected. fp32: the loss
is held to 2e-6 relative and the LoRA gradient to 1.5e-3 relative L2; the render
to atol 2e-3 on the [-1, 1] image (the pipeline tests' bound); files and items
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.data.dreambooth import DreamBoothDataset as JDreamBoothDataset
from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.models import lora as jlora
from controllora_tpu.models import zoo as jzoo
from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline
from controllora_tpu.training.dreambooth import DreamBoothLoRATrainer as JDreamBooth
from controllora_tpu.utils import torch_compat
from controllora_tpu_torch import train_dreambooth as cli
from controllora_tpu_torch.data.dreambooth import DreamBoothDataset
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.pipelines.text_to_image import merge_extra_loras
from controllora_tpu_torch.training.dreambooth import DreamBoothLoRATrainer
from controllora_tpu_torch.training.trainer import to_device_batch
from controllora_tpu_torch.utils import convert
from controllora_tpu_torch.utils.png import encode_png
from test_torch_modules import nchw
from test_torch_pipeline import COMMON, TINY_CONTROL
from test_torch_training import stack  # noqa: F401 (a fixture)

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


def jax_loras(seed, unet_config=jzoo.SMOKE_UNET):
    """JAX plain LoRA adapters with every factor nonzero ({name: AttnAdapter})."""
    adapters = jlora.make_plain_lora_adapters(jax.random.PRNGKey(seed), 4, unet_config)
    rng = np.random.default_rng(seed)
    return {name: a.replace(params=jax.tree.map(
        lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), a.params))
        for name, a in adapters.items()}


def port_loras(jadapters):
    """The same adapters in the port, through the attn-procs format."""
    tree = convert.attn_procs_from_torch(torch_compat.attn_procs_to_torch(jadapters))
    return {name: tlora.AttnAdapter(
        params={proj: {w: torch.from_numpy(np.ascontiguousarray(x)) for w, x in pair.items()}
                for proj, pair in tree[name].items()},
        spec=tlora.AdapterSpec(kind="lora")) for name in jadapters}


# ---------------------------------------------------------------------------- adapters


def test_plain_lora_adapters_match_jax_layout():
    """One adapter per attention processor with the JAX layout: the same names,
    projections and factor shapes, kind "lora"; up starts at zero, down ~ N(0, 1/r)."""
    ours = tlora.make_plain_lora_adapters(torch.Generator().manual_seed(0), 4,
                                          jzoo.SMOKE_UNET)
    ref = jlora.make_plain_lora_adapters(jax.random.PRNGKey(0), 4, jzoo.SMOKE_UNET)
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name].spec.kind == ref[name].spec.kind == "lora"
        assert list(ours[name].params) == list(ref[name].params) == \
            ["to_q", "to_k", "to_v", "to_out"]
        for proj, pair in ref[name].params.items():
            for w in ("down", "up"):
                assert tuple(ours[name].params[proj][w].shape) == pair[w].shape
            assert not ours[name].params[proj]["up"].any()
    downs = torch.cat([a.params[p]["down"].flatten() for a in ours.values() for p in a.params])
    assert abs(downs.std().item() - 0.25) < 0.01
    spec = tlora.AdapterSpec(kind="control_v2", concat_hidden=True, key_skipped=True,
                             value_skipped=True)
    p = tlora.init_adapter_params(torch.Generator().manual_seed(1), 32, 24, 4, spec,
                                  control_rank=3, control_channels=12)
    jp = jlora.init_adapter_params(jax.random.PRNGKey(1), 32, 24, 4,
                                   jlora.AdapterSpec(kind="control_v2", concat_hidden=True,
                                                     key_skipped=True, value_skipped=True),
                                   control_rank=3, control_channels=12)
    assert {k: {w: tuple(t.shape) for w, t in v.items()} for k, v in p.items()} == \
        {k: {w: x.shape for w, x in v.items()} for k, v in jp.items()}


def test_attn_procs_format_matches_jax(tmp_path):
    """attn_procs_to_torch: the JAX exporter's keys and values; attn_procs_from_torch
    takes them back; the .safetensors file is the bytes safetensors.numpy writes,
    and both files load back exactly (here and through the JAX loader)."""
    from safetensors.numpy import save as st_save

    jad = jax_loras(3)
    ref = torch_compat.attn_procs_to_torch(jad)
    ours = convert.attn_procs_to_torch(port_loras(jad))
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    back = convert.attn_procs_from_torch(ours)
    for name, a in jad.items():
        for proj, pair in a.params.items():
            for w, x in pair.items():
                np.testing.assert_array_equal(back[name][proj][w], np.asarray(x))
    assert convert.safetensors_bytes(ours) == st_save(
        {k: np.ascontiguousarray(v) for k, v in ours.items()})
    for fmt in ("safetensors", "bin"):
        path = str(tmp_path / f"lora.{fmt}")
        convert.save_state_dict(ours, path)
        for loaded in (convert.load_state_dict(path), torch_compat.load_state_dict(path)):
            assert list(loaded) == list(ours) if fmt == "bin" else set(loaded) == set(ours)
            for k in ours:
                assert loaded[k].dtype == np.float32
                np.testing.assert_array_equal(loaded[k], ours[k])
    with pytest.raises(KeyError, match="unrecognized"):
        convert.attn_procs_from_torch({"unet.weight": np.zeros(1)})


# ---------------------------------------------------------------------------- trainer


def test_dreambooth_prior_loss_and_grads_match_jax(stack):  # noqa: F811
    """jax.value_and_grad(DreamBoothLoRATrainer._loss_fn) with prior preservation
    against the port's loss and LoRA gradient: VAE encode (posterior sample), DDPM
    noising, CLIP, the threaded plain LoRAs in every attention, the instance half's
    MSE plus the class half's weighted by 0.7."""
    prior = True
    rng = np.random.default_rng(5)
    batch = {"pixel_values": rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 49408, (4, 77)).astype(np.int32)}
    jad = jax_loras(4)
    jt = JDreamBooth(stack["unet"], stack["frozen"], vae=stack["vae"],
                     text_encoder=stack["text"], rank=4, remat_unet=False,
                     with_prior_preservation=prior, prior_loss_weight=0.7)
    jt._specs = {k: a.spec for k, a in jad.items()}
    params = {k: a.params for k, a in jad.items()}
    key = jax.random.PRNGKey(9)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt._loss_fn))(
        params, stack["frozen"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    draws = dict(sample_noise=nchw(np.array(jax.random.normal(k_sample, (4, 8, 8, 4)))),
                 noise=nchw(np.array(jax.random.normal(k_noise, (4, 8, 8, 4)))),
                 timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (4,), 0, 1000))))
    tt = DreamBoothLoRATrainer(stack["tu"], stack["tv"], stack["tc"], loras=port_loras(jad),
                               remat_unet=False, with_prior_preservation=prior,
                               prior_loss_weight=0.7)
    loss = tt.loss(to_device_batch(batch, "cpu"), **draws)
    grads = iter(tt.grads(loss))
    tree = {name: {proj: {w: next(grads) for w in pair} for proj, pair in a.params.items()}
            for name, a in tt.loras.items()}
    out, ref = convert.attn_procs_to_torch(tree), torch_compat.attn_procs_to_torch(grads_ref)
    assert list(out) == list(ref)
    loss_err = abs(loss.item() - float(loss_ref)) / abs(float(loss_ref))
    assert loss_err <= LOSS_REL, f"loss: relative {loss_err}"
    a = np.concatenate([out[k].ravel() for k in ref])
    b = np.concatenate([np.asarray(ref[k]).ravel() for k in ref])
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert np.linalg.norm(b) > 0 and rel <= GRAD_REL, f"LoRA gradient: relative L2 {rel}"
    # the trainer's state dict is the attn-procs artifact, and loads back
    sd = tt.state_dict()
    assert list(sd) == list(torch_compat.attn_procs_to_torch(jad))
    tt.load_state_dict({k: np.zeros_like(v) for k, v in sd.items()})
    assert all(not t.any() for t in tt.params)
    tt.load_state_dict(sd)
    for k, v in tt.state_dict().items():
        np.testing.assert_array_equal(v, sd[k])


# ---------------------------------------------------------------------------- render


def test_extra_loras_render_matches_jax(stack):  # noqa: F811
    """A 2-step unguided render with a DreamBooth LoRA as every layer's main adapter
    (folded) against the JAX pipeline's extra_loras render; beside a fresh ControlLoRA
    (an exact no-op: its up factors are zero) the chain does not fold, renders
    threaded, and equals the folded render."""
    jpipe = JPipeline(stack["unet"], stack["vae"], stack["text"], JHashTokenizer(),
                      stack["frozen"])
    control = zoo.build_control_lora(TINY_CONTROL, "cpu", torch.Generator().manual_seed(0))
    pipe = StableDiffusionControlLoRAPipeline(stack["tu"], stack["tv"], stack["tc"],
                                              HashTokenizer(), control, device="cpu")
    jad = jax_loras(6)
    lat = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(np.float32)
    kw = {k: v for k, v in COMMON.items() if k not in ("height", "width")}
    ref = jpipe("a sks toy", latents=jnp.asarray(lat), extra_loras=jad, **kw)[0]
    out = pipe("a sks toy", latents=lat, extra_loras=port_loras(jad), **kw)[0]
    np.testing.assert_allclose(out, ref, atol=2e-3)
    plain = pipe("a sks toy", latents=lat, **kw)[0]  # no guide: the ControlLoRA is idle
    assert np.abs(plain - out).max() > 1e-3  # the LoRA reaches the image
    lora = port_loras(jad)[next(iter(jad))]
    stacks = {"x.processor": tlora.AdapterStack(main=lora)}
    merged = merge_extra_loras(stacks, {"x.processor": lora, "y.processor": lora}, "post")
    assert merged["x.processor"].post == (lora,) and merged["y.processor"].main is lora
    assert stacks["x.processor"].post == ()
    guide = np.zeros((64, 64, 3), np.float32)
    chained = pipe("a sks toy", guide=guide, latents=lat, extra_loras=port_loras(jad), **kw)[0]
    np.testing.assert_allclose(chained, out, atol=2e-3)


# ---------------------------------------------------------------------------- data + CLI


def write_png(path, seed, h, w):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def test_dreambooth_dataset_items_equal_jax(tmp_path):
    """Items equal the JAX dataset's bit for bit: PNGs at the size (decoded by the
    port's codec, no resize) and larger ones (resized by the port's PIL-exact
    bilinear, ``utils/image.py``, without PIL), random and centre crops, with class
    images."""
    inst, cls = tmp_path / "instance", tmp_path / "class"
    inst.mkdir()
    cls.mkdir()
    write_png(inst / "a.png", 0, 64, 64)
    write_png(inst / "b.png", 1, 80, 100)
    write_png(cls / "c.png", 2, 72, 64)
    for center in (False, True):
        kw = dict(instance_data_dir=str(inst), instance_prompt="a sks toy",
                  class_data_dir=str(cls), class_prompt="a toy", resolution=64,
                  center_crop=center, seed=3)
        ours, ref = DreamBoothDataset(HashTokenizer(), **kw), JDreamBoothDataset(
            JHashTokenizer(), **kw)
        assert len(ours) == len(ref) == 2
        for i in range(2):
            a, b = ours[i], ref[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_dreambooth_cli_smoke_artifact_loads_in_jax(tmp_path, capsys):
    """The CLI on the smoke stack: a class image sampled by the frozen stack, prior
    preservation, 3 updates at batch 2, a checkpoint at update 2 with the LoRA beside
    it, validation renders; the final .safetensors and .bin load in the JAX
    package's attn_procs_from_torch as the same LoRA."""
    inst = tmp_path / "instance"
    inst.mkdir()
    for i in range(2):
        write_png(inst / f"{i}.png", i, 64, 64)
    out = tmp_path / "out"
    cli.main(["--model_variant", "smoke", "--resolution", "64", "--instance_data_dir",
              str(inst), "--instance_prompt", "a sks toy", "--with_prior_preservation",
              "--class_prompt", "a toy", "--class_data_dir", str(tmp_path / "class"),
              "--sample_class_images", "--num_class_images", "1", "--train_batch_size",
              "2", "--max_train_steps", "3", "--log_every", "1", "--checkpointing_steps",
              "2", "--lr_warmup_steps", "0", "--learning_rate", "1e-3",
              "--validation_prompt", "a sks toy", "--num_validation_images", "1",
              "--output_dir", str(out), "--device", "cpu"])
    stdout = capsys.readouterr().out
    assert "generated 1 class images" in stdout and "step 3:" in stdout
    assert "nan" not in stdout and "saved checkpoint-2" in stdout
    assert os.listdir(tmp_path / "class") == ["class-0.png"]
    assert (out / "checkpoint-2" / "pytorch_lora_weights.safetensors").exists()
    assert sorted(os.listdir(out / "images")) == ["test_0-3.png", "validation_0-1.png"]
    files = [torch_compat.load_state_dict(str(out / f"pytorch_lora_weights.{fmt}"))
             for fmt in ("safetensors", "bin")]
    jtree = torch_compat.attn_procs_from_torch(files[0])
    assert list(jtree) == list(jzoo_names())
    for k in files[0]:
        np.testing.assert_array_equal(files[0][k], files[1][k])
    assert max(float(np.abs(v).max()) for k, v in files[0].items() if ".up." in k) > 0


def test_dreambooth_cli_resume_is_bitwise(tmp_path, capsys):
    """3 updates straight against 2, then --resume_from_checkpoint latest for 1 more:
    the LoRA files are bitwise equal (factors, AdamW moments, schedule, noise
    generator and the data stream's fast-forward restored). The warmup spans the
    resume point; its length does not depend on --max_train_steps."""
    inst = tmp_path / "instance"
    inst.mkdir()
    for i in range(3):
        write_png(inst / f"{i}.png", i, 64, 64)
    common = ["--model_variant", "smoke", "--resolution", "64", "--instance_data_dir",
              str(inst), "--instance_prompt", "a sks toy", "--lr_scheduler",
              "constant_with_warmup", "--lr_warmup_steps", "3", "--learning_rate", "1e-3",
              "--device", "cpu"]
    cli.main(common + ["--max_train_steps", "3", "--checkpointing_steps", "0",
                       "--output_dir", str(tmp_path / "a")])
    cli.main(common + ["--max_train_steps", "2", "--checkpointing_steps", "2",
                       "--output_dir", str(tmp_path / "b")])
    capsys.readouterr()
    cli.main(common + ["--max_train_steps", "3", "--checkpointing_steps", "0",
                       "--resume_from_checkpoint", "latest", "--output_dir",
                       str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 3:" in out and "step 2:" not in out
    a, b = (convert.load_state_dict(str(tmp_path / d / "pytorch_lora_weights.bin"))
            for d in ("a", "b"))
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def jzoo_names():
    from controllora_tpu.models.unet import attention_processor_names

    return attention_processor_names(jzoo.SMOKE_UNET)
