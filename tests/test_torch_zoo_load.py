"""The port's checkpoint loader (``zoo.load_frozen``) against the JAX package's.

Seeded random smoke stacks of the three text layouts (``smoke``: text_encoder/ alone;
``smokexl``: text_encoder/ + text_encoder_2/; ``smokeref``: text_encoder_2/ alone) are
written in the diffusers layout with the port's own state dicts (its parameter names
are diffusers'), as ``.safetensors`` and as ``.bin``. The port loads each back exactly,
and the JAX ``load_frozen`` reads the same directory: the UNet forward, the VAE's
``encode_moments`` and the text forward of the two agree within 1e-5 (fp32, max
|delta| over max(1, max|ref|)). So does a directory written with the VAE attention's
newer names (``to_q``/``to_k``/``to_v``/``to_out.0``) and a CLIP ``position_ids``
buffer. A missing directory or tower raises FileNotFoundError; an unknown or a
missing key raises and names it.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.models import zoo as jzoo
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.utils import convert

TOL = 1e-5
LAYOUTS = {"smoke": ("text_encoder",), "smokexl": ("text_encoder", "text_encoder_2"),
           "smokeref": ("text_encoder_2",)}
WEIGHTS = {"text_encoder": "model", "text_encoder_2": "model"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stack(variant, seed=0):
    return zoo.build_models(variant, torch.float32, "cpu", torch.Generator().manual_seed(seed))


def component_dicts(variant, modules):
    """{subdirectory: state dict} of a stack in the diffusers layout."""
    unet, vae, text = modules
    sds = {"unet": unet.state_dict(), "vae": vae.state_dict()}
    towers = LAYOUTS[variant]
    if len(towers) == 2:
        full = text.state_dict()
        for prefix, sub in zip(("te1.", "te2."), towers):
            sds[sub] = {k[len(prefix):]: v for k, v in full.items() if k.startswith(prefix)}
    else:
        sds[towers[0]] = text.state_dict()
    return sds


def write_dir(root, sds, fmt="safetensors"):
    for sub, sd in sds.items():
        os.makedirs(root / sub, exist_ok=True)
        name = WEIGHTS.get(sub, "diffusion_pytorch_model")
        convert.save_state_dict(sd, str(root / sub / f"{name}.{fmt}"))
    return str(root)


def close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= TOL, err
    return err


def jax_forwards(variant, frozen, x, t, ctx, img, ids):
    """UNet eps, VAE posterior mean and text outputs of the JAX stack on ``frozen``."""
    unet, vae, text = jzoo.build_models(variant, dtype=jnp.float32)
    kw = {}
    if unet.config.addition_embed_type == "text_time":
        pooled_dim = 32
        n_ids = ((unet.config.projection_class_embeddings_input_dim - pooled_dim)
                 // unet.config.addition_time_embed_dim)
        kw = dict(added_text_embeds=jnp.full((1, pooled_dim), 0.3),
                  added_time_ids=jnp.full((1, n_ids), 64.0))
    eps = jax.jit(unet.apply)({"params": frozen["unet"]}, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), **kw)
    mean, _ = jax.jit(lambda p, i: vae.apply({"params": p}, i, method=vae.encode_moments))(
        frozen["vae"], jnp.asarray(img))
    txt = text.apply({"params": frozen["text"]}, jnp.asarray(ids))
    return eps, mean, txt, kw


def port_forwards(modules, x, t, ctx, img, ids, kw):
    unet, vae, text = modules
    with torch.no_grad():
        eps = unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
        mean, _ = vae.encode_moments(torch.from_numpy(img).permute(0, 3, 1, 2))
        txt = text(torch.from_numpy(ids))
    return eps.permute(0, 2, 3, 1).numpy(), mean.permute(0, 2, 3, 1).numpy(), txt


def inputs(unet):
    rng = np.random.default_rng(1)
    x = (0.5 * rng.normal(size=(1, 8, 8, 4))).astype(np.float32)
    ctx = (0.5 * rng.normal(size=(1, 77, unet.config.cross_attention_dim))).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = np.array([[49406, 320, 1929, 49407] + [49407] * 73], np.int64)
    return x, np.array([321]), ctx, img, ids


def outputs_match(variant, modules, root):
    """The port stack ``modules`` and the JAX ``load_frozen(root)`` agree."""
    frozen = jzoo.load_frozen(str(root), param_dtype=jnp.float32)
    x, t, ctx, img, ids = inputs(modules[0])
    eps, mean, txt, kw = jax_forwards(variant, frozen, x, t, ctx, img, ids)
    p_eps, p_mean, p_txt = port_forwards(modules, x, t, ctx, img, ids, kw)
    errs = [close(p_eps, eps), close(p_mean, mean)]
    pairs = zip(p_txt, txt) if isinstance(txt, tuple) else [(p_txt, txt)]
    errs += [close(a.numpy(), b) for a, b in pairs]
    return errs


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("variant", list(LAYOUTS))
def test_load_frozen_round_trip(tmp_path, variant, fmt):
    """Every tensor comes back exactly, into the modules of the variant; the
    variant is inferred from the UNet file."""
    modules = stack(variant)
    root = write_dir(tmp_path, component_dicts(variant, modules), fmt)
    loaded = zoo.load_frozen(root, variant, torch.float32, "cpu")
    for a, b in zip(modules, loaded):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert sb[k].dtype == torch.float32 and sb[k].device.type == "cpu"
            assert torch.equal(sa[k], sb[k]), k
        assert not any(p.requires_grad for p in b.parameters())
    assert zoo.infer_variant(root) == variant


@pytest.mark.parametrize("variant", list(LAYOUTS))
def test_load_frozen_matches_jax(tmp_path, variant):
    """The port's loaded stack and the JAX package's loaded trees, forward for
    forward, on one directory."""
    root = write_dir(tmp_path, component_dicts(variant, stack(variant)))
    modules = zoo.load_frozen(root, variant, torch.float32, "cpu")
    outputs_match(variant, modules, root)


def test_old_vae_names_and_position_ids_match_jax(tmp_path):
    """diffusers >= 0.14's VAE attention names, one of them as a 1x1 conv, and the
    CLIP tower's position_ids buffer: both loaders take them."""
    modules = stack("smoke", seed=3)
    sds = component_dicts("smoke", modules)
    new = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
    vae = {}
    for k, v in sds["vae"].items():
        parts = k.split(".")
        if "attentions" in parts and parts[-2] in new:
            parts[-2] = new[parts[-2]]
            if parts[-2] == "to_v" and parts[-1] == "weight":
                v = v[:, :, None, None]
        vae[".".join(parts)] = v
    assert "decoder.mid_block.attentions.0.to_out.0.weight" in vae
    sds["vae"] = vae
    sds["text_encoder"] = dict(sds["text_encoder"], **{
        "text_model.embeddings.position_ids": torch.arange(77)[None]})
    root = write_dir(tmp_path, sds)
    loaded = zoo.load_frozen(root, "smoke", torch.float32, "cpu")
    for a, b in zip(modules, loaded):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    outputs_match("smoke", loaded, root)


def test_load_frozen_casts_and_prefers_the_sorted_first_file(tmp_path):
    """A bf16 load is the same cast of each tensor; where unet/ holds both
    diffusion_pytorch_model.fp16.safetensors and diffusion_pytorch_model.safetensors,
    sorting picks the fp16 file first, as the JAX package's _find_weights does."""
    modules = stack("smoke")
    sds = component_dicts("smoke", modules)
    root = write_dir(tmp_path, sds)
    half = {k: v.half() for k, v in modules[0].state_dict().items()}
    convert.save_state_dict(half, str(tmp_path / "unet" / "diffusion_pytorch_model.fp16.safetensors"))
    assert zoo._find_weights(str(tmp_path / "unet")).endswith(".fp16.safetensors")
    assert jzoo._find_weights(str(tmp_path / "unet")) == zoo._find_weights(str(tmp_path / "unet"))
    unet, vae, _ = zoo.load_frozen(root, "smoke", torch.bfloat16, "cpu")
    for k, v in unet.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, half[k].to(torch.bfloat16)), k
    for k, v in vae.state_dict().items():
        assert torch.equal(v, sds["vae"][k].to(torch.bfloat16)), k


def test_missing_and_unknown_keys_raise(tmp_path):
    root = tmp_path / "ckpt"
    with pytest.raises(FileNotFoundError, match="unet/vae/text_encoder"):
        zoo.load_frozen(str(tmp_path / "nothing"), "smoke", torch.float32, "cpu")
    with pytest.raises(FileNotFoundError):
        jzoo.load_frozen(str(tmp_path / "nothing"))
    sds = component_dicts("smoke", stack("smoke"))
    write_dir(root, sds)
    shutil.rmtree(root / "text_encoder")
    with pytest.raises(FileNotFoundError, match="unet/vae/text_encoder"):
        zoo.load_frozen(str(root), "smoke", torch.float32, "cpu")
    with pytest.raises(FileNotFoundError):
        jzoo.load_frozen(str(root))
    shutil.rmtree(root)
    extra = dict(sds["unet"], **{"down_blocks.0.extra.weight": torch.zeros(2)})
    write_dir(root, dict(sds, unet=extra))
    with pytest.raises(RuntimeError, match="down_blocks.0.extra.weight"):
        zoo.load_frozen(str(root), "smoke", torch.float32, "cpu")
    shutil.rmtree(root)
    missing = {k: v for k, v in sds["vae"].items() if k != "encoder.conv_in.bias"}
    write_dir(root, dict(sds, vae=missing))
    with pytest.raises(RuntimeError, match="encoder.conv_in.bias"):
        zoo.load_frozen(str(root), "smoke", torch.float32, "cpu")
    with pytest.raises(ValueError, match="model variant"):
        zoo.load_frozen(str(root), "sd99", torch.float32, "cpu")


def test_state_dict_readers_view_one_buffer(tmp_path):
    """``load_tensors`` returns the file's dtypes (bf16 included) without a float32
    copy, and ``safetensors_load`` numpy views equal safetensors.numpy's arrays."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    sd = {"a": torch.randn(3, 5, dtype=torch.bfloat16), "b": torch.arange(6).reshape(2, 3),
          "c": torch.randn(4, dtype=torch.float16), "d": torch.zeros(0)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path)
    got = convert.load_tensors(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    del sd["a"]
    np_path = str(tmp_path / "y.safetensors")
    save_file(sd, np_path)
    ref = load_file(np_path)
    arrays = convert.load_state_dict(np_path)
    for k in ref:
        assert arrays[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(arrays[k], ref[k])
