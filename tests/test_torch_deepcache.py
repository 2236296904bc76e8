"""DeepCache in the port's UNet (``forward(deepcache=...)``) against the JAX package's.

The invariant that makes DeepCache only stale, never different: the shallow path
runs exactly the level-0 modules of the full path, so on the same inputs
``shallow(cache_of(full(x))) == full(x)`` bit for bit, and a full eval's output is the
plain eval's. Then the port's full eval, its cache and its shallow eval on the JAX
cache agree with the JAX UNet's on the same smoke weights, fp32,
max|delta| <= 1e-4 * max(1, max|ref|) as in ``tests/test_torch_modules.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.models import zoo as jzoo
from controllora_tpu.models.unet import deepcache_feat_shape as j_feat_shape
from controllora_tpu.utils.torch_compat import translate_unet
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import deepcache_feat_shape


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_close(out, ref, what):
    bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out) - np.asarray(ref)).max())
    assert out.shape == ref.shape and err <= bound, f"{what}: max|delta| {err} > {bound}"


@pytest.fixture(scope="module")
def unets():
    """(JAX smoke UNet, its params, the port with the same weights, inputs). The
    weights are the port's seeded init, imported by the JAX package's
    ``torch_compat.translate_unet``."""
    unet, _, _ = jzoo.build_models("smoke", dtype=jnp.float32)
    port, _, _ = zoo.build_models("smoke", torch.float32, "cpu",
                                  torch.Generator().manual_seed(2))
    params = translate_unet({k: v.numpy() for k, v in port.state_dict().items()})
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, unet.config.cross_attention_dim)).astype(np.float32)
    t = np.array([3, 3], np.int32)
    return unet, params, port, (lat, t, ctx)


def port_args(inputs):
    lat, t, ctx = inputs
    return nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx)


def test_shallow_of_fresh_cache_equals_full(unets):
    _, _, port, inputs = unets
    args = port_args(inputs)
    with torch.no_grad():
        plain = port(*args)
        full, cache = port(*args, deepcache="full")
        shallow = port(*args, deepcache="shallow", deepcache_feat=cache)
    assert cache.shape == deepcache_feat_shape(port.config, 2, 8, 8)
    assert torch.equal(full, plain)
    assert torch.equal(shallow, full)


def test_shallow_depends_only_on_level0_inputs(unets):
    """A perturbed cache changes the output, and zeroing every deep parameter does
    not (the shallow eval never reads them)."""
    _, _, port, inputs = unets
    args = port_args(inputs)
    with torch.no_grad():
        _, cache = port(*args, deepcache="full")
        base = port(*args, deepcache="shallow", deepcache_feat=cache)
        bumped = port(*args, deepcache="shallow", deepcache_feat=cache + 0.1)
        deep = ("mid_block.", "down_blocks.1.", "down_blocks.2.", "down_blocks.3.",
                "up_blocks.0.", "up_blocks.1.", "up_blocks.2.")
        gutted = {name: torch.zeros_like(p) for name, p in port.named_parameters()
                  if name.startswith(deep)}
        same = torch.func.functional_call(port, gutted, args,
                                          {"deepcache": "shallow", "deepcache_feat": cache})
    assert (bumped - base).abs().max() > 1e-6
    assert torch.equal(same, base)


def test_full_and_shallow_match_jax(unets):
    unet, params, port, inputs = unets
    lat, t, ctx = inputs

    @jax.jit
    def ref_fn(p, x, tt, c):
        eps, cache = unet.apply({"params": p}, x, tt, c, deepcache="full")
        shallow = unet.apply({"params": p}, x, tt, c, deepcache="shallow",
                             deepcache_feat=cache)
        return eps, cache, shallow

    eps, cache, shallow = map(np.asarray, ref_fn(params, lat, t, ctx))
    assert deepcache_feat_shape(port.config, 2, 8, 8) == (2, cache.shape[3]) + cache.shape[1:3]
    assert cache.shape == j_feat_shape(unet.config, 2, 8, 8)
    with torch.no_grad():
        t_eps, t_cache = port(*port_args(inputs), deepcache="full")
        t_shallow = port(*port_args(inputs), deepcache="shallow", deepcache_feat=nchw(cache))
    assert_close(nhwc(t_eps), eps, "full eps")
    assert_close(nhwc(t_cache), cache, "cache")
    assert_close(nhwc(t_shallow), shallow, "shallow eps")


def test_validation_errors(unets):
    _, _, port, inputs = unets
    with pytest.raises(ValueError, match="deepcache must be"):
        port(*port_args(inputs), deepcache="half")
    with pytest.raises(ValueError, match="requires deepcache_feat"):
        port(*port_args(inputs), deepcache="shallow")
