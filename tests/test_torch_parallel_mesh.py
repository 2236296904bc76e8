"""The port's mesh and tensor-parallel rules against the JAX package's, on the CPU
with no process group (nothing here compiles):

* ``make_serving_mesh`` for every world of 1, 2, 4 and 8 ranks, cfg on and off, model
  1, 2 and 4: the axis sizes of the JAX mesh over as many of conftest's 8 virtual
  devices, or the same error; ``build_serving_mesh`` (``scripts/sample.py``'s) on
  every spec of its grammar at every world size, with ``jax.devices()`` cut to it;
* ``_role`` of every UNet parameter (SD1.5 and SDXL smoke), ``_geglu_permute``, and
  each rank's shard of the prepared weights and folded biases against the JAX
  prepared arrays sliced as ``tp_param_specs`` / ``tp_bias_specs`` say, converted to
  torch's layout: exactly equal;
* ``validate_tp`` on the smoke, smoke2, smokexl, SD1.5, SD2.1 and SDXL UNets: the
  same verdicts and messages;
* ``maybe_initialize_distributed``: a no-op in one process; nccl with more ranks than
  cards raises.
"""

import jax
import numpy as np
import pytest
import torch

from controllora_tpu.models import zoo as jzoo
from controllora_tpu.ops.folding import FoldedBias as JFoldedBias
from controllora_tpu.parallel import make_serving_mesh as jax_serving_mesh
from controllora_tpu.parallel import tp as jtp
from controllora_tpu.utils.torch_compat import translate_unet
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.ops.folding import FoldedBias
from controllora_tpu_torch.parallel import distributed, make_serving_mesh
from controllora_tpu_torch.parallel import tp
from controllora_tpu_torch.parallel.mesh import build_serving_mesh
from controllora_tpu_torch.utils.convert import flax_to_torch_unet
from scripts.sample import build_serving_mesh as jax_build_serving_mesh

WORLDS = (1, 2, 4, 8)


def outcome(fn):
    """(axis sizes, None) or (None, the error's type and text)."""
    try:
        mesh = fn()
    except (ValueError, SystemExit) as e:
        return None, (type(e).__name__, str(e))
    return (None if mesh is None else dict(mesh.shape)), None


@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("cfg", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_make_serving_mesh_matches_jax(world, cfg, model):
    ours = outcome(lambda: make_serving_mesh(world, cfg=cfg, model=model))
    ref = outcome(lambda: jax_serving_mesh(jax.devices()[:world], cfg=cfg, model=model))
    assert ours == ref
    if ours[0] is not None:
        mesh = make_serving_mesh(world, cfg=cfg, model=model)
        assert mesh.ranks == list(range(world)) and mesh.coords == {a: 0 for a in ours[0]}


SPECS = ("data", "cfg", "cfg,model=2", "data,cfg", "data,cfg,model=2", "model", "model=4",
         "cfg,model=4", "data,model=2", " cfg , data ", "tp", "", None)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: repr(s))
@pytest.mark.parametrize("world", WORLDS)
def test_build_serving_mesh_matches_jax(world, spec, monkeypatch):
    """The grammar, the ranks each spec takes (the first 2 * K without 'data', the
    rest then outside the mesh) and the messages of ``scripts/sample.py``."""
    devices = jax.devices()[:world]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    ours = outcome(lambda: build_serving_mesh(spec, world))
    assert ours == outcome(lambda: jax_build_serving_mesh(spec))
    if ours[0] is not None:
        mesh = build_serving_mesh(spec, world)
        assert mesh.ranks == list(range(mesh.devices)) and mesh.member


def smoke_params(variant):
    unet = zoo.build_models(variant, torch.float32, "cpu", torch.Generator().manual_seed(0))[0]
    return {k: v.detach().clone() for k, v in unet.state_dict().items()}


def flax_paths(sd):
    """{port parameter name: flax path} of a UNet, found by filling each tensor with
    its own index and reading the index back off the translated tree."""
    marked = {k: np.full(v.shape, i, np.float32) for i, (k, v) in enumerate(sd.items())}
    names = list(sd)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(translate_unet(marked))[0]:
        out[names[int(np.asarray(leaf).flat[0])]] = tuple(p.key for p in path)
    assert len(out) == len(sd)
    return out


@pytest.mark.parametrize("variant", ["smoke", "smokexl"])
def test_role_of_every_parameter_matches_jax(variant):
    sd = smoke_params(variant)
    roles = {name: tp._role(name) for name in sd}
    assert roles == {name: jtp._role(path) for name, path in flax_paths(sd).items()}
    assert {"col", "row", "geglu_col", "scaled", "rep"} <= set(roles.values())


@pytest.mark.parametrize("n", [2, 4])
def test_geglu_permute_matches_jax(n):
    x = np.random.default_rng(0).normal(size=(40, 64)).astype(np.float32)  # (out=2F, in)
    ours = tp._geglu_permute(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jtp._geglu_permute(x.T, n)).T)
    np.testing.assert_array_equal(tp._geglu_permute(torch.from_numpy(x[:, 0]), n).numpy(),
                                  np.asarray(jtp._geglu_permute(x[:, 0], n)))


def jax_slice(tree, specs, n, rank):
    """A JAX tree sliced for ``rank`` as shard_map slices it by ``specs``."""
    def cut(x, spec):
        x = np.asarray(x)
        for axis, name in enumerate(spec):
            if name is not None:
                w = x.shape[axis] // n
                x = np.take(x, range(rank * w, (rank + 1) * w), axis=axis)
        return x

    return jax.tree.map(cut, tree, specs,
                        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["smoke", "smokexl"])
def test_tp_shards_match_jax(variant, n):
    """Each rank's prepared and sliced UNet weights equal the JAX ones (GEGLU
    re-blocking, the divided row-parallel biases, rows for "col", columns for "row")."""
    sd = smoke_params(variant)
    jtree = jtp.tp_prepare_params(translate_unet({k: v.numpy() for k, v in sd.items()}), n)
    specs = jtp.tp_param_specs(jtree)
    prepared = tp.tp_prepare_params(sd, n)
    for rank in range(n):
        want = flax_to_torch_unet(jax_slice(jtree, specs, n, rank))
        ours = tp.tp_shard_params(prepared, n, rank)
        assert set(ours) == set(want)
        for k, v in ours.items():
            assert v.is_contiguous(), k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_bias_shards_match_jax(n):
    """Folded biases: q/k/v biases keep their slice of the features, contiguous;
    out_bias is divided by tp and replicated."""
    rng = np.random.default_rng(1)
    arrays = {name: [rng.normal(size=(1, 16, 32)).astype(np.float32) for _ in range(4)]
              for name in ("a.attn1.processor", "b.attn2.processor")}
    arrays["b.attn2.processor"][1:3] = [None, None]  # a cross attention: no k/v bias
    jb = {k: JFoldedBias(*v) for k, v in arrays.items()}
    jprep = jtp.tp_prepare_biases(jb, n)
    specs = jtp.tp_bias_specs(jprep)
    ours = tp.tp_prepare_biases({k: FoldedBias(*(None if a is None else torch.from_numpy(a)
                                                 for a in v)) for k, v in arrays.items()}, n)
    for rank in range(n):
        shard = tp.tp_shard_biases(ours, n, rank)
        for name, fb in jprep.items():
            for field in ("q_bias", "k_bias", "v_bias", "out_bias"):
                ref, got = getattr(fb, field), getattr(shard[name], field)
                if ref is None:
                    assert got is None
                    continue
                spec = getattr(specs[name], field)
                want = jax_slice(ref, spec, n, rank) if spec != jax.sharding.PartitionSpec() \
                    else np.asarray(ref)
                assert got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name}.{field}")


CONFIGS = {"smoke": (zoo.SMOKE_UNET, jzoo.SMOKE_UNET),
           "smoke2": (zoo.SMOKE2_UNET, jzoo.SMOKE2_UNET),
           "smokexl": (zoo.SMOKEXL_UNET, jzoo.SMOKEXL_UNET),
           "sd15": (zoo.VARIANTS["sd15"][0], jzoo.UNetConfig()),
           "sd21": (zoo.SD21_UNET, jzoo.SD21_UNET),
           "sdxl": (zoo.SDXL_UNET, jzoo.SDXL_UNET)}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_validate_tp_matches_jax(name, n):
    ours, theirs = CONFIGS[name]

    def verdict(fn, cfg):
        try:
            fn(cfg, n)
        except ValueError as e:
            return str(e)
        return None

    assert verdict(tp.validate_tp, ours) == verdict(jtp.validate_tp, theirs)


def test_sdxl_level0_does_not_constrain():
    """SDXL's 5-head level 0 has no attention: model=2 passes; SD2.1's does."""
    tp.validate_tp(zoo.SDXL_UNET, 2)
    with pytest.raises(ValueError, match=r"heads=5 \(level 0\)"):
        tp.validate_tp(zoo.SD21_UNET, 2)


def test_single_process_is_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert distributed.maybe_initialize_distributed("gloo") is False
    assert distributed.is_main() and distributed.world_size() == 1
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda") == "nccl"


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """nccl needs a card per rank: with none here, two ranks raise (and no group
    starts), never falling back to gloo."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="one CUDA device per rank: 2 ranks"):
        distributed.maybe_initialize_distributed()
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.maybe_initialize_distributed("mpi")
    assert not torch.distributed.is_initialized()
