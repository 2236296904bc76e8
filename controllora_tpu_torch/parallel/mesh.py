"""Rank meshes over torch.distributed (counterpart of ``controllora_tpu/parallel/mesh.py``).

A JAX mesh places devices on named axes and lets ``shard_map`` slice arrays over
them. Here each rank is one process on one device, and a ``Mesh`` is what a rank
needs to play its part: the axis names and sizes, its coordinate on each axis, and
one process group per axis slice (the ranks that differ on that axis only), over
which the pipeline and the trainer make their collectives explicitly. The ranks
tile the mesh in row-major order, the last axis innermost, as ``np.reshape`` lays
out the JAX package's device arrays.

``make_serving_mesh`` and ``build_serving_mesh`` (``scripts/sample.py``'s
``--serving_mesh`` grammar) tile and refuse as the JAX functions do, with a world
size in place of the device list.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from controllora_tpu_torch.parallel.distributed import world_size


def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """``shape`` ranks on ``axis_names`` (``ranks``: the global ranks in row-major
    order, default 0..n-1). Built on every rank of the process group, in the same
    order, since every rank must create every group; a rank outside ``ranks`` holds
    no coordinate (``member`` False). Without a process group (one process, or the
    tests' shape checks) the groups are absent and the collectives of a size-1 axis
    are identities."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in shape)
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.sizes} for axes {self.axis_names}")
        n = math.prod(self.sizes)
        self.ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(self.ranks) != n:
            raise ValueError(f"{len(self.ranks)} ranks cannot tile a mesh of {self.sizes}")
        self.rank = dist.get_rank() if _dist_on() else 0
        self.member = self.rank in self.ranks
        grid = np.array(self.ranks).reshape(self.sizes)
        self.coords: Dict[str, int] = {}
        if self.member:
            at = np.argwhere(grid == self.rank)[0]
            self.coords = {a: int(c) for a, c in zip(self.axis_names, at)}
        self._groups: Dict[str, Any] = {}
        self._all = None
        if _dist_on() and dist.get_world_size() > 1:
            for i, axis in enumerate(self.axis_names):
                if self.sizes[i] == 1:
                    continue
                for line in np.moveaxis(grid, i, -1).reshape(-1, self.sizes[i]):
                    group = dist.new_group(line.tolist())
                    if self.rank in line:
                        self._groups[axis] = group
            if n > 1 and self.ranks != list(range(dist.get_world_size())):
                group = dist.new_group(self.ranks)
                self._all = group if self.member else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> int:
        return math.prod(self.sizes)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def rows(self, n: int, axis: str = "data") -> slice:
        """This rank's rows of a batch of ``n`` sharded over ``axis``."""
        d = self.size(axis)
        if n % d:
            raise ValueError(f"a batch of {n} does not divide over the {d} ranks of "
                             f"the '{axis}' axis")
        per = n // d
        return slice(self.coord(axis) * per, (self.coord(axis) + 1) * per)

    # ------------------------------------------------------------------ collectives

    def all_reduce(self, t: torch.Tensor, axis: str, mean: bool = False) -> torch.Tensor:
        """The fp32 sum (or mean) of ``t`` over ``axis``, a new tensor. Summed in fp32
        whatever ``t``'s dtype, as a psum of fp32 partials; gloo carries a CUDA tensor
        through the host."""
        out = t.to(torch.float32, copy=True)
        size = self.size(axis)
        if size > 1:
            dist.all_reduce(out, dist.ReduceOp.SUM, group=self.group(axis))
            if mean:
                out /= size
        return out

    def all_gather_object(self, obj, axis: str) -> List[Any]:
        """Every rank's ``obj`` along ``axis``, in coordinate order (pickled through
        the host, so any backend carries it)."""
        if self.size(axis) == 1:
            return [obj]
        out = [None] * self.size(axis)
        dist.all_gather_object(out, obj, group=self.group(axis))
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite ``t`` in place with the first rank's copy, over the whole mesh."""
        if self.devices > 1 and _dist_on():
            dist.broadcast(t, self.ranks[0], group=self._all)
        return t

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the mesh (a MAX over a host int)."""
        if self.devices == 1 or not _dist_on():
            return bool(flag)
        t = torch.tensor([int(bool(flag))])
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self._all)
        return bool(t.item())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over all ranks (or the given ones). Default: 1-D data parallel."""
    ranks = list(range(world_size())) if ranks is None else list(ranks)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    return Mesh(shape, axis_names, ranks)


def make_serving_mesh(ranks: Union[None, int, Sequence[int]] = None, cfg: bool = True,
                      model: int = 1) -> Mesh:
    """Serving mesh with up to three axes ('data', 'cfg', 'model'), tiled as the JAX
    ``make_serving_mesh``: 'data' shards the image batch, 'cfg' (size 2) splits the
    [uncond || cond] pair (one eps all-reduce a step), 'model' (``model=k``) shards the
    UNet's transformer blocks (``parallel/tp.py``), innermost. An odd rank count or
    ``cfg=False`` without ``model`` gives pure data parallelism. ``ranks``: a world
    size, a list of global ranks, or None for every rank."""
    if ranks is None:
        ranks = world_size()
    ranks = list(range(ranks)) if isinstance(ranks, int) else list(ranks)
    n = len(ranks)
    if model > 1:
        if n % (2 * model if cfg else model):
            raise ValueError(f"{n} devices cannot tile (data, "
                             f"{'cfg=2, ' if cfg else ''}model={model})")
        if cfg:
            return make_mesh((n // (2 * model), 2, model), ("data", "cfg", "model"), ranks)
        return make_mesh((n // model, model), ("data", "model"), ranks)
    if cfg and n > 1 and n % 2 == 0:
        return make_mesh((n // 2, 2), ("data", "cfg"), ranks)
    return make_mesh(ranks=ranks)


def build_serving_mesh(spec: Optional[str], world: Optional[int] = None) -> Optional[Mesh]:
    """``--serving_mesh`` 'data' | 'cfg' | 'cfg,model=K' | 'data,cfg,model=K' -> Mesh or
    None (``scripts/sample.py``'s grammar and messages). With 'data' listed, spare
    ranks fall to the data axis; without it only the latency axes take ranks (the
    first 2 * K), so the one-image-per-call loop shards with no batch constraint, and
    the other ranks stay outside the mesh. ``world``: default, the process group's."""
    if not spec:
        return None
    cfg, model, saw_data = False, 1, False
    for t in (t.strip() for t in spec.split(",") if t.strip()):
        if t == "data":
            saw_data = True
        elif t == "cfg":
            cfg = True
        elif t.startswith("model="):
            model = int(t.split("=", 1)[1])
        elif t == "model":
            model = 2
        else:
            raise SystemExit(f"unknown serving mesh axis {t!r} "
                             "(want data | cfg | model=K)")
    world = world_size() if world is None else int(world)
    if not cfg and model == 1:
        return make_mesh(ranks=range(world))  # pure data-parallel
    ranks = list(range(world))
    if not saw_data:
        need = (2 if cfg else 1) * model
        if world < need:
            raise SystemExit(f"serving mesh '{spec}' needs {need} devices, have {world}")
        ranks = ranks[:need]
    return make_serving_mesh(ranks, cfg=cfg, model=model)


def _take(x, rows):
    if isinstance(x, dict):
        return {k: _take(v, rows) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        return type(x)(_take(v, rows) for v in x)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x[rows]
    return x


def shard_batch(batch, mesh: Optional[Mesh], axis: str = "data"):
    """This rank's rows of a global host batch (a dict, list or array tree with the
    batch leading), as the JAX ``shard_batch`` places them over ``axis``."""
    if mesh is None or mesh.size(axis) == 1:
        return batch
    leaves = [v for v in (batch.values() if isinstance(batch, dict) else [batch])
              if isinstance(v, (np.ndarray, torch.Tensor))]
    return _take(batch, mesh.rows(len(leaves[0]), axis))


def replicate(tree, mesh: Optional[Mesh]):
    """Make every tensor of ``tree`` (a module, a dict, a list) equal the first rank's
    copy, in place (a broadcast over the mesh); returns ``tree``."""
    if mesh is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            if isinstance(t, torch.Tensor):
                mesh.broadcast_(t.data)
    return tree
