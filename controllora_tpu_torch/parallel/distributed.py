"""Process-group start-up (counterpart of ``controllora_tpu/parallel/distributed.py``).

The JAX package connects hosts with ``jax.distributed.initialize``; here every rank is
one process, started by ``torch.distributed.run`` (torchrun) or by the caller, and the
ranks meet in ``torch.distributed.init_process_group``. The backend is the caller's
choice, never a fallback: ``nccl`` gives each rank a card of its own
(``cuda:LOCAL_RANK``); ``gloo`` is for the CPU, or for several ranks sharing one card,
where its collectives carry CUDA tensors through the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 init_method: Optional[str] = None,
                                 rank: Optional[int] = None,
                                 world_size: Optional[int] = None) -> bool:
    """Join the process group when this process is one of several ranks.

    The ranks come from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from ``rank`` and
    ``world_size`` with an explicit ``init_method`` (``file://<path>`` or
    ``tcp://host:port``). Returns False, and starts nothing, in a single process.
    ``backend`` defaults to ``nccl``, which needs one card per rank on this host and
    raises when there are fewer; pass ``gloo`` for the CPU or a shared card. On a CUDA
    machine each rank's current device becomes ``cuda:LOCAL_RANK`` (modulo the cards
    with gloo), so ``"cuda"`` names it."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if local_world > cards:
            raise RuntimeError(
                f"the nccl backend needs one CUDA device per rank: {local_world} ranks "
                f"on this host, {cards} device(s). Start fewer ranks, or pass "
                "--dist_backend gloo to share a card (or to run on the CPU)")
        torch.cuda.set_device(local_rank)
    elif cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process writes the run's files: rank 0, or a single process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def add_dist_args(p: argparse.ArgumentParser) -> None:
    """The CLIs' process-group flag (torchrun supplies the ranks and the rendezvous)."""
    p.add_argument("--dist_backend", type=str, default=None, choices=BACKENDS,
                   help="collective backend under torchrun: nccl (default on the card, "
                        "one card per rank) or gloo (default with --device cpu; also "
                        "for ranks sharing one card)")


def start(args) -> bool:
    """Join the process group over ``--dist_backend`` when this process is one of
    several ranks; returns whether this call started it (and so should end it)."""
    started = not dist.is_initialized()
    joined = maybe_initialize_distributed(args.dist_backend or default_backend(args.device))
    return started and joined


def stop(started: bool) -> None:
    if started:
        dist.destroy_process_group()


def default_backend(device: str) -> str:
    """The CLIs' ``--dist_backend`` default: gloo on the CPU, nccl on the card."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"
