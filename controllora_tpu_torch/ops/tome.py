"""Token merging (ToMe) for serving (counterpart of ``controllora_tpu/ops/tome.py``).

The tomesd method (Bolya & Hoffman, "Token Merging for Fast Stable Diffusion"):
before a transformer block's self-attention, spatially redundant tokens are merged
by bipartite soft matching (each merged *src* token is averaged into its most
similar *dst* token, one dst per 2x2 window), attention runs on the reduced
sequence, and the output is unmerged (each merged position reads its dst's row).
At 512² with ratio 0.5 the 4096 level-0 tokens become 2048. It trades exactness
for speed and is off by default.

The bookkeeping is the JAX package's: the src/dst split comes from one stable
sort, the cosine scores are fp32, the most similar dst is the first maximum, and
the merge order is a stable sort of the best scores. Both directions go through
one index map, position -> merged row (the JAX package's inverse map): the merge is
a mean per row (one ``scatter_add_`` in fp32, cast back), the unmerge one
``gather``. Merging is linear, so it commutes with the per-token projections: the
folded serving path merges its per-position biases with the same map.

Randomness enters in one place, ``window_choice``: the dst position inside each
window, drawn from an explicit CPU ``torch.Generator`` seeded from the render's
seed, the step's timestep and index, the module's processor prefix (crc32, which
is stable across processes, unlike ``hash``) and the block index. The card and the
CPU therefore merge over the same windows. The JAX package draws from a jax PRNG
key, so the two packages choose different windows; the parity tests replace
``window_choice`` with the JAX draws.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch


# the dst grid's stride: one dst token per WINDOW x WINDOW window (tomesd's 2x2)
WINDOW = 2


@dataclasses.dataclass(frozen=True)
class ToMeConfig:
    """ratio: fraction of ALL tokens to merge (0 disables; capped at 3/4, the src
    share of a 2x2 window). min_tokens: only blocks with L >= min_tokens merge
    (default: level 0 at 512²)."""

    ratio: float = 0.5
    min_tokens: int = 4096


def merge_count(cfg: ToMeConfig, length: int) -> int:
    """Number of merged tokens for a block of `length` tokens."""
    n_dst = length // (WINDOW * WINDOW)
    return max(0, min(int(length * cfg.ratio), length - n_dst))


def maybe_tome(tome: Optional[ToMeConfig], hh: int, ww: int) -> bool:
    """Whether a block on an hh x ww token grid merges: long enough, tiles the dst
    window, and has a nonzero merge count."""
    if tome is None or tome.ratio <= 0 or hh * ww < tome.min_tokens:
        return False
    if hh % WINDOW or ww % WINDOW:
        return False
    return merge_count(tome, hh * ww) > 0


def window_choice(seed: int, timestep, index: int, prefix: str, block: int,
                  nsy: int, nsx: int) -> torch.Tensor:
    """The dst position in each window, (nsy, nsx) int64 in [0, 4), on the CPU.

    The timestep is truncated to an integer, as the JAX package truncates its float
    timesteps."""
    key = struct.pack("<qqqIq", int(seed), int(timestep), int(index),
                      zlib.crc32(prefix.encode()), int(block))
    gen = torch.Generator().manual_seed(zlib.crc32(key))
    return torch.randint(0, WINDOW * WINDOW, (nsy, nsx), generator=gen)


def build_merge(metric: torch.Tensor, hh: int, ww: int, cfg: ToMeConfig,
                choice: torch.Tensor
                ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                           Callable[[torch.Tensor], torch.Tensor], int]:
    """Bipartite-soft-matching merge/unmerge for one transformer block.

    metric: (B, L) + (C,) token features the similarity is computed on; choice:
    (hh / 2, ww / 2) dst positions in their windows (``window_choice``).
    Returns (merge, unmerge, merged_len):
      merge(x):   (B or 1, L, C') -> (B, L - r, C'), rows [unmerged srcs || dst means]
      unmerge(y): (B, L - r, C') -> (B, L, C'), merged positions read their dst row
    Both use index maps computed once from `metric`, so they apply to any tensor of
    the same length (hidden states, folded biases) with the same bookkeeping."""
    B, L, _ = metric.shape
    if hh % WINDOW or ww % WINDOW:
        raise ValueError(f"token grid {hh}x{ww} must tile the ToMe window {WINDOW}x{WINDOW}")
    r = merge_count(cfg, L)
    if r <= 0:
        return (lambda x: x), (lambda y: y), L

    dev = metric.device
    nsy, nsx = hh // WINDOW, ww // WINDOW
    n_dst = nsy * nsx
    n_src = L - n_dst
    if tuple(choice.shape) != (nsy, nsx):
        raise ValueError(f"window choice {tuple(choice.shape)} must be ({nsy}, {nsx})")
    # the src/dst split depends on the draw only: non-dst positions first, each group
    # in position order (the JAX package's stable sort), made on the host and sent in
    # one copy, which does not wait for the card
    rand = choice.numpy()
    ys = np.arange(nsy)[:, None] * WINDOW + rand // WINDOW
    xs = np.arange(nsx)[None, :] * WINDOW + rand % WINDOW
    dst_mask = np.zeros(L, bool)
    dst_mask[(ys * ww + xs).reshape(-1)] = True
    order = torch.from_numpy(np.argsort(dst_mask, kind="stable"))
    if dev.type == "cuda":
        order = order.pin_memory()
    order = order.to(dev, non_blocking=True)
    src_pos, dst_pos = order[:n_src], order[n_src:]

    mnorm = metric.float()
    mnorm = mnorm / (torch.linalg.vector_norm(mnorm, dim=-1, keepdim=True) + 1e-6)
    scores = mnorm[:, src_pos] @ mnorm[:, dst_pos].transpose(1, 2)  # (B, Ns, Nd) cosine
    node_max, node_idx = scores.max(dim=-1)  # the first maximum, as jnp.argmax
    edge_order = torch.argsort(-node_max, dim=-1, stable=True)
    merged_e, unm_e = edge_order[:, :r], edge_order[:, r:]

    # inv: position -> its row of the merged tensor [unmerged srcs || dst rows]; a
    # merged src goes to the row of its most similar dst
    inv = torch.empty((B, L), dtype=torch.long, device=dev)
    inv.scatter_(1, src_pos[unm_e], torch.arange(n_src - r, device=dev).expand(B, -1))
    inv[:, dst_pos] = n_src - r + torch.arange(n_dst, device=dev)
    inv.scatter_(1, src_pos[merged_e], n_src - r + torch.gather(node_idx, 1, merged_e))
    counts = torch.zeros((B, L - r), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, inv, torch.ones((B, L), dtype=torch.float32, device=dev))

    def rows(c):
        return inv[..., None].expand(-1, -1, c)

    def merge(x: torch.Tensor) -> torch.Tensor:
        """Each merged row is the mean of the positions that map to it, summed in fp32
        (an unmerged src is its own mean)."""
        c = x.shape[-1]
        sums = torch.zeros((B, L - r, c), dtype=torch.float32, device=dev)
        sums.scatter_add_(1, rows(c), x.float().expand(B, -1, -1))
        return (sums / counts[..., None]).to(x.dtype)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return torch.gather(y, 1, rows(y.shape[-1]))

    return merge, unmerge, L - r


__all__ = ["WINDOW", "ToMeConfig", "build_merge", "merge_count", "maybe_tome", "window_choice"]
