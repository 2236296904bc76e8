"""Dataset registry mirroring the reference's process/ layer (reference process/base.py).

The port's own copy of ``controllora_tpu/data/registry.py`` (numpy only):
the port imports nothing of the JAX package. tests/test_torch_standalone.py
holds the two equal.

`DatasetBase.from_name("process/<name>")` resolves registered dataset classes; datasets
yield dicts with NHWC float arrays in [-1, 1]:
  {"pixel_values": (H,W,3), "guide_values": (H,W,3), "input_ids": (77,) int32}
plus `control_channel()` and the 3-panel `cat_input` montage (target | guide | sample)
used by eval scripts (reference process/base.py:23-38).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Type

import numpy as np


class DatasetBase:
    _registry: Dict[str, Type["DatasetBase"]] = {}

    # subclasses set this
    name: str = ""
    # True when __getitem__ is a pure function of idx (enables latent caching);
    # datasets with per-access augmentation randomness must set this False
    deterministic: bool = True

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.name:
            DatasetBase._registry[f"process/{cls.name}"] = cls

    @classmethod
    def from_name(cls, name: str) -> Type["DatasetBase"]:
        if name not in cls._registry:
            raise KeyError(f"unknown dataset {name!r}; known: {sorted(cls._registry)}")
        return cls._registry[name]

    # ------------------------------------------------------------------ API

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def control_channel(self) -> int:
        return 3

    @staticmethod
    def cat_input(
        target: np.ndarray, guide: np.ndarray, sample: np.ndarray
    ) -> np.ndarray:
        """3-panel uint8 montage target|guide|sample from [-1,1] HWC arrays."""
        def to_u8(x):
            return np.clip((np.asarray(x) + 1.0) * 127.5, 0, 255).astype(np.uint8)

        return np.concatenate([to_u8(target), to_u8(guide), to_u8(sample)], axis=1)


def batch_iterator(
    dataset: DatasetBase,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    epochs: Optional[int] = None,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side batcher: yields stacked numpy batches forever (or for `epochs`).

    `start_step` fast-forwards the stream so a resumed run sees exactly the batches
    an uninterrupted run would at that step (the reference's skip_first_batches,
    reference train_text_to_image_control_lora.py:745-749). Because the order is a
    pure function of `seed`, skipping advances indices only — no dataset access, so
    fast-forward is O(start_step) permutation draws rather than O(start_step·batch)
    sample loads.

    Datasets smaller than one (global) batch — e.g. a 3-image DreamBooth
    instance set over an 8-device mesh — cycle: successive permutations
    concatenate until a batch fills, so every batch is full and the stream
    never starves (reference repeats tiny instance sets the same way via
    epoch-looped 1-per-device batches, train_dreambooth_lora.py:825-833)."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n == 0:
        raise ValueError("batch_iterator: empty dataset")

    def stack(idx):
        items = [dataset[int(i)] for i in idx]
        return {
            k: np.stack([it[k] for it in items]).astype(items[0][k].dtype)
            for k in items[0]
        }

    epoch = 0
    skip = start_step
    if batch_size > n:
        buf = np.empty((0,), np.int64)
        while epochs is None or epoch < epochs:
            while len(buf) < batch_size and (epochs is None or epoch < epochs):
                order = rng.permutation(n) if shuffle else np.arange(n)
                buf = np.concatenate([buf, order])
                epoch += 1
            if len(buf) < batch_size:
                break
            idx, buf = buf[:batch_size], buf[batch_size:]
            if skip > 0:
                skip -= 1
                continue
            yield stack(idx)
        if len(buf) and not drop_last and skip <= 0:
            yield stack(buf)
        return

    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            if skip > 0:
                skip -= 1
                continue
            idx = order[s : s + batch_size]
            yield stack(idx)
        epoch += 1
