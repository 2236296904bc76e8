"""Column datasets (counterpart of ``controllora_tpu/data/hf_dataset.py``): train from
a ``datasets.Dataset`` with (image, guide, text) columns, the reference's non-registry
data path (reference train_text_to_image_control_lora.py:592-635: column mapping,
transforms, a synchronised random crop).

The dataset is given in memory, or loaded from a local directory (an imagefolder)
or a local dataset script by name. The ``datasets`` package is imported only then;
the card's machine does not have it. Names of hub datasets need the network, which
the port does not use.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from controllora_tpu_torch.data.process_datasets import _rand_crop_pair, _resize_short
from controllora_tpu_torch.data.registry import DatasetBase


class HFImageGuideDataset(DatasetBase):
    """A ``datasets.Dataset`` with the reference's column selection: the first three
    columns are (image, guide, text) unless ``image_column`` / ``guide_column`` /
    ``caption_column`` name others."""

    name = ""  # not in the registry: built explicitly

    def __init__(self, tokenizer=None, dataset=None, dataset_name: Optional[str] = None,
                 dataset_config_name: Optional[str] = None, split: str = "train",
                 resolution: int = 512, image_column: Optional[str] = None,
                 guide_column: Optional[str] = None, caption_column: Optional[str] = None,
                 seed: int = 0, max_train_samples: Optional[int] = None, **_):
        if tokenizer is None:
            from controllora_tpu_torch.data.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        if dataset is None:
            if dataset_name is None:
                raise ValueError("need dataset or dataset_name")
            from datasets import load_dataset

            if os.path.isdir(dataset_name):
                dataset = load_dataset("imagefolder",
                                       data_files={"train": f"{dataset_name}/**"})[split]
            else:
                dataset = load_dataset(dataset_name, dataset_config_name)[split]
        self.ds = dataset
        cols = list(self.ds.column_names)
        self.image_column = image_column or cols[0]
        self.guide_column = guide_column or cols[1]
        self.caption_column = caption_column or cols[2]
        for c in (self.image_column, self.guide_column, self.caption_column):
            if c not in cols:
                raise ValueError(f"column {c!r} not in {cols}")
        self.resolution = resolution
        self.seed = seed
        self.size = min(len(self.ds), max_train_samples or len(self.ds))

    def __len__(self) -> int:
        return self.size

    def getitem_u8(self, idx: int) -> Dict[str, np.ndarray]:
        """The decoded, resized and cropped sample with its pixels still uint8 (the
        native data plane converts whole batches in C)."""
        rng = np.random.default_rng(self.seed * 999_983 + idx)
        rec = self.ds[int(idx)]
        img = _resize_short(np.asarray(rec[self.image_column].convert("RGB")),
                            self.resolution)
        guide = _resize_short(np.asarray(rec[self.guide_column].convert("RGB")),
                              self.resolution)
        if guide.shape != img.shape:
            guide = guide[: img.shape[0], : img.shape[1]]
        img, guide = _rand_crop_pair(img, guide, self.resolution, rng)
        caption = rec[self.caption_column]
        if isinstance(caption, (list, tuple)):  # one of several, at random
            caption = caption[int(rng.integers(0, len(caption)))]
        return {"pixel_values_u8": np.ascontiguousarray(img, np.uint8),
                "guide_values_u8": np.ascontiguousarray(guide, np.uint8),
                "input_ids": self.tokenizer([str(caption)])[0]}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        r = self.getitem_u8(idx)
        return {"pixel_values": r["pixel_values_u8"].astype(np.float32) / 127.5 - 1.0,
                "guide_values": r["guide_values_u8"].astype(np.float32) / 127.5 - 1.0,
                "input_ids": r["input_ids"]}
