"""The numpy data layer (counterpart of ``controllora_tpu/data``): the dataset
registry, its datasets and the tokenizer, as the port's own copies."""

from controllora_tpu_torch.data.registry import DatasetBase  # noqa: F401
from controllora_tpu_torch.data.fill50k import Fill50kSynthetic  # noqa: F401
from controllora_tpu_torch.data.process_datasets import (  # noqa: F401
    DanbooruSketch,
    DiffusionDBCanny,
    MPIIPose,
)
from controllora_tpu_torch.data.dreambooth import DreamBoothDataset  # noqa: F401
