"""PyTorch + CUDA port of ControlLoRA-TPU for NVIDIA Hopper (H100).

Mirrors the layout of ``controllora_tpu`` (the JAX reference, kept beside it): the
same module under the same path and name. Imports ``torch`` and never JAX, and
nothing of the JAX package: the numpy-only modules it needs (``config``, the
tokenizer and the dataset registry under ``data/``, the key maps in
``utils/convert.py``) are its own copies. Hand-written Hopper kernels live in
``csrc/`` and are built with ``nvcc`` at their first CUDA call
(``ops/flash_attention.py``). Entry points run on the card unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"

from controllora_tpu_torch.config import ControlLoRAConfig  # noqa: F401
