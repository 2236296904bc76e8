"""PyTorch + CUDA port of ControlLoRA-TPU for NVIDIA Hopper (H100).

Mirrors the layout of ``controllora_tpu`` (the JAX reference, kept beside it): the
same module under the same path and name. Imports ``torch`` and never JAX; the
numpy-only ``controllora_tpu.config`` and ``controllora_tpu.data.tokenizer`` are
reused as they are. Hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` at their first CUDA call (``ops/flash_attention.py``).
"""

__version__ = "0.1.0"

from controllora_tpu.config import ControlLoRAConfig  # noqa: F401
