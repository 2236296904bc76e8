"""ControlLoRA training in PyTorch (counterpart of ``controllora_tpu/training``)."""
