"""Annotators of the port (counterpart of ``controllora_tpu/annotators``): what is
ported so far, the Canny detector and the image utilities. OpenPose, HED, MLSD, MiDaS
and UniFormer are still to port (ROADMAP.md)."""

from controllora_tpu_torch.annotators.canny import CannyDetector, canny  # noqa: F401
from controllora_tpu_torch.annotators.util import HWC3, resize_image  # noqa: F401
