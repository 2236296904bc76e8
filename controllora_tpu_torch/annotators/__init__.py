"""Annotators of the port (counterpart of ``controllora_tpu/annotators``): Canny,
OpenPose, HED, MLSD, MiDaS and UniFormer detectors and the image utilities. The
detectors run on ``device="cuda"`` unless asked for the CPU."""

from controllora_tpu_torch.annotators.canny import CannyDetector, canny  # noqa: F401
from controllora_tpu_torch.annotators.util import HWC3, resize_image  # noqa: F401
from controllora_tpu_torch.annotators.hed import HEDdetector, nms  # noqa: F401
from controllora_tpu_torch.annotators.midas import MidasDetector  # noqa: F401
from controllora_tpu_torch.annotators.mlsd import MLSDdetector  # noqa: F401
from controllora_tpu_torch.annotators.openpose import OpenposeDetector  # noqa: F401
from controllora_tpu_torch.annotators.uniformer import UniformerDetector  # noqa: F401
