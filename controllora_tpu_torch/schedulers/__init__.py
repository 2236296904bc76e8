from controllora_tpu_torch.schedulers.common import DiffusionSchedule  # noqa: F401
from controllora_tpu_torch.schedulers.ddim import DDIMScheduler  # noqa: F401
from controllora_tpu_torch.schedulers.ddpm import DDPMScheduler  # noqa: F401
from controllora_tpu_torch.schedulers.dpmsolver import (  # noqa: F401
    DPMSolverMultistepScheduler,
)
from controllora_tpu_torch.schedulers.euler import EulerDiscreteScheduler  # noqa: F401
from controllora_tpu_torch.schedulers.pndm import PNDMScheduler  # noqa: F401
from controllora_tpu_torch.schedulers.unipc import UniPCMultistepScheduler  # noqa: F401
