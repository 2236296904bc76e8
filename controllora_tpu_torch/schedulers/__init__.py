from controllora_tpu_torch.schedulers.common import DiffusionSchedule  # noqa: F401
from controllora_tpu_torch.schedulers.ddpm import DDPMScheduler  # noqa: F401
from controllora_tpu_torch.schedulers.dpmsolver import (  # noqa: F401
    DPMSolverMultistepScheduler,
)
