from controllora_tpu_torch.pipelines.hires import hires_fix  # noqa: F401
from controllora_tpu_torch.pipelines.text_to_image import (  # noqa: F401
    StableDiffusionControlLoRAPipeline,
    merge_extra_controls,
    merge_extra_loras,
)
