from controllora_tpu_torch.pipelines.text_to_image import (  # noqa: F401
    StableDiffusionControlLoRAPipeline,
)
