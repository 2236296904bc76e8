"""Text conditioning of a training batch (counterpart of
``controllora_tpu/training/conditioning.py``): precomputed ``encoder_hidden_states``,
or ``input_ids`` through the frozen text encoder. The SDXL ``text_time``
micro-conditioning serves (``pipelines/text_to_image.py``) but does not train yet
(ROADMAP Queue 1 item 9.5).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_SDXL_KEYS = ("input_ids2", "pooled_text_embeds", "time_ids")


def resolve_text_conditioning(batch: Dict[str, torch.Tensor], text_encoder,
                              unet_config) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """-> (encoder context (B, 77, D), UNet added-conditioning kwargs)."""
    sdxl = [k for k in _SDXL_KEYS if k in batch]
    if getattr(unet_config, "addition_embed_type", None) == "text_time" or sdxl:
        raise NotImplementedError(
            f"SDXL text_time conditioning ({sdxl or 'text_time UNet'}) is not ported to "
            "the PyTorch trainer yet: ROADMAP Queue 1 item 9.5")
    if "encoder_hidden_states" in batch:
        return batch["encoder_hidden_states"], {}
    return text_encoder(batch["input_ids"]), {}
