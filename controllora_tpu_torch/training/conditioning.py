"""Text and micro-conditioning of a training batch (counterpart of
``controllora_tpu/training/conditioning.py``), shared by the ControlLoRA and the
DreamBooth-LoRA trainers so that the two cannot drift.

The context is the batch's precomputed ``encoder_hidden_states`` (with
``pooled_text_embeds``), or its ``input_ids`` (and ``input_ids2`` for SDXL's second
tower) through the frozen text encoder, which returns (context, pooled) when it has
a projection head. A ``text_time`` UNet (the SDXL family) also takes the pooled
vector and the size ids: the batch's ``time_ids`` (orig_h, orig_w, crop_top,
crop_left, target_h, target_w), or by default (res, res, 0, 0, res, res) from the
latents' size, the square centre layout of this repo's pipeline.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def resolve_text_conditioning(batch: Dict[str, torch.Tensor], text_encoder, unet_config,
                              latents: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """-> (encoder context (B, 77, D), UNet added-conditioning kwargs). ``latents``
    are NCHW; their size gives the default size ids."""
    pooled = None
    if "encoder_hidden_states" in batch:
        ctx = batch["encoder_hidden_states"]
        pooled = batch.get("pooled_text_embeds")
    else:
        args = ((batch["input_ids"], batch["input_ids2"]) if "input_ids2" in batch
                else (batch["input_ids"],))
        ctx = text_encoder(*args)
        if isinstance(ctx, tuple):  # a pooled-projection tower: (ctx, pooled)
            ctx, pooled = ctx
    if unet_config.addition_embed_type != "text_time":
        return ctx, {}
    if pooled is None:
        raise ValueError(
            "text_time UNet: provide a pooled-projection text encoder "
            "(input_ids path) or pooled_text_embeds alongside "
            "encoder_hidden_states"
        )
    if "time_ids" in batch:
        tids = batch["time_ids"].float()
    else:
        res_h, res_w = latents.shape[2] * 8, latents.shape[3] * 8
        tids = torch.tensor([[res_h, res_w, 0, 0, res_h, res_w]], dtype=torch.float32,
                            device=latents.device).expand(latents.shape[0], 6)
    return ctx, dict(added_text_embeds=pooled, added_time_ids=tids)
