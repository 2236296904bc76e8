"""Two-pass high-resolution rendering, the "hires fix" (counterpart of
``controllora_tpu/pipelines/hires.py``).

A text-to-image pass at the base size, an upscale in pixel space, then an img2img
pass at the target size: direct sampling far above the training size duplicates
subjects, while the second pass at a moderate strength keeps the base composition
and restores detail. A guide given at any size is resized for each pass, so the
ControlLoRA conditions both.

The resizes are ``utils/image.py::resize_linear``, which equals the JAX package's
``jax.image.resize(..., "linear")`` within 2e-6 on [-1, 1] images.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from controllora_tpu_torch.utils.image import resize_linear


def hires_fix(pipe, prompt: str, *, negative_prompt: str = "",
              guide: Optional[np.ndarray] = None, height: int = 512, width: int = 512,
              scale: float = 2.0, strength: float = 0.55, num_inference_steps: int = 20,
              guidance_scale: float = 9.0, generator: Optional[torch.Generator] = None,
              lora_scale: float = 1.0, return_array: bool = False, **kw):
    """Render at (height, width), upscale by ``scale``, then img2img-refine at
    ``strength`` (0.4-0.7 keeps the base composition). The target snaps to the
    UNet's granularity, the 8-px VAE grid times 2^(levels - 1) (64 px for the
    4-level UNets), so that every level's grid divides. Both passes draw from
    ``generator`` (default seed 0) in turn; extra keyword arguments go to both
    pipeline calls. Returns the second pass's images."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    grain = 8 * 2 ** (len(pipe.unet.config.block_out_channels) - 1)
    th = max(grain, int(round(height * scale / grain)) * grain)
    tw = max(grain, int(round(width * scale / grain)) * grain)

    def sized_guide(h, w):
        if guide is None:
            return None
        g = np.asarray(guide, np.float32)
        g = g[None] if g.ndim == 3 else g
        if g.shape[1:3] == (h, w):
            return g
        return resize_linear(g, h, w, pipe.device).cpu().numpy()

    common = dict(negative_prompt=negative_prompt, num_inference_steps=num_inference_steps,
                  guidance_scale=guidance_scale, generator=generator,
                  lora_scale=lora_scale, **kw)
    base = pipe(prompt, guide=sized_guide(height, width), height=height, width=width,
                return_array=True, **common)
    up = resize_linear(np.stack(base), th, tw, pipe.device).clamp(-1.0, 1.0).cpu().numpy()
    return pipe(prompt, guide=sized_guide(th, tw), image=up, strength=strength,
                return_array=return_array, **common)
