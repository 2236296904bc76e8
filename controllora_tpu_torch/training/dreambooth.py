"""DreamBooth-LoRA trainer (counterpart of ``controllora_tpu/training/dreambooth.py``):
a plain rank-r LoRA on every attention layer of the frozen UNet (reference
train_dreambooth_lora.py:706-722), the diffusion MSE on instance images, and with
prior preservation the batch's second half (class images) as a second MSE weighted
by ``prior_loss_weight`` (:898-910). Text and ``text_time`` conditioning come from
``training/conditioning.py``, shared with the ControlLoRA trainer; so do the latents,
the draws, remat, data parallelism and the optimizer step (``AdapterTrainer``). Under
dp with prior preservation each rank's batch is its instance rows, then its class
rows (``local_rows``), so the mean of the ranks' two-term losses is the global one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from controllora_tpu_torch.models.lora import AdapterStack, AttnAdapter, make_plain_lora_adapters
from controllora_tpu_torch.schedulers import DDPMScheduler
from controllora_tpu_torch.training.conditioning import resolve_text_conditioning
from controllora_tpu_torch.training.trainer import AdapterOptimizer, AdapterTrainer
from controllora_tpu_torch.utils.convert import attn_procs_from_torch, attn_procs_to_torch


class DreamBoothLoRATrainer(AdapterTrainer):
    """``loras``: {processor name: AttnAdapter} to train (default: fresh adapters of
    ``rank`` from ``generator`` on the UNet's device). Their factors are the trainable
    parameters, in processor order, then to_q, to_k, to_v, to_out, then down, up.
    ``remat_unet`` recomputes every UNet block in the backward (the JAX trainer's
    ``nothing_saveable``)."""

    def __init__(self, unet, vae=None, text_encoder=None, rank: int = 4,
                 scheduler: Optional[DDPMScheduler] = None,
                 optimizer: Optional[AdapterOptimizer] = None,
                 prior_loss_weight: float = 1.0, with_prior_preservation: bool = False,
                 remat_unet: bool = True, loras: Optional[Dict[str, AttnAdapter]] = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        if loras is None:
            device = next(unet.parameters()).device
            loras = make_plain_lora_adapters(
                generator or torch.Generator(device).manual_seed(0), rank, unet.config,
                device=device)
        self.loras = loras
        params = [t.requires_grad_(True) for a in loras.values()
                  for pair in a.params.values() for t in pair.values()]
        super().__init__(params, unet, vae, text_encoder, scheduler, optimizer,
                         remat_unet=remat_unet, remat_policy="nothing", mesh=mesh)
        self.prior_loss_weight = prior_loss_weight
        self.with_prior_preservation = with_prior_preservation

    def local_rows(self, n: int) -> torch.Tensor:
        """Under prior preservation the global batch is [instances || classes]: this
        rank's rows are its block of each half."""
        if not self.with_prior_preservation:
            return super().local_rows(n)
        half, r = n // 2, self.mesh.coord("data")
        inst = torch.arange(r * half, (r + 1) * half)
        return torch.cat([inst, inst + half * self.dp])

    def adapters(self) -> Dict[str, AdapterStack]:
        return {name: AdapterStack(main=a) for name, a in self.loras.items()}

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, timesteps: Optional[torch.Tensor] = None,
             sample_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """batch: {"pixel_values" | "latents", "input_ids" (+ "input_ids2") |
        "encoder_hidden_states"}, NCHW images in [-1, 1]; under prior preservation
        the instance rows first, then as many class rows. Draws as the ControlLoRA
        trainer's ``loss``."""
        latents, noise, timesteps, noisy = self._noised(batch, generator, noise, timesteps,
                                                        sample_noise)
        with torch.no_grad():  # the text encoder is frozen
            ctx, added = resolve_text_conditioning(batch, self.text_encoder,
                                                   self.unet.config, latents)
        pred = self.unet(noisy, timesteps, ctx, adapters=self.adapters(),
                         remat=self._remat if self.remat_unet else None, **added)
        err = (pred.float() - self.scheduler.training_target(latents, noise, timesteps)) ** 2
        if self.with_prior_preservation:
            instance, prior = err.chunk(2)
            return instance.mean() + self.prior_loss_weight * prior.mean()
        return err.mean()

    # ------------------------------------------------------------------ artifact

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The LoRA in diffusers' attn-procs format (numpy, fp32)."""
        return attn_procs_to_torch(self.loras)

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, np.ndarray]) -> None:
        """Copy an attn-procs state dict into the trained factors (strict)."""
        tree = attn_procs_from_torch(sd)
        if set(tree) != set(self.loras):
            raise KeyError(f"attn-procs state dict covers {len(tree)} processors, "
                           f"the LoRA has {len(self.loras)}")
        for name, a in self.loras.items():
            for proj, pair in a.params.items():
                for which, t in pair.items():
                    t.copy_(torch.from_numpy(np.asarray(tree[name][proj][which])))
