"""ControlLoRA training step in PyTorch (counterpart of
``controllora_tpu/training/trainer.py``).

One step, as the JAX ``_loss_fn`` and ``make_train_step`` run it: VAE encode (a
posterior sample), DDPM noising at a random t, text encode, hint encoder -> threaded
adapters, UNet forward, MSE against the training target (optional min-SNR weight),
adapter-only backward, global-norm clip and AdamW (or its 8-bit-moment form,
``training/adam8bit.py``). The frozen stack (UNet, VAE, CLIP) runs in its own dtype
(bf16 on the card) with no gradients of its own; the ControlLoRA master weights stay
fp32. Long self-attention on the card runs the flash kernels: K2 forward and K3 + K4
backward (``ops/flash_attention.py``), or K5 under ``CONTROLLORA_FLASH_IMPL=stock``
(``ops/flash_stock.py``). The UNet is rematerialised in the backward block by
block (``remat_unet``, on by default as in the JAX trainer) under one of the JAX
``remat_policy`` names.

Randomness comes from an explicit ``torch.Generator``; ``loss`` also takes the
posterior sample, the noise and the timesteps injected, so a test can feed it the
JAX trainer's own draws.

Data parallelism (``mesh=`` with a 'data' axis; JAX ``trainer.py`` :296-325): each
rank takes its rows of the global batch; the draws are made for the GLOBAL batch
from the one generator (or given for it) and sliced to the rank's rows, so a dp step
equals a 1-process step at the global batch. After the backward, the adapter
gradients are averaged over the axis (one fp32 all-reduce of them all), and only
then clipped and stepped, so every rank holds the same parameters; the reported loss
is the mean over the ranks.

While a ``torch.profiler`` records, a step records its host spans
(``utils/spans.py``): ``train.step`` around ``train.forward`` (the loss),
``train.backward`` (gradients and their all-reduce) and ``train.optimizer`` (norm,
clip and update); ``to_device_batch`` records ``train.upload``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from controllora_tpu_torch.models.lora import cast_adapters
from controllora_tpu_torch.schedulers import DDPMScheduler
from controllora_tpu_torch.training.adam8bit import AdamW8bit
from controllora_tpu_torch.training.conditioning import resolve_text_conditioning
from controllora_tpu_torch.utils import spans

LR_SCHEDULES = ("constant", "constant_with_warmup", "linear", "cosine",
                "cosine_with_restarts", "polynomial")
REMAT_POLICIES = ("nothing", "dots", "dots_all")


# ---------------------------------------------------------------------------- schedule


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda n: init
    return lambda n: (init - end) * (1 - min(max(n, 0), steps) / steps) + end


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {steps}")
    return lambda n: init * 0.5 * (1 + math.cos(math.pi * min(n, steps) / steps))


def _join(schedules: List[Callable[[int], float]], boundaries: List[int]):
    """optax.join_schedules: past each boundary, the next schedule from 0."""

    def schedule(n: int) -> float:
        out = schedules[0](n)
        for boundary, s in zip(boundaries, schedules[1:]):
            if n >= boundary:
                out = s(n - boundary)
        return out

    return schedule


def make_lr_schedule(learning_rate: float, lr_schedule: str = "constant",
                     warmup_steps: int = 0, total_steps: int = 30_000,
                     num_cycles: int = 1, power: float = 1.0) -> Callable[[int], float]:
    """The JAX ``make_lr_schedule`` (diffusers ``get_scheduler`` names) as a
    ``LambdaLR`` factor: step -> lr(step) / learning_rate, step = updates so far."""
    if learning_rate <= 0:
        raise ValueError(f"learning_rate must be > 0, got {learning_rate}")
    lr = learning_rate
    decay_steps = max(total_steps - warmup_steps, 1)

    def with_warmup(body):
        return _join([_linear(0.0, lr, warmup_steps), body], [warmup_steps]) \
            if warmup_steps else body

    if lr_schedule in ("constant", "constant_with_warmup"):
        sched = with_warmup(lambda n: lr)
    elif lr_schedule == "cosine":
        sched = _join([_linear(0.0, lr, warmup_steps),
                       _cosine(lr, total_steps - warmup_steps)], [warmup_steps])
    elif lr_schedule == "cosine_with_restarts":
        cycles = max(num_cycles, 1)
        seg = max(decay_steps // cycles, 1)
        sched = with_warmup(_join([_cosine(lr, seg)] * cycles,
                                  [seg * (i + 1) for i in range(cycles - 1)]))
    elif lr_schedule == "polynomial":
        def poly(n):
            frac = 1 - min(max(n, 0), decay_steps) / decay_steps
            return (lr - 1e-7) * frac**power + 1e-7

        sched = with_warmup(poly)
    elif lr_schedule == "linear":
        sched = with_warmup(_linear(lr, 0.0, decay_steps))
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}; known: {LR_SCHEDULES}")
    return lambda n: sched(n) / lr


# ---------------------------------------------------------------------------- optimizer


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm), fp32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class AdapterOptimizer:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adamw(schedule))``, wrapped
    in ``MultiSteps`` when ``grad_accumulation_steps`` > 1, over torch parameters:
    ``torch.optim.AdamW`` on its default (non-fused) path, or ``AdamW8bit``
    (``use_8bit``, the JAX ``adamw8bit``), the schedule as a ``LambdaLR`` stepped once
    per update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                 beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 1e-2,
                 eps: float = 1e-8, max_grad_norm: float = 1.0,
                 lr_schedule: str = "constant", warmup_steps: int = 0,
                 total_steps: int = 30_000, grad_accumulation_steps: int = 1,
                 num_cycles: int = 1, power: float = 1.0, use_8bit: bool = False):
        self.params = list(params)
        adamw = AdamW8bit if use_8bit else torch.optim.AdamW
        self.adamw = adamw(self.params, lr=learning_rate, betas=(beta1, beta2), eps=eps,
                           weight_decay=weight_decay)
        self.schedule = LambdaLR(self.adamw, make_lr_schedule(
            learning_rate, lr_schedule, warmup_steps, total_steps, num_cycles, power))
        self.max_grad_norm = max_grad_norm
        self.accumulation = grad_accumulation_steps
        self._sum: Optional[List[torch.Tensor]] = None
        self._micro = 0

    def step(self, grads: List[torch.Tensor]) -> bool:
        """Feed one micro-batch's gradients (one per parameter, in order); returns
        whether the parameters were updated (every ``grad_accumulation_steps`` calls,
        with the mean of the accumulated gradients)."""
        if self.accumulation > 1:
            self._sum = list(grads) if self._sum is None else \
                [s + g for s, g in zip(self._sum, grads)]
            self._micro += 1
            if self._micro < self.accumulation:
                return False
            grads = [s / self.accumulation for s in self._sum]
            self._sum, self._micro = None, 0
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, g / norm * self.max_grad_norm)
        self.adamw.step()
        self.schedule.step()
        for p in self.params:
            p.grad = None
        return True

    def state_dict(self) -> Dict:
        """Moments (8-bit included), schedule position and any pending accumulation."""
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict(),
                "accumulated": self._sum, "micro": self._micro}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
        acc = state["accumulated"]
        self._sum = None if acc is None else [t.to(p.device) for t, p in zip(acc, self.params)]
        self._micro = state["micro"]


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                   beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 1e-2,
                   eps: float = 1e-8, max_grad_norm: float = 1.0,
                   lr_schedule: str = "constant", warmup_steps: int = 0,
                   total_steps: int = 30_000, grad_accumulation_steps: int = 1,
                   use_8bit: bool = False, num_cycles: int = 1,
                   power: float = 1.0) -> AdapterOptimizer:
    """AdamW (8-bit moments with ``use_8bit``) + global-norm clip with the JAX
    ``make_optimizer`` defaults."""
    return AdapterOptimizer(params, learning_rate, beta1, beta2, weight_decay, eps,
                            max_grad_norm, lr_schedule, warmup_steps, total_steps,
                            grad_accumulation_steps, num_cycles, power, use_8bit)


# ---------------------------------------------------------------------------- remat


def _save_products(products, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in products
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a JAX ``remat_policy``:
    ``nothing`` saves nothing (None: plain checkpointing); ``dots`` saves the outputs
    of the products without batch dims (``aten.mm`` / ``aten.addmm``: the
    projections, as ``dots_with_no_batch_dims_saveable``); ``dots_all`` also the
    batched ones (``aten.bmm``, as ``dots_saveable``). Everything else, convolutions
    included, is recomputed; so are the hand-written kernels, which the dispatcher
    does not see."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; known: {REMAT_POLICIES}")
    if policy == "nothing":
        return None
    aten = torch.ops.aten
    products = {aten.mm.default, aten.addmm.default}
    if policy == "dots_all":
        products.add(aten.bmm.default)
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_products, products))


# ---------------------------------------------------------------------------- batch


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch of the JAX data pipeline (NHWC images) -> tensors on ``device``
    in the port's layout (NCHW images, int64 token ids)."""
    out = {}
    with spans.span("train.upload"):
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dim() == 4:
                t = t.permute(0, 3, 1, 2)
            if k.startswith("input_ids"):
                t = t.long()
            out[k] = t.to(device, non_blocking=True).contiguous()
    return out


# ---------------------------------------------------------------------------- trainer


class AdapterTrainer:
    """What the ControlLoRA and the DreamBooth-LoRA trainers share: the frozen stack
    (UNet, VAE, text encoder, used as they are), the trainable ``params``, the DDPM
    target under ``prediction_type``, block-wise remat, the VAE latents, the
    gradients and the optimizer step. A subclass defines ``loss``.

    ``remat_unet`` / ``remat_policy``: the UNet's blocks run under
    ``torch.utils.checkpoint`` with ``remat_context(remat_policy)``, where the JAX
    trainers wrap ``unet.apply`` in ``jax.checkpoint``. One checkpoint around the
    whole UNet would save no memory here: PyTorch recomputes a checkpointed segment
    whole at the start of its backward, so every activation of the UNet would be live
    again at once (measured on the H100: the same peak as without remat). Each resnet
    and each attention block is its own segment, so the backward holds one block's
    activations at a time."""

    def __init__(self, params: List[torch.Tensor], unet, vae=None, text_encoder=None,
                 scheduler: Optional[DDPMScheduler] = None,
                 optimizer: Optional[AdapterOptimizer] = None,
                 prediction_type: Optional[str] = None, remat_unet: bool = True,
                 remat_policy: str = "dots", mesh=None):
        self.mesh = mesh
        self.dp = mesh.size("data") if mesh is not None else 1
        self.remat_unet = remat_unet
        self.remat_context = remat_context(remat_policy)
        self.unet, self.vae, self.text_encoder = unet, vae, text_encoder
        self.params = params
        self.optimizer = optimizer or make_optimizer(self.params)
        self.scheduler = scheduler or DDPMScheduler()
        if prediction_type is not None:
            self.scheduler = DDPMScheduler(dataclasses.replace(
                self.scheduler.schedule, prediction_type=prediction_type))

    def _remat(self, layer, *inputs):
        """One UNet block under ``torch.utils.checkpoint`` with the policy's context."""
        extra = {} if self.remat_context is None else {"context_fn": self.remat_context}
        return checkpoint(layer, *inputs, use_reentrant=False, **extra)

    def _latents(self, batch, generator, sample_noise):
        if "latents" in batch:
            return batch["latents"]
        if "latent_mean" in batch:
            mean = batch["latent_mean"].float()
            std = torch.exp(0.5 * batch["latent_logvar"].float())
            if sample_noise is None:
                sample_noise = torch.randn(mean.shape, generator=generator,
                                           device=mean.device)
            return (mean + std * sample_noise.float()) * self.vae.config.scaling_factor
        with torch.no_grad():  # the VAE is frozen
            return self.vae.encode(batch["pixel_values"], generator, sample_noise)

    def local_rows(self, n: int) -> torch.Tensor:
        """This rank's rows of the global batch, for a local batch of ``n``."""
        r = self.mesh.coord("data")
        return torch.arange(r * n, (r + 1) * n)

    def _latent_shape(self, batch) -> tuple:
        for key in ("latents", "latent_mean"):
            if key in batch:
                return tuple(batch[key].shape[1:])
        px, cfg = batch["pixel_values"], self.vae.config
        f = 2 ** (len(cfg.block_out_channels) - 1)
        return (cfg.latent_channels, px.shape[2] // f, px.shape[3] // f)

    def _global_draws(self, batch, generator, noise, timesteps, sample_noise):
        """The dp draws: made for the global batch in the 1-process order (posterior
        sample, noise, t) where not given, and sliced to this rank's rows."""
        first = next(v for v in batch.values() if torch.is_tensor(v))
        n, device = first.shape[0], first.device
        big = n * self.dp
        shape = (big,) + self._latent_shape(batch)
        if sample_noise is None and "latents" not in batch:
            sample_noise = torch.randn(shape, generator=generator, device=device)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        if timesteps is None:
            timesteps = torch.randint(0, self.scheduler.schedule.num_train_timesteps,
                                      (big,), generator=generator, device=device)
        rows = self.local_rows(n).to(device)
        return (None if sample_noise is None else sample_noise[rows]), noise[rows], \
            timesteps[rows]

    def _noised(self, batch, generator, noise, timesteps, sample_noise):
        """(latents, noise, t, noisy latents), fp32: the posterior sample, the noise
        and t drawn from ``generator`` in that order where they are not given (for
        the global batch under dp, then sliced)."""
        if self.dp > 1:
            sample_noise, noise, timesteps = self._global_draws(
                batch, generator, noise, timesteps, sample_noise)
        latents = self._latents(batch, generator, sample_noise).float()
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=latents.device)
        if timesteps is None:
            timesteps = torch.randint(0, self.scheduler.schedule.num_train_timesteps,
                                      (latents.shape[0],), generator=generator,
                                      device=latents.device)
        return latents, noise, timesteps, self.scheduler.schedule.add_noise(
            latents, noise, timesteps)

    def grads(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """d loss / d params (zeros for a parameter the step does not use)."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]

    def all_reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of every rank's gradients over the 'data' axis, flattened into one
        fp32 all-reduce (the identity without dp)."""
        if self.dp == 1:
            return grads
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]),
                                    "data", mean=True)
        return [f.view(g.shape).to(g.dtype)
                for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss if self.dp == 1 else self.mesh.all_reduce(loss, "data", mean=True)

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, return_grads: bool = False,
                   **draws) -> Dict[str, torch.Tensor]:
        """One optimizer step (or micro-step under accumulation); returns the loss
        and the global norm of this step's gradient (before clipping), as tensors on
        the device: reading them synchronises. Under dp, ``batch`` holds the rank's
        rows and both are the global batch's; ``return_grads`` adds the (reduced)
        gradients."""
        with spans.span("train.step"):
            with spans.span("train.forward"):
                loss = self.loss(batch, generator, **draws)
            with spans.span("train.backward"):
                grads = self.all_reduce_grads(self.grads(loss))
            with spans.span("train.optimizer"):
                grad_norm = global_norm(grads)
                self.optimizer.step(grads)
            out = {"loss": self._mean_loss(loss.detach()), "grad_norm": grad_norm}
        if return_grads:
            out["grads"] = grads
        return out

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None, **draws) -> torch.Tensor:
        return self._mean_loss(self.loss(batch, generator, **draws))


class ControlLoRATrainer(AdapterTrainer):
    """The ControlLoRA trainer (the JAX ``ControlLoRATrainer``'s surface): the
    ControlLoRA's parameters are made trainable.

    ``adapter_compute_dtype``: the adapter factors and control maps threaded into
    the UNet are cast to it (fp32 masters stay); ``hint_compute_dtype``: the hint
    encoder's convolutions compute in it (flax ``ControlLoRA(dtype=)``); remat as
    ``AdapterTrainer`` (the JAX trainer's defaults: on, ``dots``); ``mesh``: data
    parallelism as ``AdapterTrainer``."""

    def __init__(self, control_lora, unet, vae=None, text_encoder=None,
                 scheduler: Optional[DDPMScheduler] = None,
                 optimizer: Optional[AdapterOptimizer] = None,
                 prediction_type: Optional[str] = None, snr_gamma: Optional[float] = None,
                 remat_unet: bool = True, remat_policy: str = "dots",
                 adapter_compute_dtype: Optional[torch.dtype] = None,
                 hint_compute_dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__(list(control_lora.parameters()), unet, vae, text_encoder,
                         scheduler, optimizer, prediction_type, remat_unet, remat_policy,
                         mesh)
        self.control_lora = control_lora.requires_grad_(True)
        self.snr_gamma = snr_gamma
        self.adapter_compute_dtype = adapter_compute_dtype
        self.hint_compute_dtype = hint_compute_dtype

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, timesteps: Optional[torch.Tensor] = None,
             sample_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """batch: {"latents" | "latent_mean" + "latent_logvar" | "pixel_values",
        "guide_values", "input_ids" (+ "input_ids2") | "encoder_hidden_states" (+
        "pooled_text_embeds"), optionally "time_ids"}, NCHW images in [-1, 1]. Draws
        the posterior sample, the noise and t from ``generator`` in that order, unless
        they are given."""
        sch = self.scheduler
        latents, noise, timesteps, noisy = self._noised(batch, generator, noise, timesteps,
                                                        sample_noise)
        with torch.no_grad():  # the text encoder is frozen
            ctx, added = resolve_text_conditioning(batch, self.text_encoder, self.unet.config,
                                                   latents)
        adapters = self.control_lora.adapters_for(batch["guide_values"], self.unet.config,
                                                  self.hint_compute_dtype)
        if self.adapter_compute_dtype is not None:
            adapters = cast_adapters(adapters, self.adapter_compute_dtype)
        pred = self.unet(noisy, timesteps, ctx, adapters=adapters,
                         remat=self._remat if self.remat_unet else None, **added)
        loss = (pred.float() - sch.training_target(latents, noise, timesteps)) ** 2
        if self.snr_gamma is not None:
            snr = sch.schedule.snr(timesteps)
            w = torch.clamp(snr, max=self.snr_gamma) / torch.clamp(snr, min=1e-8)
            loss = loss * w[:, None, None, None]
        return loss.mean()
