"""DreamBooth-LoRA trainer CLI for the PyTorch port (counterpart of
``scripts/train_dreambooth.py``, with its flag names, defaults and semantics for the
flags it takes): a plain rank-r LoRA on every attention layer of the frozen UNet,
optionally with prior preservation, saved in diffusers' attn-procs format
(``pytorch_lora_weights.safetensors`` and ``.bin``).

    python -m controllora_tpu_torch.train_dreambooth --model_variant smoke \
        --instance_data_dir <dir of images> --instance_prompt "a sks toy" \
        --resolution 64 --max_train_steps 5 --output_dir /tmp/db --device cpu

There are no pretrained weights in the repository: the frozen stack gets seeded
random weights (``models/zoo.py``). ``--sample_class_images`` fills
``--class_data_dir`` up to ``--num_class_images`` with unguided 25-step renders of
``--class_prompt`` from the frozen stack. ``--max_train_steps`` counts optimizer
updates; with ``--gradient_accumulation_steps N`` each takes N micro-batches. At the
end of every ``--validation_epochs``-th epoch, and once after training, the
``--validation_prompt`` is rendered with the current LoRA folded into the UNet
(``extra_loras``). Every ``--checkpointing_steps`` updates the train state goes to
``checkpoint-<step>`` with the LoRA's ``.safetensors`` beside it;
``--resume_from_checkpoint latest`` continues (params, optimizer, schedule, noise and
the data stream). ``--pretrained_model_name_or_path`` loads the frozen stack from a
local diffusers-layout directory (and requires the real CLIP BPE vocab,
``$CLIP_VOCAB_DIR``); without it the stack gets seeded random weights. Left out:
``--push_to_hub`` and the ``--hub_*`` flags (no network).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import time

import numpy as np
import torch

from controllora_tpu_torch.training.trainer import LR_SCHEDULES
from controllora_tpu_torch.utils.logging import REPORT_TO, MetricsLogger

WEIGHTS = "pytorch_lora_weights"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="local diffusers-layout checkpoint directory (unet/, vae/, "
                        "text_encoder[_2]/); omit for seeded random weights")
    p.add_argument("--model_variant", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl", "smoke", "smoke2", "smokexl"])
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--mixed_precision", type=str, default="bf16", choices=["no", "bf16"])
    p.add_argument("--instance_data_dir", type=str, required=True)
    p.add_argument("--instance_prompt", type=str, required=True)
    p.add_argument("--class_data_dir", type=str, default=None)
    p.add_argument("--class_prompt", type=str, default=None)
    p.add_argument("--with_prior_preservation", action="store_true")
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    p.add_argument("--num_class_images", type=int, default=100)
    p.add_argument("--sample_class_images", action="store_true",
                   help="render the missing class images with the frozen stack")
    p.add_argument("--sample_batch_size", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="optimizer updates; overrides --num_train_epochs when set")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="rematerialise the UNet in the backward")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant", choices=LR_SCHEDULES)
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--output_dir", type=str, default="dreambooth-lora")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' (in --output_dir) or a directory of checkpoint-<step>")
    p.add_argument("--validation_prompt", type=str, default=None)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--validation_epochs", type=int, default=50)
    p.add_argument("--report_to", type=str, default="jsonl", choices=list(REPORT_TO))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    return p.parse_args(argv)


def save_lora(out_dir: str, state_dict, formats=("safetensors", "bin")) -> None:
    """The LoRA's attn-procs state dict as ``pytorch_lora_weights.<format>``."""
    from controllora_tpu_torch.utils.convert import save_state_dict

    os.makedirs(out_dir, exist_ok=True)
    for fmt in formats:
        save_state_dict(state_dict, os.path.join(out_dir, f"{WEIGHTS}.{fmt}"))


def sample_class_images(args, pipeline) -> int:
    """Unguided renders of --class_prompt until --class_data_dir holds
    --num_class_images images (class-<i>.png); returns how many were made."""
    from controllora_tpu_torch.utils.png import encode_png

    os.makedirs(args.class_data_dir, exist_ok=True)
    existing = len(os.listdir(args.class_data_dir))
    gen = torch.Generator().manual_seed(args.seed)
    i = existing
    while i < args.num_class_images:
        n = min(args.sample_batch_size, args.num_class_images - i)
        for img in pipeline(args.class_prompt, num_images=n, num_inference_steps=25,
                            height=args.resolution, width=args.resolution, generator=gen):
            with open(os.path.join(args.class_data_dir, f"class-{i}.png"), "wb") as f:
                f.write(encode_png(img))
            i += 1
    return i - existing


def main(argv=None):
    args = parse_args(argv)
    from controllora_tpu_torch.data.dreambooth import DreamBoothDataset
    from controllora_tpu_torch.data.registry import batch_iterator
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.training.checkpoint import Checkpointer, restore_train_state
    from controllora_tpu_torch.training.dreambooth import DreamBoothLoRATrainer
    from controllora_tpu_torch.training.trainer import make_optimizer, to_device_batch

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    accum = max(args.gradient_accumulation_steps, 1)
    gen = torch.Generator(device).manual_seed(args.seed)
    unet, vae, text = zoo.frozen_stack(args.pretrained_model_name_or_path,
                                       args.model_variant, dtype, device, gen)
    print(f"device {device}; frozen {args.model_variant} stack " + (
        f"from {args.pretrained_model_name_or_path}" if args.pretrained_model_name_or_path
        else f"is random (seed {args.seed}): no pretrained weights given"), flush=True)
    tokenizer = default_tokenizer(require_clip=bool(args.pretrained_model_name_or_path))
    pipe = StableDiffusionControlLoRAPipeline(unet, vae, text, tokenizer, device=device)

    if args.with_prior_preservation and args.sample_class_images:
        t0 = time.perf_counter()
        made = sample_class_images(args, pipe)
        print(f"generated {made} class images in {time.perf_counter() - t0:.1f} s",
              flush=True)

    prior = args.with_prior_preservation
    dataset = DreamBoothDataset(
        tokenizer, instance_data_dir=args.instance_data_dir,
        instance_prompt=args.instance_prompt,
        class_data_dir=args.class_data_dir if prior else None,
        class_prompt=args.class_prompt if prior else None,
        resolution=args.resolution, center_crop=args.center_crop, seed=args.seed)
    # an epoch is one pass over the instance images; --max_train_steps wins
    steps_per_epoch = max(math.ceil(len(dataset) / args.train_batch_size / accum), 1)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch

    lr = args.learning_rate
    if args.scale_lr:
        lr = lr * accum * args.train_batch_size
    trainer = DreamBoothLoRATrainer(
        unet, vae, text, rank=args.lora_rank, with_prior_preservation=prior,
        prior_loss_weight=args.prior_loss_weight, remat_unet=args.gradient_checkpointing,
        generator=gen)
    optimizer = make_optimizer(
        trainer.params, learning_rate=lr, beta1=args.adam_beta1, beta2=args.adam_beta2,
        weight_decay=args.adam_weight_decay, eps=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, lr_schedule=args.lr_scheduler,
        warmup_steps=args.lr_warmup_steps, total_steps=max_steps,
        grad_accumulation_steps=accum, use_8bit=args.use_8bit_adam,
        num_cycles=args.lr_num_cycles, power=args.lr_power)
    trainer.optimizer = optimizer
    step_gen = torch.Generator(device).manual_seed(args.seed + 1)

    start_step = 0
    if args.resume_from_checkpoint:
        where = (args.output_dir if args.resume_from_checkpoint == "latest"
                 else args.resume_from_checkpoint)
        state, start_step = restore_train_state(where, "latest")
        if state is None:
            print("no checkpoint found; starting fresh", flush=True)
        else:
            trainer.load_state_dict({k: v.numpy() for k, v in state["params"].items()})
            optimizer.load_state_dict(state["optimizer"])
            step_gen.set_state(state["generator"])
            print(f"resumed from step {start_step}", flush=True)
    batches = batch_iterator(dataset, args.train_batch_size, seed=args.seed,
                             start_step=start_step * accum)
    logger = MetricsLogger(args.output_dir, args.report_to)

    def validation(tag, at, n_images):
        vgen = torch.Generator().manual_seed(args.seed)
        for i in range(n_images):
            img = pipe(args.validation_prompt, num_inference_steps=25,
                       height=args.resolution, width=args.resolution, generator=vgen,
                       extra_loras=trainer.loras)[0]
            logger.log_image(at, f"{tag}_{i}", img)
        print(f"{tag}: {n_images} images at step {at}", flush=True)

    checkpointer = Checkpointer()
    last_saved = start_step if start_step else -1

    def save_checkpoint(at_step):
        nonlocal last_saved
        last_saved = at_step
        params = {k: torch.from_numpy(v) for k, v in trainer.state_dict().items()}
        checkpointer.save(args.output_dir, at_step,
                          {"step": at_step, "params": params,
                           "optimizer": optimizer.state_dict(),
                           "generator": step_gen.get_state()},
                          None, keep=args.checkpoints_total_limit,
                          artifact=lambda d, p: save_lora(d, p, ("safetensors",)))
        print(f"saved checkpoint-{at_step}", flush=True)

    stop = {"sig": None}

    def request_stop(signum, frame):
        if stop["sig"] is not None:
            raise KeyboardInterrupt(f"second signal {signum}; aborting")
        stop["sig"] = signum
        print(f"received {signal.Signals(signum).name}; checkpointing and exiting "
              "after the current step", flush=True)

    prev_handlers = {s: signal.signal(s, request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    n_params = sum(p.numel() for p in trainer.params)
    print(f"LoRA params: {n_params / 1e6:.2f}M | batch {args.train_batch_size} | lr {lr} | "
          f"{max_steps} updates ({steps_per_epoch}/epoch)", flush=True)
    seen_epochs = set()
    try:
        t_last = time.perf_counter()
        for micro in range(start_step * accum, max_steps * accum):
            raw = next(batches)
            batch = {"pixel_values": raw["pixel_values"], "input_ids": raw["input_ids"]}
            if prior:  # instance rows, then class rows
                batch = {k: np.concatenate([raw[k], raw[f"class_{k}"]]) for k in batch}
            metrics = trainer.train_step(to_device_batch(batch, device), step_gen)
            if (micro + 1) % accum:
                continue  # mid-accumulation: no update yet
            step = (micro + 1) // accum
            if step % args.log_every == 0 or step == max_steps:
                loss = float(metrics["loss"])
                now = time.perf_counter()
                dt = (now - t_last) / (step % args.log_every or args.log_every)
                t_last = now
                logger.log(step, {"train_loss": loss, "steps_per_sec": 1 / dt})
                print(f"step {step}: loss={loss:.4f} {dt * 1e3:.1f} ms/step", flush=True)
            if args.checkpointing_steps and step % args.checkpointing_steps == 0:
                save_checkpoint(step)
            # validation at the end of each epoch with epoch % N == 0 (0-indexed)
            epoch = step // steps_per_epoch - 1
            if (args.validation_prompt and step % steps_per_epoch == 0
                    and epoch % max(args.validation_epochs, 1) == 0
                    and epoch not in seen_epochs):
                seen_epochs.add(epoch)
                validation("validation", step, args.num_validation_images)
                t_last = time.perf_counter()
            if stop["sig"] is not None:
                if last_saved != step:
                    save_checkpoint(step)
                checkpointer.finalize()
                print(f"preempted at step {step}; relaunch with "
                      "--resume_from_checkpoint latest to continue", flush=True)
                return
        checkpointer.finalize()
        save_lora(args.output_dir, trainer.state_dict())
        print(f"saved LoRA weights to {args.output_dir}", flush=True)
        if args.validation_prompt and args.num_validation_images > 0:
            validation("test", max_steps, args.num_validation_images)
    finally:
        logger.close()
        for s, h in prev_handlers.items():
            signal.signal(s, h)


if __name__ == "__main__":
    main()
