"""ControlLoRA trainer CLI for the PyTorch port (counterpart of ``scripts/train.py``,
with that script's flag names and defaults for the subset it takes).

    python -m controllora_tpu_torch.train --model_variant smoke --resolution 64 \
        --train_batch_size 2 --max_train_steps 3 --output_dir /tmp/run --device cpu

There are no pretrained weights in the repository: the frozen stack (UNet, VAE,
CLIP) gets seeded random weights (``models/zoo.py``), and so does the hint encoder.
Data comes from the JAX package's numpy-only registry (``process/<name>``,
``batch_iterator``). The run ends by writing the adapter artifact
(``training/checkpoint.py``) to ``--output_dir``. Flags of ``scripts/train.py`` not
taken here, and the options that raise, are listed in ROADMAP.md (Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import math
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_variant", type=str, default="sd15", choices=["sd15", "smoke"])
    p.add_argument("--control_lora_config", type=str, default="base",
                   help="preset name or reference-format JSON path")
    p.add_argument("--mixed_precision", type=str, default="bf16", choices=["no", "bf16"],
                   help="frozen-stack and hint-encoder compute dtype (adapters fp32)")
    p.add_argument("--adapter_compute_bf16", action="store_true",
                   help="cast the adapter factors to bf16 for the forward/backward "
                        "(fp32 master params and optimizer state)")
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--dataset_name", type=str, default="process/fill50k")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="overrides --num_train_epochs when set")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="not ported yet: raises (ROADMAP)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="UNet remat; not ported yet: raises (ROADMAP)")
    p.add_argument("--output_dir", type=str, default="control-lora-model")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    return p.parse_args(argv)


def build_control_config(args, unet_config):
    """The ControlLoRA config: the named preset, or for the smoke variant the JAX
    CLI's reduced config with slot counts derived from the UNet."""
    from controllora_tpu.config import ControlLoRAConfig, load_config
    from controllora_tpu_torch.models.unet import derive_cross_attention_dims

    cfg = load_config(args.control_lora_config)
    if args.model_variant == "smoke":
        cfg = ControlLoRAConfig(
            block_out_channels=(8, 16, 16, 32),
            lora_block_in_channels=(32, 32, 32, 32),
            lora_block_out_channels=unet_config.block_out_channels,
            lora_cross_attention_dims=derive_cross_attention_dims(unet_config),
            lora_control_version=cfg.lora_control_version,
        )
    return cfg


def main(argv=None):
    args = parse_args(argv)
    from controllora_tpu.data.registry import DatasetBase, batch_iterator
    from controllora_tpu.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.training.trainer import (
        ControlLoRATrainer,
        make_optimizer,
        to_device_batch,
    )

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    gen = torch.Generator(device).manual_seed(args.seed)
    unet, vae, text = zoo.build_models(args.model_variant, dtype, device, gen)
    ccfg = build_control_config(args, unet.config)
    control = zoo.build_control_lora(ccfg, device, gen)
    print(f"device {device}; frozen {args.model_variant} stack is random (seed "
          f"{args.seed}): no pretrained weights in the repository", flush=True)

    if not args.dataset_name.startswith("process/"):
        raise NotImplementedError("only process/<name> datasets are ported: ROADMAP "
                                  "Queue 1 item 9")
    dataset = DatasetBase.from_name(args.dataset_name)(default_tokenizer(),
                                                       resolution=args.resolution)
    batches = batch_iterator(dataset, args.train_batch_size, seed=args.seed)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * math.ceil(
            len(dataset) / args.train_batch_size)

    lr = args.learning_rate
    if args.scale_lr:
        lr = lr * args.gradient_accumulation_steps * args.train_batch_size
    optimizer = make_optimizer(
        control.parameters(), learning_rate=lr, beta1=args.adam_beta1,
        beta2=args.adam_beta2, weight_decay=args.adam_weight_decay, eps=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, lr_schedule=args.lr_scheduler,
        warmup_steps=args.lr_warmup_steps, total_steps=args.max_train_steps,
        grad_accumulation_steps=args.gradient_accumulation_steps,
        use_8bit=args.use_8bit_adam)
    trainer = ControlLoRATrainer(
        control, unet, vae, text, optimizer=optimizer,
        prediction_type=args.prediction_type, snr_gamma=args.snr_gamma,
        remat_unet=args.gradient_checkpointing,
        adapter_compute_dtype=torch.bfloat16 if args.adapter_compute_bf16 else None,
        hint_compute_dtype=None if dtype == torch.float32 else dtype)
    n_params = sum(p.numel() for p in trainer.params)
    print(f"ControlLoRA params: {n_params / 1e6:.2f}M | batch {args.train_batch_size} | "
          f"lr {lr}", flush=True)

    step_gen = torch.Generator(device).manual_seed(args.seed + 1)
    t_last = time.perf_counter()
    for step in range(args.max_train_steps):
        metrics = trainer.train_step(to_device_batch(next(batches), device), step_gen)
        done = step + 1
        if done % args.log_every == 0 or done == args.max_train_steps:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            now = time.perf_counter()
            n = done % args.log_every or args.log_every
            print(f"step {done}: loss={loss:.4f} grad_norm={gnorm:.4f} "
                  f"{n / (now - t_last):.3f} steps/s", flush=True)
            t_last = now
    save_control_lora(args.output_dir, control)
    print(f"saved final ControlLoRA to {args.output_dir}", flush=True)


if __name__ == "__main__":
    main()
