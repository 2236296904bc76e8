"""ControlLoRA trainer CLI for the PyTorch port (counterpart of ``scripts/train.py``,
with that script's flag names, defaults and semantics for the flags it takes).

    python -m controllora_tpu_torch.train --model_variant smoke --resolution 64 \
        --train_batch_size 2 --max_train_steps 3 --output_dir /tmp/run --device cpu

The frozen stack (UNet, VAE, text encoder) of ``--model_variant`` (sd15, sd21, sdxl
and their smoke stacks) comes from ``--pretrained_model_name_or_path``, a local
diffusers-layout directory (``zoo.load_frozen``; the real CLIP BPE vocab is then
required, ``$CLIP_VOCAB_DIR``), or gets seeded random weights (there are none in the
repository); the hint encoder is seeded. For SD2.1
and SDXL the ControlLoRA config is re-derived for the UNet
(``control_lora.config_for_unet``: SD2.1 32 adapter slots, SDXL 3 buckets, 140
slots, level 0 adapter-free); SDXL trains with its ``text_time`` conditioning
(``training/conditioning.py``), SD2.1-v with ``--prediction_type v_prediction``.
Data comes from the port's numpy registry (``process/<name>``; ``process/diffusiondb_canny`` runs its Canny annotator on
``--device``) or a column dataset
(a local directory or dataset script: ``data/hf_dataset.py``,
``--image_column`` etc.), optionally behind the VAE latent cache
(``--cache_latents``). fill50k and column datasets are batched by the native data
plane (``data/fastloader.py``: C synthesis or normalisation, a prefetch thread)
where its C library builds, else by ``batch_iterator``; the CLI says which. The
UNet can be rematerialised (``--gradient_checkpointing``, ``--remat_policy``) and
the AdamW moments kept in 8 bits (``--use_8bit_adam``). Metrics go to
``<output_dir>/metrics.jsonl`` (``--report_to``, ``utils/logging.py``), and every
``--validation_steps`` steps a guided 25-step render of the first dataset item
with the current adapters is logged as a montage of image, guide and sample.

Every ``--checkpointing_steps`` steps the train state goes to
``<output_dir>/checkpoint-<step>`` (in a background thread unless
``--no_async_checkpointing``; the newest ``--checkpoints_total_limit`` are kept).
``--resume_from_checkpoint latest`` (or a directory holding checkpoints) continues
a run exactly: params, optimizer and schedule, the noise generator, and the data
stream fast-forwarded to the step; the seed recorded in ``run_meta.json`` wins over
``--seed`` for the random weights, data order and noise. SIGTERM or SIGINT finishes the step, saves a
checkpoint and exits 0 (a second signal aborts). The run ends by writing the
adapter artifact (``training/checkpoint.py``) and a model card (``README.md``, the
checkpoint directory as ``base_model``) to ``--output_dir``. Flags of
``scripts/train.py`` not taken here: ``--push_to_hub`` and the ``--hub_*`` flags (no
network), ``--profile`` and data parallelism (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import time

import torch

from controllora_tpu_torch.utils.logging import REPORT_TO, MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="local diffusers-layout checkpoint directory (unet/, vae/, "
                        "text_encoder[_2]/); omit for seeded random weights")
    p.add_argument("--model_variant", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl", "smoke", "smoke2", "smokexl"])
    p.add_argument("--control_lora_config", type=str, default="base",
                   help="preset name or reference-format JSON path")
    p.add_argument("--mixed_precision", type=str, default="bf16", choices=["no", "bf16"],
                   help="frozen-stack and hint-encoder compute dtype (adapters fp32)")
    p.add_argument("--adapter_compute_bf16", action="store_true",
                   help="cast the adapter factors to bf16 for the forward/backward "
                        "(fp32 master params and optimizer state)")
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--dataset_name", type=str, default="process/fill50k",
                   help="process/<registry name>, or a local imagefolder directory or "
                        "dataset script with (image, guide, text) columns")
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--image_column", type=str, default=None)
    p.add_argument("--guide_column", type=str, default=None)
    p.add_argument("--caption_column", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--max_train_samples", type=int, default=None)
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
                   help="block-wise int8 AdamW moments (training/adam8bit.py)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="rematerialise the UNet in the backward")
    p.add_argument("--remat_policy", type=str, default="dots",
                   choices=["nothing", "dots", "dots_all"],
                   help="what the UNet remat keeps: nothing, the projections' outputs "
                        "(dots), or also the batched products (dots_all)")
    p.add_argument("--cache_latents", action="store_true",
                   help="encode the dataset with the VAE once and skip the per-step "
                        "encode (deterministic datasets only; data/latent_cache.py)")
    p.add_argument("--latent_cache_path", type=str, default=None,
                   help="npz file to persist/load the latent cache")
    p.add_argument("--output_dir", type=str, default="control-lora-model")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--no_async_checkpointing", action="store_true",
                   help="block the train loop during checkpoint saves")
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' (in --output_dir) or a directory of checkpoint-<step>")
    p.add_argument("--validation_steps", type=int, default=0,
                   help="render a validation sample every N steps (0 = off)")
    p.add_argument("--validation_prompt", type=str, default=None)
    p.add_argument("--report_to", type=str, default="jsonl", choices=list(REPORT_TO),
                   help="metrics sinks beside metrics.jsonl")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    return p.parse_args(argv)


def build_control_config(args, unet_config):
    """The ControlLoRA config: the named preset, re-derived for SD2.1 and SDXL
    (``config_for_unet``), or for the smoke variants the JAX CLI's reduced hint
    encoder with buckets and slots derived from the UNet."""
    from controllora_tpu_torch.config import ControlLoRAConfig, load_config
    from controllora_tpu_torch.models.control_lora import config_for_unet

    cfg = load_config(args.control_lora_config)
    if args.model_variant in ("sd21", "sdxl"):
        cfg = config_for_unet(cfg, unet_config)
    if args.model_variant.startswith("smoke"):
        cfg = config_for_unet(ControlLoRAConfig(
            block_out_channels=(8, 16, 16, 32), lora_block_in_channels=(32, 32, 32, 32),
            lora_control_version=cfg.lora_control_version), unet_config)
    return cfg


def resume_point(args):
    """(train state or None, start step, seed): the latest checkpoint under
    --resume_from_checkpoint, and the seed recorded in run_meta.json, which wins
    over --seed for data order and noise (scripts/train.py semantics) and, here, for
    the random frozen stack too, so that the resumed run trains the same model."""
    from controllora_tpu_torch.training.checkpoint import restore_train_state

    if not args.resume_from_checkpoint:
        return None, 0, args.seed
    where = (args.output_dir if args.resume_from_checkpoint == "latest"
             else args.resume_from_checkpoint)
    state, at = restore_train_state(where, "latest")
    if state is None:
        print("no checkpoint found; starting fresh", flush=True)
        return None, 0, args.seed
    print(f"resumed from step {at}", flush=True)
    seed = args.seed
    meta_path = os.path.join(args.output_dir, "run_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        seed = meta.get("seed", args.seed)
        if seed != args.seed:
            print(f"WARNING: resuming with --seed {args.seed} but the run was started "
                  f"with seed {seed}; using the recorded seed for the random weights, "
                  "data order and noise streams", flush=True)
        if meta.get("global_batch") not in (None, args.train_batch_size):
            print(f"WARNING: global batch changed ({meta['global_batch']} -> "
                  f"{args.train_batch_size}); the resumed data stream will not match "
                  "the original run's", flush=True)
    return state, at, seed


def build_dataset(args, tokenizer, seed):
    """The registry dataset ``process/<name>``, or a column dataset
    (``data/hf_dataset.py``) from a local directory or dataset script."""
    if args.dataset_name.startswith("process/"):
        from controllora_tpu_torch.data.registry import DatasetBase

        dataset = DatasetBase.from_name(args.dataset_name)(tokenizer,
                                                           resolution=args.resolution,
                                                           device=args.device)
        if args.max_train_samples:
            dataset.size = min(len(dataset), args.max_train_samples)
        return dataset
    from controllora_tpu_torch.data.hf_dataset import HFImageGuideDataset

    return HFImageGuideDataset(
        tokenizer, dataset_name=args.dataset_name,
        dataset_config_name=args.dataset_config_name, resolution=args.resolution,
        image_column=args.image_column, guide_column=args.guide_column,
        caption_column=args.caption_column, seed=seed,
        max_train_samples=args.max_train_samples)


def make_batches(args, dataset, seed, start_step):
    """(batch stream, what it is). fill50k is made in C and column datasets are
    normalised in C, behind a prefetch thread (scripts/train.py's native data plane),
    where the C library builds; everything else, and a latent cache, goes through
    ``batch_iterator``."""
    from controllora_tpu_torch.data import fastloader
    from controllora_tpu_torch.data.registry import batch_iterator

    bs = args.train_batch_size
    why = "latent cache" if args.cache_latents else None
    if why is None and not fastloader.native_available():
        why = f"native fastloader unavailable: {fastloader.native_error()}"
    if why is None and args.dataset_name == "process/fill50k":
        return (iter(fastloader.Prefetcher(iter(fastloader.NativeFill50kBatcher(
            dataset, bs, seed=seed, start_step=start_step)))),
            "native fastloader (fill50k made in C, prefetch thread)")
    if why is None and hasattr(dataset, "getitem_u8"):
        return (iter(fastloader.Prefetcher(iter(fastloader.NativeNormalizeBatcher(
            dataset, bs, seed=seed, start_step=start_step)))),
            "native batch-normalize (uint8 -> [-1, 1] in C, prefetch thread)")
    return (batch_iterator(dataset, bs, seed=seed, start_step=start_step),
            f"python batch_iterator ({why or 'no native batcher for this dataset'})")


def make_validation(args, dataset, stack, control, trainer, logger, device):
    """validate(step): a guided 25-step CFG-9 render of the first dataset item's
    guide through ``stack`` (unet, vae, text encoder, tokenizer) with the current
    adapters (folded, as served), logged as the montage image | guide | sample
    (``DatasetBase.cat_input``)."""
    import numpy as np

    from controllora_tpu_torch.data.registry import DatasetBase
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler

    # the montage needs pixel_values: unwrap a latent cache
    item = getattr(dataset, "dataset", dataset)[0]
    scheduler = DPMSolverMultistepScheduler(trainer.scheduler.schedule)
    pipe = StableDiffusionControlLoRAPipeline(*stack, control, scheduler=scheduler,
                                              device=device)

    def validate(step):
        img = pipe(args.validation_prompt or "validation sample",
                   guide=item["guide_values"].astype(np.float32), num_inference_steps=25,
                   guidance_scale=9.0, generator=torch.Generator().manual_seed(args.seed),
                   return_array=True)[0]
        logger.log_image(step, "validation",
                         DatasetBase.cat_input(item["pixel_values"], item["guide_values"], img))
        print(f"validation image at step {step}: {logger.image_path(step, 'validation')}",
              flush=True)

    return validate


def write_model_card(args) -> None:
    """``<output_dir>/README.md`` (the reference's save_model_card, as
    ``scripts/train.py`` writes it): the checkpoint directory, or SD1.5's hub name
    for a random stack, as ``base_model``."""
    with open(os.path.join(args.output_dir, "README.md"), "w") as f:
        f.write(f"""---
license: creativeml-openrail-m
base_model: {args.pretrained_model_name_or_path or 'runwayml/stable-diffusion-v1-5'}
tags: [stable-diffusion, controllora, control-lora, pytorch, cuda]
---
# ControlLoRA — {os.path.basename(os.path.normpath(args.output_dir))}

ControlLoRA adapter trained with controllora_tpu_torch (PyTorch/CUDA) on
`{args.dataset_name}` at {args.resolution}px for {args.max_train_steps} steps (lr
{args.learning_rate}, global batch {args.train_batch_size}, config
`{args.control_lora_config}`). Load with
`controllora_tpu_torch.training.checkpoint.load_control_lora`, the JAX package's
`load_control_lora` or the PyTorch reference's `ControlLoRA.from_pretrained`.
""")


def main(argv=None):
    args = parse_args(argv)
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.training.checkpoint import Checkpointer, save_control_lora
    from controllora_tpu_torch.training.trainer import (
        ControlLoRATrainer,
        make_optimizer,
        to_device_batch,
    )

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    # restored before the models and the data stream exist: the recorded seed makes
    # the same random frozen stack, and the stream fast-forwards to the step (the
    # reference's skip_first_batches)
    state, start_step, seed = resume_point(args)
    gen = torch.Generator(device).manual_seed(seed)
    unet, vae, text = zoo.frozen_stack(args.pretrained_model_name_or_path,
                                       args.model_variant, dtype, device, gen)
    ccfg = build_control_config(args, unet.config)
    control = zoo.build_control_lora(ccfg, device, gen)
    print(f"device {device}; frozen {args.model_variant} stack " + (
        f"from {args.pretrained_model_name_or_path}" if args.pretrained_model_name_or_path
        else f"is random (seed {seed}): no pretrained weights given"), flush=True)

    tokenizer = default_tokenizer(require_clip=bool(args.pretrained_model_name_or_path))
    dataset = build_dataset(args, tokenizer, seed)
    if args.cache_latents:
        from controllora_tpu_torch.data.latent_cache import LatentCachedDataset

        dataset = LatentCachedDataset(dataset, vae, cache_path=args.latent_cache_path)
    if args.max_train_steps is None:
        steps_per_epoch = max(math.ceil(
            len(dataset) / args.train_batch_size / args.gradient_accumulation_steps), 1)
        args.max_train_steps = args.num_train_epochs * steps_per_epoch

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
        remat_unet=args.gradient_checkpointing, remat_policy=args.remat_policy,
        adapter_compute_dtype=torch.bfloat16 if args.adapter_compute_bf16 else None,
        hint_compute_dtype=None if dtype == torch.float32 else dtype)

    step_gen = torch.Generator(device).manual_seed(seed + 1)
    if state is not None:
        control.load_state_dict(state["params"])
        optimizer.load_state_dict(state["optimizer"])
        step_gen.set_state(state["generator"])
    else:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "run_meta.json"), "w") as f:
            json.dump({"seed": args.seed, "global_batch": args.train_batch_size,
                       "dataset_name": args.dataset_name,
                       "resolution": args.resolution}, f)
    batches, plane = make_batches(args, dataset, seed, start_step)
    print(f"data plane: {plane}", flush=True)
    logger = MetricsLogger(args.output_dir, args.report_to)
    validate = (make_validation(args, dataset, (unet, vae, text, tokenizer), control,
                                trainer, logger, device) if args.validation_steps else None)
    n_params = sum(p.numel() for p in trainer.params)
    print(f"ControlLoRA params: {n_params / 1e6:.2f}M | batch {args.train_batch_size} | "
          f"lr {lr}", flush=True)

    checkpointer = Checkpointer()
    last_saved = start_step if state is not None else -1

    def save_checkpoint(at_step):
        nonlocal last_saved
        last_saved = at_step
        checkpointer.save(args.output_dir, at_step,
                          {"step": at_step, "params": control.state_dict(),
                           "optimizer": optimizer.state_dict(),
                           "generator": step_gen.get_state()},
                          ccfg, keep=args.checkpoints_total_limit,
                          wait=args.no_async_checkpointing)
        print(f"saved checkpoint-{at_step}", flush=True)

    # SIGTERM / SIGINT (a preemption notice) asks for a graceful stop: finish the
    # step, save a resumable checkpoint, exit 0; a second signal aborts at once
    stop = {"sig": None}

    def request_stop(signum, frame):
        if stop["sig"] is not None:
            raise KeyboardInterrupt(f"second signal {signum}; aborting")
        stop["sig"] = signum
        print(f"received {signal.Signals(signum).name}; checkpointing and exiting "
              "after the current step", flush=True)

    prev_handlers = {s: signal.signal(s, request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        t_last = time.perf_counter()
        for step in range(start_step, args.max_train_steps):
            metrics = trainer.train_step(to_device_batch(next(batches), device), step_gen)
            done = step + 1
            if done % args.log_every == 0 or done == args.max_train_steps:
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                now = time.perf_counter()
                n = done % args.log_every or args.log_every
                dt = (now - t_last) / n
                print(f"step {done}: loss={loss:.4f} grad_norm={gnorm:.4f} "
                      f"{1 / dt:.3f} steps/s {dt * 1e3:.1f} ms/step", flush=True)
                logger.log(done, {"train_loss": loss, "grad_norm": gnorm,
                                  "steps_per_sec": 1 / dt,
                                  "imgs_per_sec": args.train_batch_size / dt})
                t_last = now
            if validate is not None and done % args.validation_steps == 0:
                validate(done)
                t_last = time.perf_counter()
            if args.checkpointing_steps and done % args.checkpointing_steps == 0:
                save_checkpoint(done)
            if stop["sig"] is not None:
                if last_saved != done:
                    save_checkpoint(done)
                checkpointer.finalize()
                print(f"preempted at step {done}; relaunch with "
                      "--resume_from_checkpoint latest to continue", flush=True)
                return
        checkpointer.finalize()
    finally:
        logger.close()
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    save_control_lora(args.output_dir, control)
    write_model_card(args)
    print(f"saved final ControlLoRA to {args.output_dir}", flush=True)


if __name__ == "__main__":
    main()
