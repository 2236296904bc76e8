"""Guided-sampling CLI for the PyTorch port (counterpart of ``scripts/sample.py``,
with that script's flag names, defaults and semantics).

    python -m controllora_tpu_torch.sample --model_variant smoke --control_lora_dir /tmp/run \
        --resolution 64 --num_inference_steps 3 --num_validation_images 1 --device cpu

The reference's eval script (``test_text_to_image_control_lora.py``): load a trained
ControlLoRA (``--control_lora_dir``, or a mid-training ``checkpoint-N`` under it
with ``--resume_from_checkpoint latest|N``, which re-saves the run-root artifact),
render ``--num_validation_images`` guided samples of ``--dataset_name`` and write
each as a 3-panel montage (target | guide | sample) to ``<output_dir>/<i>.png``.
``--lora_weights`` (a ``pytorch_lora_weights.safetensors``/``.bin`` file or a
DreamBooth run directory) adds a plain LoRA: alone it renders ``--prompt`` (the
reference's ``test_dreambooth_lora.py``), beside a ControlLoRA it chains before it
(the threaded path). Also: the five samplers (``--scheduler``), v-prediction,
img2img (``--init_image``, ``--strength``) and inpaint (``--mask_image``, white =
repaint; PNG files only, ``utils/image.py``), ToMe and DeepCache, and the SDXL base
-> refiner ensemble (``--refiner_variant``: the base runs [0, ``--denoising_split``)
of the grid, a second pipeline without a ControlLoRA continues the trajectory; bf16
whenever the base is).

``--pretrained_model_name_or_path`` (and ``--refiner_model_path`` for the refiner)
loads the frozen stack from a local diffusers-layout directory (``zoo.load_frozen``)
and then needs the real CLIP BPE vocab (``$CLIP_VOCAB_DIR``: ``merges.txt`` and
``vocab.json``); without one, the stack gets seeded random weights and a warning
says so (there are no pretrained weights in the repository). ``--dataset_name
process/diffusiondb_canny`` runs its Canny annotator on ``--device``. Refused, with
the reason: ``--serving_mesh`` (parallelism is not ported).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from controllora_tpu_torch.models.zoo import BASE_VARIANTS, model_dtype

NO_MESH = "parallelism is not ported (ROADMAP.md item 14)"


def refused(flag: str, reason: str):
    """An argparse type that refuses ``flag`` with ``reason``."""

    def fail(value):
        raise argparse.ArgumentTypeError(f"{flag} is not taken by the port: {reason}")

    return fail


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="local diffusers-layout checkpoint directory (unet/, vae/, "
                        "text_encoder[_2]/); omit for seeded random weights")
    p.add_argument("--model_variant", type=str, default="sd15", choices=BASE_VARIANTS)
    p.add_argument("--control_lora_dir", type=str, default=None,
                   help="directory with config.json + diffusion_pytorch_model.bin")
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' or a step number: sample from checkpoint-N under "
                        "--control_lora_dir (or the --lora_weights run directory) and "
                        "re-save the run-root artifact there")
    p.add_argument("--lora_weights", type=str, default=None,
                   help="DreamBooth attn-procs LoRA: a pytorch_lora_weights.safetensors "
                        "(or .bin) file or a training output_dir; composes with a "
                        "ControlLoRA")
    p.add_argument("--prompt", type=str, default=None,
                   help="fixed prompt (required for --lora_weights-only sampling)")
    p.add_argument("--dataset_name", type=str, default="process/fill50k")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--scheduler", type=str, default="dpm++",
                   choices=["dpm++", "ddim", "pndm", "euler", "unipc"])
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--init_image", type=str, default=None,
                   help="img2img: a PNG init image (resized to --resolution)")
    p.add_argument("--strength", type=float, default=0.8,
                   help="img2img repaint strength in [0,1]: fraction of the schedule run")
    p.add_argument("--mask_image", type=str, default=None,
                   help="inpainting: a PNG mask, white = repaint (requires --init_image)")
    p.add_argument("--prediction_type", type=str, default="epsilon",
                   choices=["epsilon", "v_prediction"],
                   help="v_prediction for SD2.x-style checkpoints")
    p.add_argument("--refiner_variant", type=str, default=None,
                   choices=["sdxl-refiner", "smokeref"],
                   help="two-stage SDXL render: the base runs [0, denoising_split) and "
                        "the refiner continues the trajectory to the end")
    p.add_argument("--refiner_model_path", type=str, default=None,
                   help="the refiner's checkpoint directory (text_encoder_2/ alone)")
    p.add_argument("--denoising_split", type=float, default=0.8,
                   help="base/refiner handoff point as a schedule fraction")
    p.add_argument("--aesthetic_score", type=float, default=6.0)
    p.add_argument("--negative_aesthetic_score", type=float, default=2.5)
    p.add_argument("--tome_ratio", type=float, default=0.0,
                   help="token-merging ratio (0 = exact path, 0.5 = tomesd's setting)")
    p.add_argument("--deepcache_interval", type=int, default=1,
                   help="DeepCache: the deep UNet levels run every N-th step (1 = exact)")
    p.add_argument("--serving_mesh", type=refused("--serving_mesh", NO_MESH), default=None)
    p.add_argument("--output_dir", type=str, default="samples/run")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    return p.parse_args(argv)


def resolve_checkpoint(run_dir: str, which: str):
    """--resume_from_checkpoint 'latest'|N -> (step, checkpoint directory)."""
    from controllora_tpu_torch.training.checkpoint import checkpoint_step_dirs

    dirs = checkpoint_step_dirs(run_dir)
    if not dirs:
        raise SystemExit(f"no checkpoint-* under {run_dir}")
    if which == "latest":
        return dirs[-1]
    match = dict(dirs)
    if int(which) not in match:
        raise SystemExit(f"checkpoint-{which} not found; have {sorted(match)}")
    return int(which), match[int(which)]


def load_lora(path: str, device, resume: Optional[str] = None):
    """A DreamBooth LoRA -> {processor name: plain LoRA AttnAdapter} (fp32 on
    ``device``). ``path`` is a .safetensors/.bin file or a run directory, which
    resolves to its artifact, or with ``resume`` ('latest'|N) to a checkpoint's,
    then re-saved at the run root as .safetensors and .bin."""
    from controllora_tpu_torch.models.lora import AdapterSpec, AttnAdapter
    from controllora_tpu_torch.utils.convert import (
        attn_procs_from_torch,
        load_state_dict,
        save_state_dict,
    )

    root = path
    if os.path.isdir(root):
        path = os.path.join(root, "pytorch_lora_weights.safetensors")
        if resume:
            step, ckpt = resolve_checkpoint(root, resume)
            path = os.path.join(ckpt, "pytorch_lora_weights.safetensors")
            print(f"sampling LoRA from training checkpoint-{step}")
    sd = load_state_dict(path)
    if os.path.isdir(root) and path != os.path.join(root, "pytorch_lora_weights.safetensors"):
        for name in ("pytorch_lora_weights.safetensors", "pytorch_lora_weights.bin"):
            save_state_dict(sd, os.path.join(root, name))
        print(f"re-saved final artifact to {root}")
    spec = AdapterSpec(kind="lora")
    return {name: AttnAdapter(params={proj: {k: torch.from_numpy(np.ascontiguousarray(v))
                                             .to(device) for k, v in pair.items()}
                                      for proj, pair in params.items()}, spec=spec)
            for name, params in attn_procs_from_torch(sd).items()}


def build_pipelines(args):
    """(pipeline, refiner pipeline or None, whether a ControlLoRA was loaded, extra
    LoRAs or None), on ``--device``: the frozen weights of
    ``--pretrained_model_name_or_path``, or seeded random ones."""
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.schedulers import (
        DDIMScheduler,
        DPMSolverMultistepScheduler,
        EulerDiscreteScheduler,
        PNDMScheduler,
        UniPCMultistepScheduler,
    )
    from controllora_tpu_torch.schedulers.common import DiffusionSchedule
    from controllora_tpu_torch.training.checkpoint import load_control_lora, save_control_lora

    device = torch.device(args.device)
    dtype = model_dtype(args.model_variant)
    unet, vae, text = zoo.frozen_stack(args.pretrained_model_name_or_path,
                                       args.model_variant, dtype, device,
                                       torch.Generator(device).manual_seed(args.seed))
    if not args.pretrained_model_name_or_path:
        print("WARNING: random frozen stack (no pretrained weights)", flush=True)

    control_lora = None
    if args.control_lora_dir:
        load_dir = args.control_lora_dir
        if args.resume_from_checkpoint:
            step, ckpt = resolve_checkpoint(args.control_lora_dir, args.resume_from_checkpoint)
            load_dir = os.path.join(ckpt, "control_lora")
            print(f"sampling from training checkpoint-{step}")
        control_lora, ccfg = load_control_lora(load_dir, device)
        if args.resume_from_checkpoint:
            # the reference eval re-saves the final-format artifact at the run root
            save_control_lora(args.control_lora_dir, control_lora)
            print(f"re-saved final artifact to {args.control_lora_dir}")
        if (args.model_variant.startswith("smoke")
                and ccfg.lora_block_out_channels != unet.config.block_out_channels):
            raise SystemExit("checkpoint was not trained against the smoke UNet")
    extra_loras = None
    if args.lora_weights:
        # --resume_from_checkpoint names the ControlLoRA's checkpoint when both
        # are given, as in scripts/sample.py
        extra_loras = load_lora(args.lora_weights, device, None if args.control_lora_dir
                                else args.resume_from_checkpoint)
        print(f"loaded {len(extra_loras)} plain LoRA adapters")
    if control_lora is None and extra_loras is None:
        raise SystemExit("need --control_lora_dir and/or --lora_weights")

    def scheduler():
        schedule = DiffusionSchedule.create(prediction_type=args.prediction_type)
        return {"dpm++": DPMSolverMultistepScheduler, "ddim": DDIMScheduler,
                "pndm": PNDMScheduler, "euler": EulerDiscreteScheduler,
                "unipc": UniPCMultistepScheduler}[args.scheduler](schedule)

    tokenizer = default_tokenizer(require_clip=bool(args.pretrained_model_name_or_path))
    pipe = StableDiffusionControlLoRAPipeline(unet, vae, text, tokenizer, control_lora,
                                              scheduler=scheduler(), device=device)
    refiner = None
    if args.refiner_variant:
        if args.mask_image:
            raise SystemExit("--refiner_variant with --mask_image is unsupported: the "
                             "refiner stage would repaint the preserved region")
        r_unet, r_vae, r_text = zoo.frozen_stack(
            args.refiner_model_path, args.refiner_variant, dtype, device,
            torch.Generator(device).manual_seed(args.seed + 1))
        if not args.refiner_model_path:
            print("WARNING: random frozen refiner (no pretrained weights)", flush=True)
        refiner = StableDiffusionControlLoRAPipeline(r_unet, r_vae, r_text, tokenizer,
                                                     scheduler=scheduler(), device=device)
        print(f"two-stage render: base [0, {args.denoising_split}) -> refiner", flush=True)
    return pipe, refiner, control_lora is not None, extra_loras


def main(argv=None):
    from controllora_tpu_torch.data import DatasetBase
    from controllora_tpu_torch.utils.image import load_image, load_mask
    from controllora_tpu_torch.utils.png import encode_png

    args = parse_args(argv)
    pipe, refiner, guided, extra_loras = build_pipelines(args)
    generator = torch.Generator().manual_seed(args.seed)

    def render(prompt, return_array=False, **kw):
        kw.update(tome_ratio=args.tome_ratio, deepcache_interval=args.deepcache_interval,
                  num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale, generator=generator)
        if refiner is None:
            return pipe(prompt, return_array=return_array, **kw)[0]
        lat = pipe(prompt, denoising_end=args.denoising_split, return_latents=True, **kw)[0]
        return refiner(prompt, latents=lat[None], num_inference_steps=args.num_inference_steps,
                       guidance_scale=args.guidance_scale,
                       denoising_start=args.denoising_split,
                       aesthetic_score=args.aesthetic_score,
                       negative_aesthetic_score=args.negative_aesthetic_score,
                       generator=generator, return_array=return_array)[0]

    def write(i, image):
        path = os.path.join(args.output_dir, f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(image))
        print(f"wrote {path}", flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    paint = dict(strength=args.strength,
                 image=load_image(args.init_image, args.resolution) if args.init_image else None,
                 mask=load_mask(args.mask_image, args.resolution) if args.mask_image else None)
    if not guided:
        # plain-LoRA sampling (reference test_dreambooth_lora.py:824-888)
        for i in range(args.num_validation_images):
            write(i, render(args.prompt or f"sample {i}", height=args.resolution,
                            width=args.resolution, extra_loras=extra_loras, **paint))
        return

    dataset = DatasetBase.from_name(args.dataset_name)(pipe.tokenizer,
                                                       resolution=args.resolution,
                                                       device=args.device)
    for i in range(args.num_validation_images):
        item = dataset[i]
        img = render(args.prompt or f"sample {i}", return_array=True,
                     guide=item["guide_values"].astype(np.float32),
                     extra_loras=extra_loras, **paint)
        write(i, DatasetBase.cat_input(item["pixel_values"], item["guide_values"], img))


if __name__ == "__main__":
    main()
