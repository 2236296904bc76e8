"""LoRA x ControlLoRA composition CLI for the PyTorch port (counterpart of
``scripts/mix_lora.py``, with that script's flag names, defaults and semantics).

    python -m controllora_tpu_torch.mix_lora --model_variant smoke --control_lora_dir /tmp/run \
        --lora_weights /tmp/db/pytorch_lora_weights.safetensors --prompt "a sks circle" \
        --resolution 64 --num_inference_steps 3 --device cpu

The reference's ``mix_lora_and_control_lora.py``: a DreamBooth LoRA (attn-procs
format, ``.safetensors`` or ``.bin``) joins every ControlLoRA processor's chain as a
pre- (or, ``--where post``, post-) adapter and both steer one render. The chain does
not fold, so the UNet runs it threaded (long self-attention on K2's flash route).
The guide is ``--guide_image`` (a PNG, resized to ``--resolution``) or fill50k's
first guide. Images go to ``<output_dir>/<i>.png``. The frozen stack gets seeded
random weights (no pretrained weights in the repository);
``--pretrained_model_name_or_path`` is refused with that reason.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from controllora_tpu_torch.models.zoo import model_dtype
from controllora_tpu_torch.sample import NO_WEIGHTS, refused


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path",
                   type=refused("--pretrained_model_name_or_path", NO_WEIGHTS), default=None)
    p.add_argument("--model_variant", type=str, default="sd15", choices=["sd15", "smoke"])
    p.add_argument("--control_lora_dir", type=str, required=True)
    p.add_argument("--lora_weights", type=str, required=True,
                   help="pytorch_lora_weights.safetensors (attn-procs format)")
    p.add_argument("--where", type=str, default="pre", choices=["pre", "post"])
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--guide_image", type=str, default=None,
                   help="a PNG file; omit to use a fill50k synthetic guide")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--num_images", type=int, default=1)
    p.add_argument("--output_dir", type=str, default="samples/mix")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    return p.parse_args(argv)


def main(argv=None):
    from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.sample import load_lora
    from controllora_tpu_torch.training.checkpoint import load_control_lora
    from controllora_tpu_torch.utils.image import load_image
    from controllora_tpu_torch.utils.png import encode_png

    args = parse_args(argv)
    device = torch.device(args.device)
    unet, vae, text = zoo.build_models(args.model_variant, model_dtype(args.model_variant),
                                       device, torch.Generator(device).manual_seed(args.seed))
    print("WARNING: random frozen stack (no pretrained weights)", flush=True)
    control_lora, ccfg = load_control_lora(args.control_lora_dir, device)
    extra = load_lora(args.lora_weights, device)
    print(f"loaded {len(extra)} plain LoRA adapters + ControlLoRA "
          f"(lora_control_version={ccfg.lora_control_version})", flush=True)
    pipe = StableDiffusionControlLoRAPipeline(unet, vae, text, default_tokenizer(),
                                              control_lora, device=device)
    if args.guide_image:
        guide = load_image(args.guide_image, args.resolution)
    else:
        guide = Fill50kSynthetic(resolution=args.resolution, size=10)[0][
            "guide_values"].astype(np.float32)

    os.makedirs(args.output_dir, exist_ok=True)
    images = pipe(args.prompt, guide=guide, num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale, num_images=args.num_images,
                  generator=torch.Generator().manual_seed(args.seed),
                  extra_loras=extra, extra_loras_where=args.where)
    for i, im in enumerate(images):
        path = os.path.join(args.output_dir, f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(im))
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
