"""Canny-to-image demo app of the port (counterpart of ``apps/gradio_canny2image.py``).

    python -m controllora_tpu_torch.apps.canny2image --control_lora_dir <artifact> \
        [--pretrained_model_name_or_path <dir>] [--port 7860]
    python -m controllora_tpu_torch.apps.canny2image --control_lora_dir <artifact> \
        --input image.png --prompt "a bird"

Without ``--input`` it serves the stdlib web UI (``apps/webui.py``: ``GET /``,
``POST /generate``, ``POST /api``); with ``--input`` (a PNG) and ``--prompt`` it runs
once and writes ``<output_dir>/<i>.png``: the inverted edge map, then the samples.
``process()`` runs the reference's ``process()`` exactly (apps/gradio_canny2image.py
:66-92): resize to a multiple of 64 at the chosen resolution (``resize_image``),
Canny with the threshold sliders on ``--device``, ``HWC3``, the **BGR flip of the
guide** (a reference quirk kept for checkpoint parity: training data was not
flipped, the app's guide is), [-1, 1], CFG sampling with ``a_prompt`` joined by
", ". The frozen stack comes from ``--pretrained_model_name_or_path`` (the real CLIP
BPE vocab is then required, ``$CLIP_VOCAB_DIR``) or seeded random weights. The
gradio route is left out: gradio is installed on neither machine the port runs on.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

DEFAULTS = dict(
    a_prompt="best quality, extremely detailed",
    n_prompt="longbody, lowres, bad anatomy, bad hands, missing fingers, "
             "extra digit, fewer digits, cropped, worst quality, low quality",
    num_samples=1, image_resolution=512, ddim_steps=20, scale=9.0, seed=42,
    eta=0.0, low_threshold=100, high_threshold=200,
)
TITLE = "Control Stable Diffusion with Canny Edge Maps"


def build_processor(args):
    """``process(input_image, prompt, a_prompt, n_prompt, num_samples,
    image_resolution, ddim_steps, scale, seed, eta, low_threshold, high_threshold)``
    -> [255 - edge map] + the samples, uint8 HWC."""
    from controllora_tpu_torch.annotators import HWC3, CannyDetector, resize_image
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.training.checkpoint import load_control_lora

    device = torch.device(args.device)
    unet, vae, text = zoo.frozen_stack(args.pretrained_model_name_or_path,
                                       args.model_variant, zoo.model_dtype(args.model_variant),
                                       device, torch.Generator(device).manual_seed(0))
    if not args.pretrained_model_name_or_path:
        print("WARNING: random frozen stack (no pretrained weights)", flush=True)
    control_lora, _ = load_control_lora(args.control_lora_dir, device)
    tokenizer = default_tokenizer(require_clip=bool(args.pretrained_model_name_or_path))
    pipe = StableDiffusionControlLoRAPipeline(unet, vae, text, tokenizer, control_lora,
                                              device=device)
    apply_canny = CannyDetector(device)

    def process(input_image, prompt, a_prompt, n_prompt, num_samples,
                image_resolution, ddim_steps, scale, seed, eta,
                low_threshold, high_threshold):
        img = resize_image(HWC3(np.asarray(input_image)), image_resolution)
        detected_map = apply_canny(img, low_threshold, high_threshold)
        detected_map = HWC3(detected_map)
        # reference quirk: BGR-flip the guide before the hint encoder (apps:74)
        control = detected_map[:, :, ::-1].astype(np.float32) / 127.5 - 1.0
        results = pipe(
            prompt + ", " + a_prompt if a_prompt else prompt,
            guide=control,
            negative_prompt=n_prompt,
            num_inference_steps=ddim_steps,
            guidance_scale=scale,
            num_images=num_samples,
            generator=torch.Generator().manual_seed(seed),
        )
        return [255 - detected_map] + results

    return process


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--model_variant", type=str, default="sd15", choices=["sd15", "smoke"])
    p.add_argument("--control_lora_dir", type=str, required=True)
    p.add_argument("--input", type=str, default=None, help="CLI mode: a PNG input image")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="samples/canny2image")
    p.add_argument("--port", type=int, default=7860, help="port for the web UI")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    for k, v in DEFAULTS.items():
        p.add_argument(f"--{k}", type=type(v), default=v)
    return p.parse_args(argv)


def main(argv=None):
    from controllora_tpu_torch.utils.image import read_png
    from controllora_tpu_torch.utils.png import encode_png

    args = parse_args(argv)
    process = build_processor(args)
    if args.input is None:
        from controllora_tpu_torch.apps.webui import serve_app

        serve_app(TITLE, process, DEFAULTS, port=args.port)
        return
    outs = process(read_png(args.input), args.prompt, args.a_prompt, args.n_prompt,
                   args.num_samples, args.image_resolution, args.ddim_steps,
                   args.scale, args.seed, args.eta,
                   args.low_threshold, args.high_threshold)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, o in enumerate(outs):
        path = os.path.join(args.output_dir, f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(o, np.uint8)))
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
