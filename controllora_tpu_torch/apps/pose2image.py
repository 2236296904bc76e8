"""Pose-to-image demo app of the port (counterpart of ``apps/gradio_pose2image.py``).

    python -m controllora_tpu_torch.apps.pose2image --control_lora_dir <artifact> \
        [--openpose_weights body_pose_model.pth] [--pretrained_model_name_or_path <dir>]
    python -m controllora_tpu_torch.apps.pose2image --control_lora_dir <artifact> \
        --input person.png --prompt "a dancer"

Without ``--input`` it serves the stdlib web UI (``apps/webui.py``: ``GET /``,
``POST /generate``, ``POST /api``); with ``--input`` (a PNG) and ``--prompt`` it runs
once and writes ``<output_dir>/<i>.png``: the skeleton map, then the samples.
``process()`` runs the reference's ``process()`` (apps/gradio_pose2image.py:57-78):
OpenPose on ``--device`` at ``detect_resolution`` (``resize_image``), ``HWC3``, the
skeleton map resized to the generation size (``resize_image`` at
``image_resolution``) by integer-index NEAREST, the **BGR flip of the guide** (a
reference quirk kept for checkpoint parity), [-1, 1], CFG sampling with ``a_prompt``
joined by ", ". The body net holds ``--openpose_weights`` (the CMU
``body_pose_model.pth``) or, without it, a seeded fill; the frozen stack comes from
``--pretrained_model_name_or_path`` (the real CLIP BPE vocab is then required,
``$CLIP_VOCAB_DIR``) or seeded random weights. The gradio route is left out: gradio
is installed on neither machine the port runs on.
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
    num_samples=1, image_resolution=512, detect_resolution=512, ddim_steps=30,
    scale=9.0, seed=42, eta=0.0,
)
TITLE = "Control Stable Diffusion with Human Pose"


def build_processor(args):
    """``process(input_image, prompt, a_prompt, n_prompt, num_samples,
    image_resolution, detect_resolution, ddim_steps, scale, seed, eta)`` -> [skeleton
    map] + the samples, uint8 HWC."""
    from controllora_tpu_torch.annotators import HWC3, OpenposeDetector, resize_image
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
    apply_openpose = (OpenposeDetector.from_pretrained(args.openpose_weights, device=device)
                      if args.openpose_weights else OpenposeDetector(device=device))

    def process(input_image, prompt, a_prompt, n_prompt, num_samples,
                image_resolution, detect_resolution, ddim_steps, scale, seed, eta):
        input_image = HWC3(np.asarray(input_image))
        detected_map, _ = apply_openpose(resize_image(input_image, detect_resolution))
        detected_map = HWC3(detected_map)
        img = resize_image(input_image, image_resolution)
        H, W = img.shape[:2]
        # NEAREST resize of the skeleton map (reference apps:77)
        ys = (np.arange(H) * detected_map.shape[0] / H).astype(int)
        xs = (np.arange(W) * detected_map.shape[1] / W).astype(int)
        detected_map = detected_map[ys][:, xs]
        # reference quirk: BGR-flip the guide before the hint encoder
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
        return [detected_map] + results

    return process


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--model_variant", type=str, default="sd15", choices=["sd15", "smoke"])
    p.add_argument("--control_lora_dir", type=str, required=True)
    p.add_argument("--openpose_weights", type=str, default=None,
                   help="the CMU body_pose_model.pth; a seeded fill without it")
    p.add_argument("--input", type=str, default=None, help="CLI mode: a PNG input image")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="samples/pose2image")
    p.add_argument("--port", type=int, default=7860, help="port for the web UI")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of OpenPose and the pipeline; the flash kernels run "
                        "on cuda")
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
                   args.num_samples, args.image_resolution, args.detect_resolution,
                   args.ddim_steps, args.scale, args.seed, args.eta)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, o in enumerate(outs):
        path = os.path.join(args.output_dir, f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(o, np.uint8)))
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
