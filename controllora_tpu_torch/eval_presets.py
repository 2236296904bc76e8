"""Quality of the serving presets on a trained model (counterpart of
``scripts/eval_presets.py``, with its flags, defaults, ``PRESETS`` table, report keys
and rounding; ``--device`` added).

Trains the smoke ControlLoRA on procedural fill50k at 64² through
``controllora_tpu_torch.train`` (or takes ``--control_lora_dir``), renders the same
seeded prompts and guides under every preset (exact, ToMe 0.5, DeepCache 2, both) and
reports per preset, in latent space: the error against the exact sampler's latents,
whether each preset's output is still nearest the exact output of the same spec
(retrieval accuracy), the guide sensitivity (mean pairwise distance between specs,
normalised), the error against the VAE-encoded ground truth; and in pixels the drift
against the exact renders and, only where the VAE round trip itself passes the circle
fit, the circle fit's error against the spec (on the random smoke VAE it never does:
the calibration numbers say so). See ``scripts/eval_presets.py`` for why each metric.

    python -m controllora_tpu_torch.eval_presets --output_dir /tmp/presets_run \\
        --train_steps 4000 --report /tmp/presets.json
    python -m controllora_tpu_torch.eval_presets --output_dir /tmp/p --device cpu \\
        --train_steps 20 --num_eval 3 --num_inference_steps 2

The frozen smoke stack is not saved with the run: it is rebuilt from ``--seed`` as the
train CLI built it, ``zoo.frozen_stack(None, "smoke", fp32, device,
torch.Generator(device).manual_seed(seed))``. Its random draws depend on the device's
generator as well as the seed, so evaluate on the device the run was trained on
(``--device``, default cuda). Each render draws its initial latents from
``torch.Generator().manual_seed(1000 + i)`` through ``text_to_image.draw_noise``, and
ToMe gates no level (``tome_min_tokens=0``), as the JAX script renders.

Prints one JSON report line and writes it to ``--report`` if given; the montage (rows:
guides, VAE round trips of the targets, one row per preset) goes to
``<output_dir>/presets_montage.png``. At 64² no attention reaches the flash kernels
(every sequence is at most 64 tokens, under ``FLASH_MIN_LEN``): this module adds no
kernel path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

PRESETS = {
    # name -> (tome_ratio, deepcache_interval); mirrors serve.py's --preset
    "exact": (0.0, 1),
    "tome50": (0.5, 1),
    "dc2": (0.0, 2),
    "turbo": (0.5, 2),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--control_lora_dir", type=str, default=None,
                   help="skip training and evaluate this run directory")
    p.add_argument("--train_steps", type=int, default=4000)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--num_eval", type=int, default=6,
                   help="eval samples (fill50k indices 10_000+i: unseen specs)")
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--seed", type=int, default=42,
                   help="must match the training run's --seed (frozen stack)")
    p.add_argument("--report", type=str, default=None,
                   help="also write the JSON report to this path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; must be the one the run was trained on")
    return p.parse_args(argv)


def fit_circle(img_u8: np.ndarray, fg_rgb, bg_rgb):
    """Nearest-of-two-colors segmentation -> (cx, cy, radius) of the fg blob: a pixel
    is foreground when it is L2-closer to the caption's fg palette color than to the
    bg color."""
    img = img_u8.astype(np.float32)
    d_fg = np.sum((img - np.asarray(fg_rgb, np.float32)) ** 2, axis=-1)
    d_bg = np.sum((img - np.asarray(bg_rgb, np.float32)) ** 2, axis=-1)
    mask = d_fg < d_bg
    area = float(mask.sum())
    if area < 4.0:
        return None
    yy, xx = np.nonzero(mask)
    return float(xx.mean()), float(yy.mean()), float(np.sqrt(area / np.pi))


def circle_errors(img_u8, sp, h, colors):
    fit = fit_circle(img_u8, colors[sp["fg"]], colors[sp["bg"]])
    if fit is None:
        return float(h), float(h)  # a lost circle counts as max error
    fx, fy, fr = fit
    return (float(np.hypot(fx - sp["cx"], fy - sp["cy"])),
            abs(fr - sp["radius"]))


def to_u8(img_m1_1):
    return np.clip((np.asarray(img_m1_1, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


def train_run(args) -> str:
    """Train the smoke ControlLoRA with the JAX script's arguments in the port's terms
    (no ``--gradient_checkpointing``: the JAX ``--no_remat``); returns the run dir."""
    from controllora_tpu_torch.train import main as train_main

    run_dir = os.path.join(args.output_dir, "train")
    print(f"training smoke ControlLoRA: {args.train_steps} steps at "
          f"{args.resolution}^2 -> {run_dir}", file=sys.stderr)
    train_main([
        "--model_variant", "smoke",
        "--dataset_name", "process/fill50k",
        "--resolution", str(args.resolution),
        "--train_batch_size", str(args.train_batch_size),
        "--max_train_steps", str(args.train_steps),
        "--learning_rate", "3e-4",
        "--seed", str(args.seed),
        "--output_dir", run_dir,
        "--mixed_precision", "no",
        "--checkpointing_steps", str(10 ** 9),
        "--device", args.device,
    ])
    return run_dir


def build_pipeline(args, run_dir):
    """The evaluated pipeline: the fp32 smoke stack rebuilt from ``--seed`` as the
    train CLI built it, the run's ControlLoRA, DPM-Solver++."""
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
    from controllora_tpu_torch.training.checkpoint import load_control_lora

    device = torch.device(args.device)
    unet, vae, text_encoder = zoo.frozen_stack(
        None, "smoke", torch.float32, device,
        torch.Generator(device).manual_seed(args.seed))
    control_lora, _ = load_control_lora(run_dir, device)
    return StableDiffusionControlLoRAPipeline(
        unet, vae, text_encoder, default_tokenizer(), control_lora,
        scheduler=DPMSolverMultistepScheduler(), device=device)


def preset_metrics(lats, renders, gt_lat, specs, h, colors, pixel_fit_valid):
    """{preset: report entry} from each preset's generated latents, (n, h/8, w/8, 4),
    and decoded u8 renders, against the exact preset's and the encoded targets."""
    out = {}
    flat_gt = gt_lat.reshape(len(specs), -1)
    flat_exact = lats["exact"].reshape(len(specs), -1)
    n = len(specs)
    for name in PRESETS:
        flat = lats[name].reshape(n, -1)
        # relative behavior vs the exact sampler (the quality bound)
        d2x = ((flat[:, None, :] - flat_exact[None, :, :]) ** 2).mean(-1)  # (n, n)
        rel_err = [float(np.sqrt(d2x[i, i]) / (np.sqrt((flat_exact[i] ** 2).mean())
                                               + 1e-8)) for i in range(n)]
        exact_retrieval = float(np.mean(d2x.argmin(axis=1) == np.arange(n)))
        # conditioning preserved? mean pairwise inter-spec distance, normalized
        pair = [np.sqrt(((flat[i] - flat[j]) ** 2).mean()) for i in range(n)
                for j in range(i + 1, n)]
        sens = float(np.mean(pair) / (np.sqrt((flat ** 2).mean()) + 1e-8))
        # absolute context vs the encoded ground truth
        d2g = ((flat - flat_gt) ** 2).mean(-1)
        nrmse = [float(np.sqrt(d2g[i]) / (flat_gt[i].std() + 1e-8))
                 for i in range(n)]
        center_err, radius_err, drift = [], [], []
        for i, sp in enumerate(specs):
            ce, re_ = circle_errors(renders[name][i], sp, h, colors)
            center_err.append(ce)
            radius_err.append(re_)
            drift.append(float(np.mean(np.abs(
                renders[name][i].astype(np.float32)
                - renders["exact"][i].astype(np.float32)))))
        entry = {
            "tome_ratio": PRESETS[name][0],
            "deepcache_interval": PRESETS[name][1],
            "latent_rel_err_vs_exact_mean": round(float(np.mean(rel_err)), 4),
            "latent_rel_err_vs_exact_max": round(float(np.max(rel_err)), 4),
            "exact_retrieval_acc": round(exact_retrieval, 3),
            "guide_sensitivity": round(sens, 4),
            "latent_nrmse_vs_gt_mean": round(float(np.mean(nrmse)), 1),
            "drift_vs_exact_u8_mean": round(float(np.mean(drift)), 2),
            "drift_vs_exact_u8_max": round(float(np.max(drift)), 2),
        }
        if pixel_fit_valid:
            entry["center_err_px_mean"] = round(float(np.mean(center_err)), 2)
            entry["center_err_px_max"] = round(float(np.max(center_err)), 2)
            entry["radius_err_px_mean"] = round(float(np.mean(radius_err)), 2)
        out[name] = entry
    return out


def main(argv=None):
    from controllora_tpu_torch.data.fill50k import _COLORS, Fill50kSynthetic
    from controllora_tpu_torch.utils.png import encode_png

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    run_dir = args.control_lora_dir or train_run(args)
    pipe = build_pipeline(args, run_dir)

    @torch.inference_mode()
    def decode(lat_nhwc):
        """(h/8, w/8, 4) latents -> the decoded (H, W, 3) image in u8."""
        z = torch.from_numpy(np.ascontiguousarray(lat_nhwc)).to(pipe.device)
        img = pipe.vae.decode(z.permute(2, 0, 1)[None])[0].float()
        return to_u8(img.permute(1, 2, 0).cpu().numpy())

    ds = Fill50kSynthetic(resolution=args.resolution)
    h = args.resolution
    report = {"presets": {}, "train_dir": run_dir,
              "num_eval": args.num_eval, "resolution": args.resolution,
              "num_inference_steps": args.num_inference_steps}
    specs = []
    for i in range(args.num_eval):
        idx = 10_000 + i  # far outside any plausible smoke-training window
        bg, fg, cx, cy, radius = ds._sample_spec(idx)
        ex = ds[idx]
        specs.append(dict(bg=bg, fg=fg, cx=cx, cy=cy, radius=radius,
                          guide=ex["guide_values"], pixels=ex["pixel_values"],
                          caption=f"{fg} circle with {bg} background"))

    # per-spec targets: encoded gt latents (the posterior mean) + the VAE round-trip
    # calibration
    gt_lat = np.stack([pipe.encode_image(sp["pixels"][None])[0].permute(1, 2, 0)
                       .cpu().numpy() for sp in specs])        # (n, h/8, w/8, 4)
    roundtrip = [decode(lat) for lat in gt_lat]
    calib = [circle_errors(rt, sp, h, _COLORS)
             for rt, sp in zip(roundtrip, specs)]
    pixel_fit_valid = all(c[0] < 3.0 and c[1] < 3.0 for c in calib)
    report["vae_roundtrip_center_err_px"] = round(
        float(np.mean([c[0] for c in calib])), 2)
    report["vae_roundtrip_radius_err_px"] = round(
        float(np.mean([c[1] for c in calib])), 2)
    report["pixel_fit_valid"] = pixel_fit_valid
    if not pixel_fit_valid:
        report["pixel_fit_note"] = (
            "random frozen VAE: decode() does not invert encode(), so pixel-space "
            "circle fits are uninformative on the hermetic smoke stack; guide "
            "fidelity is reported in latent space instead")

    lats = {}     # preset -> (n, h/8, w/8, 4) generated latents
    renders = {}  # preset -> [HWC u8]
    for name, (tome_ratio, dc) in PRESETS.items():
        gen = []
        for i, sp in enumerate(specs):
            out = pipe(sp["caption"], guide=sp["guide"],
                       num_inference_steps=args.num_inference_steps,
                       guidance_scale=args.guidance_scale,
                       height=args.resolution, width=args.resolution,
                       generator=torch.Generator().manual_seed(1000 + i),
                       tome_ratio=tome_ratio, deepcache_interval=dc,
                       tome_min_tokens=0,  # smoke latents are tiny; don't gate
                       return_latents=True)
            gen.append(np.asarray(out[0], np.float32))
        lats[name] = np.stack(gen)
        renders[name] = [decode(lat) for lat in lats[name]]

    report["presets"] = preset_metrics(lats, renders, gt_lat, specs, h, _COLORS,
                                       pixel_fit_valid)

    # montage: row 0 = guides, row 1 = VAE-roundtripped targets (the best any render
    # could look through this VAE), then one row per preset
    rows = [np.concatenate(
        [(127.5 * (sp["guide"] + 1)).astype(np.uint8) for sp in specs], axis=1)]
    rows += [np.concatenate(roundtrip, axis=1)]
    rows += [np.concatenate(renders[n], axis=1) for n in PRESETS]
    path = os.path.join(args.output_dir, "presets_montage.png")
    with open(path, "wb") as f:
        f.write(encode_png(np.concatenate(rows, axis=0)))
    report["montage"] = path

    line = json.dumps(report)
    print(line, flush=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
