"""Dataset builders (counterpart of ``tasks/make_dataset_fill50k.py`` and
``tasks/make_dataset_diffusiondb_canny.py``): the same files, pixels and prompt.jsonl
bytes, with no PIL (PNGs through ``utils/png.py``). The Canny guides are computed on
``--device``, the card by default.

    python -m controllora_tpu_torch.make_dataset fill50k --out data/fill50k --num 50000
    python -m controllora_tpu_torch.make_dataset diffusiondb_canny --out data/diffusiondb-canny
    python -m controllora_tpu_torch.tasks make_dataset_fill50k --num 8 --device cpu

Each writes ``<out>/images/<i>.png``, ``<out>/guides/<i>.png`` and
``<out>/prompt.jsonl`` (``{"image", "guide", "text"}`` a line), which
``process_datasets._JsonlGuideDataset`` reads with ``data_root=<out>``. fill50k's
images and guides are RGB; the Canny guides are 8-bit grayscale, as PIL writes the
JAX script's mode "L" maps. A CUDA ``--device`` where CUDA is absent raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from controllora_tpu_torch.utils.png import encode_png


def _write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _write_records(out: str, texts) -> None:
    with open(os.path.join(out, "prompt.jsonl"), "w") as f:
        for i, text in enumerate(texts):
            f.write(json.dumps({"image": f"images/{i}.png", "guide": f"guides/{i}.png",
                                "text": text}) + "\n")


def _make_dirs(out: str) -> None:
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    os.makedirs(os.path.join(out, "guides"), exist_ok=True)


def fill50k(out: str, num: int = 50_000, resolution: int = 512) -> None:
    """``num`` fill50k pairs (``data/fill50k.py``) at ``resolution`` into ``out``."""
    from controllora_tpu_torch.data.fill50k import Fill50kSynthetic

    ds = Fill50kSynthetic(resolution=resolution, size=num)
    _make_dirs(out)
    captions = []
    for i in range(num):
        bg, fg, *_ = ds._sample_spec(i)
        item = ds[i]
        # the JAX script's conversion of the [-1, 1] float32 item, not the palette: the
        # float32 round trip and the truncating cast write 63 of the 256 levels one
        # lower (red's (220, 40, 40) as (220, 39, 39)), and the files must match
        img = ((item["pixel_values"] + 1) * 127.5).astype(np.uint8)
        gd = ((item["guide_values"] + 1) * 127.5).astype(np.uint8)
        _write_png(os.path.join(out, "images", f"{i}.png"), img)
        _write_png(os.path.join(out, "guides", f"{i}.png"), gd)
        captions.append(f"{fg} circle with {bg} background")
        if (i + 1) % 1000 == 0:
            print(f"{i+1}/{num}")
    _write_records(out, captions)
    print(f"wrote {num} pairs to {out}")


def diffusiondb_canny(out: str, num: int = 5000, resolution: int = 512, seed: int = 0,
                      device="cuda") -> None:
    """``num`` procedural images with Canny guides at fixed thresholds, low in [1, 10)
    and high in [130, 150) drawn per image from ``seed``, into ``out``; the detector
    runs on ``device``."""
    from controllora_tpu_torch.annotators import CannyDetector
    from controllora_tpu_torch.data.process_datasets import _procedural_image, _resize_short

    rng = np.random.default_rng(seed)
    det = CannyDetector(device)
    _make_dirs(out)
    for i in range(num):
        img = _resize_short(_procedural_image(i, resolution + 32), resolution)
        img = img[:resolution, :resolution]
        lo = int(rng.integers(1, 10))
        hi = int(rng.integers(130, 150))
        guide = det(img, lo, hi)
        _write_png(os.path.join(out, "images", f"{i}.png"), img)
        _write_png(os.path.join(out, "guides", f"{i}.png"), guide)
        if (i + 1) % 500 == 0:
            print(f"{i+1}/{num}")
    _write_records(out, [f"scene {i}" for i in range(num)])
    print(f"wrote {num} pairs to {out}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="builder", required=True)
    for name, out, num in (("fill50k", "data/fill50k", 50_000),
                           ("diffusiondb_canny", "data/diffusiondb-canny", 5000)):
        b = sub.add_parser(name)
        b.add_argument("--out", default=out)
        b.add_argument("--num", type=int, default=num)
        b.add_argument("--resolution", type=int, default=512)
        if name == "diffusiondb_canny":
            b.add_argument("--seed", type=int, default=0)
        b.add_argument("--device", type=str, default="cuda",
                       help="where the Canny detector runs (cuda, or cpu where there is "
                            "no card); fill50k only checks it")
    return p.parse_args(argv)


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the builders run on the card by default and no CUDA device is "
                           "available: pass --device cpu to build on the CPU")
    if args.builder == "fill50k":
        fill50k(args.out, args.num, args.resolution)
    else:
        diffusiondb_canny(args.out, args.num, args.resolution, args.seed, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
