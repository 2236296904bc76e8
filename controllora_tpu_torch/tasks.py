"""The reference's canned tasks on the port's CLIs (counterpart of ``tasks/*.py``).

    python -m controllora_tpu_torch.tasks train_canny --pretrained_model_name_or_path <dir>
    python -m controllora_tpu_torch.tasks test_canny --num_validation_images 1
    python -m controllora_tpu_torch.tasks --list

Each task pins the reference's hyperparameters (reference tasks/train_canny.py:14-25:
512², batch 1, lr 1e-4, 30k steps, seed 42) and spawns ``python -m
controllora_tpu_torch.<cli>`` with the JAX launcher's argument list, element for
element (``tasks/_launch.py`` and ``tasks/{train,test}_*.py``, copied here); the
arguments after the task's name go last, so a repeated flag overrides the pinned one.
The exit code is the CLI's.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Tuple


# Reference hyperparameters shared across tasks (reference tasks/train_canny.py:14-25):
# 512 resolution, batch 1 (paper setting) / 16 (trainer default), lr 1e-4, 30k steps,
# seed 42.
def train_defaults(config: str, dataset: str, output_dir: str, extra=()):
    return [
        "--control_lora_config", config,
        "--dataset_name", dataset,
        "--resolution", "512",
        "--train_batch_size", "1",
        "--learning_rate", "1e-4",
        "--max_train_steps", "30000",
        "--checkpointing_steps", "500",
        "--seed", "42",
        "--output_dir", output_dir,
        *extra,
    ]


def test_defaults(control_dir: str, dataset: str, output_dir: str, extra=()):
    return [
        "--control_lora_dir", control_dir,
        "--dataset_name", dataset,
        "--resolution", "512",
        "--num_inference_steps", "30",
        "--num_validation_images", "4",
        "--output_dir", output_dir,
        *extra,
    ]


VALIDATION_PROMPT = "portrait of female HighCWu as a cute pink hair girl"

# task -> (the port's CLI module, its pinned arguments)
TASKS: Dict[str, Tuple[str, List[str]]] = {
    "train_canny": ("train", train_defaults(
        "diffusiondb-canny", "process/diffusiondb_canny", "control-lora-canny")),
    "train_canny_v2": ("train", train_defaults(
        "diffusiondb-canny-v2", "process/diffusiondb_canny", "control-lora-canny_v2")),
    "train_fill50k": ("train", train_defaults(
        "fill50k", "process/fill50k", "control-lora-fill50k")),
    "train_pose": ("train", train_defaults(
        "mpii-pose", "process/mpii_pose", "control-lora-pose")),
    "train_pose_v2": ("train", train_defaults(
        "mpii-pose-v2", "process/mpii_pose", "control-lora-pose_v2")),
    "train_sketch": ("train", train_defaults(
        "danbooru-sketch", "process/danbooru_sketch", "control-lora-sketch")),
    # DreamBooth LoRA (reference tasks/train_lora.py; the instance dir and prompts are
    # the user's to override)
    "train_lora": ("train_dreambooth", [
        "--instance_data_dir", "data/instance",
        "--instance_prompt", "portrait of male HighCWu",
        "--output_dir", "ckpts/sd-highcwu_v1-model-lora",
        "--resolution", "512",
        "--train_batch_size", "1",
        "--gradient_accumulation_steps", "1",
        "--checkpointing_steps", "100",
        "--resume_from_checkpoint", "latest",
        "--learning_rate", "1e-4",
        "--report_to", "wandb",
        "--lr_scheduler", "constant",
        "--lr_warmup_steps", "0",
        "--max_train_steps", "2000",
        "--validation_prompt", VALIDATION_PROMPT,
        "--validation_epochs", "50",
        "--lora_rank", "4",
        "--seed", "0",
    ]),
    "test_canny": ("sample", test_defaults(
        "control-lora-canny", "process/diffusiondb_canny", "samples/canny")),
    "test_canny_v2": ("sample", test_defaults(
        "control-lora-canny_v2", "process/diffusiondb_canny", "samples/canny_v2")),
    "test_fill50k": ("sample", test_defaults(
        "control-lora-fill50k", "process/fill50k", "samples/fill50k")),
    "test_pose": ("sample", test_defaults(
        "control-lora-pose", "process/mpii_pose", "samples/pose")),
    "test_pose_v2": ("sample", test_defaults(
        "control-lora-pose_v2", "process/mpii_pose", "samples/pose_v2")),
    "test_sketch": ("sample", test_defaults(
        "control-lora-sketch", "process/danbooru_sketch", "samples/sketch")),
    # the DreamBooth LoRA from its latest checkpoint, re-saving the run-root artifact
    # (reference test_dreambooth_lora.py:824-886)
    "test_lora": ("sample", [
        "--lora_weights", "ckpts/sd-highcwu_v1-model-lora",
        "--resume_from_checkpoint", "latest",
        "--prompt", VALIDATION_PROMPT,
        "--resolution", "512",
        "--num_validation_images", "4",
        "--num_inference_steps", "25",
        "--output_dir", "samples/lora",
        "--seed", "0",
    ]),
}


def command(task: str, extra: List[str]) -> List[str]:
    """The command line of ``task`` with the user's ``extra`` arguments last."""
    if task not in TASKS:
        raise SystemExit(f"unknown task {task!r}; known: {', '.join(sorted(TASKS))}")
    cli, args = TASKS[task]
    return [sys.executable, "-m", f"controllora_tpu_torch.{cli}", *args, *extra]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "--list"):
        print(__doc__)
        print("tasks: " + ", ".join(sorted(TASKS)))
        return 0
    cmd = command(argv[0], argv[1:])
    print("+", " ".join(cmd), flush=True)
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
