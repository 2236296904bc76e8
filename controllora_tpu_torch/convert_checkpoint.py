"""Checkpoint conversion CLI (counterpart of ``scripts/convert_checkpoint.py``, with
its subcommands, flags and printed lines).

    python -m controllora_tpu_torch.convert_checkpoint import-sd <dir>
    python -m controllora_tpu_torch.convert_checkpoint import-controllora <dir>
    python -m controllora_tpu_torch.convert_checkpoint export-controllora \
        --run_dir <training output dir> --config <preset or json> --out <dir>

- ``import-sd``: load a diffusers-layout SD checkpoint directory through the loader
  the CLIs use (``zoo.load_frozen``, bf16) and report each component's parameter
  count, which catches layout problems before a run. The model variant is read off
  the UNet file's shapes (``zoo.infer_variant``).
- ``import-controllora``: load a ControlLoRA artifact (``config.json`` +
  ``diffusion_pytorch_model.bin``) strictly.
- ``export-controllora``: write the reference's artifact from the latest
  ``checkpoint-<step>`` of a training run. The JAX script reads an orbax train state;
  this one reads the port's own (``training/checkpoint.py``: ``train_state.pt``).

``--device`` (default cuda) is where the weights are loaded.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", type=str, default="cuda",
                        help="torch device the weights are loaded on")

    s = sub.add_parser("import-sd", parents=[device])
    s.add_argument("path")

    s = sub.add_parser("export-controllora", parents=[device])
    s.add_argument("--run_dir", required=True,
                   help="training output dir (the port's checkpoint-<step>/train_state.pt)")
    s.add_argument("--config", required=True, help="preset name or config json")
    s.add_argument("--out", required=True)

    s = sub.add_parser("import-controllora", parents=[device])
    s.add_argument("path", help="dir with config.json + diffusion_pytorch_model.*")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    args = parse_args(argv)
    if args.cmd == "import-sd":
        from controllora_tpu_torch.models import zoo

        modules = zoo.load_frozen(args.path, zoo.infer_variant(args.path), torch.bfloat16,
                                  args.device)
        for name, module in zip(("unet", "vae", "text"), modules):
            n = sum(p.numel() for p in module.parameters())
            print(f"{name}: {n/1e6:.1f}M params ok")
    elif args.cmd == "import-controllora":
        from controllora_tpu_torch.training.checkpoint import load_control_lora

        model, cfg = load_control_lora(args.path, args.device)
        n = sum(p.numel() for p in model.parameters())
        print(f"ControlLoRA v{cfg.control_version}: {n/1e6:.2f}M params ok")
    else:
        from controllora_tpu_torch.config import load_config
        from controllora_tpu_torch.models import zoo
        from controllora_tpu_torch.training.checkpoint import (
            restore_train_state,
            save_control_lora,
        )

        cfg = load_config(args.config)
        state, step = restore_train_state(args.run_dir)
        if state is None:
            raise SystemExit(f"no checkpoint under {args.run_dir}")
        model = zoo.build_control_lora(cfg, args.device)
        model.load_state_dict(state["params"], strict=True)
        save_control_lora(args.out, model)
        print(f"exported step-{step} adapter to {args.out}")


if __name__ == "__main__":
    main()
