"""Metrics and image logging for the trainers (counterpart of
``controllora_tpu/utils/logging.py``).

The JSONL sink, ``<output_dir>/metrics.jsonl`` with one ``{"step", "time", metric:
value}`` line a call, is always on; images go to ``<output_dir>/images/<tag>-<step>.png``
through the port's own PNG codec (``utils/png.py``). ``report_to`` names the extra
sinks: ``jsonl`` (none), ``tensorboard``, ``wandb``, ``comet_ml`` or ``all``. Their
packages are imported only when asked for, and one that is missing raises an
ImportError that names it (the card's machine has none of them).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from controllora_tpu_torch.utils.png import encode_png

REPORT_TO = ("jsonl", "tensorboard", "wandb", "comet_ml", "all")


def _require(package: str, report_to: str):
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"--report_to {report_to} needs the {package.split('.')[0]!r} "
                          "package, which is not installed; use --report_to jsonl") from e


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "jsonl", enabled: bool = True):
        """``enabled=False`` makes every sink a no-op: the ranks other than 0 of a
        data-parallel run."""
        if report_to not in REPORT_TO:
            raise ValueError(f"unknown report_to {report_to!r}; known: {REPORT_TO}")
        self.jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        self._jsonl = self._tb = self._wandb = self._comet = None
        self._t0 = time.time()
        self.enabled = enabled
        if not enabled:
            return
        wants = {"tensorboard", "wandb", "comet_ml"} if report_to == "all" else {report_to}
        os.makedirs(output_dir, exist_ok=True)
        if "tensorboard" in wants:
            tb = _require("torch.utils.tensorboard", report_to)
            self._tb = tb.SummaryWriter(os.path.join(output_dir, "tb"))
        if "wandb" in wants:
            self._wandb = _require("wandb", report_to).init(
                project=os.environ.get("WANDB_PROJECT", "controllora_tpu"),
                dir=output_dir, resume="allow")
        if "comet_ml" in wants:
            self._comet = _require("comet_ml", report_to).Experiment(
                project_name=os.environ.get("COMET_PROJECT", "controllora_tpu"))
        self._jsonl = open(self.jsonl_path, "a")

    def log(self, step: int, metrics: Dict[str, float]):
        if not self.enabled:
            return
        values = {k: float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3), **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(values, step=int(step))
        if self._comet is not None:
            self._comet.log_metrics(values, step=int(step))

    def image_path(self, step: int, tag: str) -> str:
        return os.path.join(os.path.dirname(self.jsonl_path), "images", f"{tag}-{step}.png")

    def log_image(self, step: int, tag: str, image_u8: np.ndarray):
        """image_u8: HWC uint8 RGB, saved as a PNG (and to tensorboard / wandb)."""
        if not self.enabled:
            return
        path = self.image_path(step, tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_png(np.ascontiguousarray(image_u8)))
        if self._tb is not None:
            self._tb.add_image(tag, image_u8, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb

            self._wandb.log({tag: wandb.Image(image_u8)}, step=int(step))

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()
