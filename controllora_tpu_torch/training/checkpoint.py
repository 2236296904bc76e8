"""Checkpoints (counterpart of ``controllora_tpu/training/checkpoint.py``).

Two paths, as in the JAX package:

  1. The resumable train state: ``checkpoint-<step>`` directories under the output
     directory (``save_train_state`` / ``restore_train_state`` /
     ``checkpoint_step_dirs``), with ``keep`` pruning the oldest and ``latest``
     resolving to the highest step. Orbax is the JAX package's format; here one
     ``torch.save`` of the state (adapter params, optimizer state with the 8-bit
     moments and the schedule, step, generator states) as ``train_state.pt``, plus the
     adapter artifact below in ``control_lora/``. A directory is written under a
     temporary name and renamed when complete, so a reader only ever sees whole
     checkpoints. ``Checkpointer`` saves in a background thread on CPU copies of the
     state (the JAX async orbax save), one save in flight at a time; ``finalize``
     drains it (``finalize_checkpoints``).
  2. The final ControlLoRA artifact: ``config.json`` plus
     ``diffusion_pytorch_model.bin``, a ``torch.save`` of the reference-named fp32
     state dict, which the JAX package's ``load_control_lora`` and the reference's
     ``ControlLoRA.from_pretrained`` read as they are (no ``safetensors`` on the card).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.models.control_lora import ControlLoRA

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "diffusion_pytorch_model.bin"
STATE_NAME = "train_state.pt"
ARTIFACT_DIR = "control_lora"


# ---------------------------------------------------------------------------- artifact


def _write_artifact(output_dir: str, config: ControlLoRAConfig,
                    state_dict: Dict[str, torch.Tensor]) -> str:
    os.makedirs(output_dir, exist_ok=True)
    config.save_json(os.path.join(output_dir, CONFIG_NAME))
    sd = {k: v.detach().float().cpu().contiguous() for k, v in state_dict.items()}
    torch.save(sd, os.path.join(output_dir, WEIGHTS_NAME))
    return output_dir


def save_control_lora(output_dir: str, control_lora: ControlLoRA) -> str:
    return _write_artifact(output_dir, control_lora.config, control_lora.state_dict())


def load_control_lora(path: str, device="cuda") -> Tuple[ControlLoRA, ControlLoRAConfig]:
    """A saved artifact directory -> (ControlLoRA on ``device``, fp32; its config).
    The load is strict: a missing or extra key fails."""
    from controllora_tpu_torch.models import zoo

    cfg = ControlLoRAConfig.from_json(os.path.join(path, CONFIG_NAME))
    model = zoo.build_control_lora(cfg, device)
    sd = torch.load(os.path.join(path, WEIGHTS_NAME), map_location=device, weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model, cfg


# ---------------------------------------------------------------------------- train state


def checkpoint_step_dirs(output_dir: str) -> List[Tuple[int, str]]:
    """(step, path) of the complete ``checkpoint-<step>`` directories, ascending
    (reference train:713-722)."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for d in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", d)
        if m and os.path.isfile(os.path.join(output_dir, d, STATE_NAME)):
            out.append((int(m.group(1)), os.path.join(output_dir, d)))
    return sorted(out)


def cpu_copy(tree: Any) -> Any:
    """The state with every tensor copied to the CPU (a snapshot the train loop can
    no longer change)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_copy(v) for v in tree)
    return tree


def save_train_state(output_dir: str, step: int, state: Dict[str, Any],
                     config: Optional[ControlLoRAConfig], keep: Optional[int] = None,
                     artifact: Optional[Callable[[str, Any], Any]] = None) -> str:
    """Write ``output_dir/checkpoint-<step>`` (the state, and the adapter artifact of
    ``state["params"]``: the ControlLoRA's under ``control_lora/``, or what
    ``artifact(checkpoint dir, params)`` writes), then prune all but the newest
    ``keep`` checkpoints (the reference's --checkpoints_total_limit)."""
    path = os.path.join(output_dir, f"checkpoint-{step}")
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_NAME))
    if artifact is None:
        _write_artifact(os.path.join(tmp, ARTIFACT_DIR), config, state["params"])
    else:
        artifact(tmp, state["params"])
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if keep is not None:
        for _, old in checkpoint_step_dirs(output_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def restore_train_state(output_dir: str, step: Union[str, int] = "latest"
                        ) -> Tuple[Optional[Dict[str, Any]], int]:
    """Load ``checkpoint-<step>`` (or the latest) onto the CPU. Returns (state, step),
    or (None, 0) when there is none: the reference then starts fresh (train:723-727)."""
    dirs = checkpoint_step_dirs(output_dir)
    if step != "latest":
        dirs = [d for d in dirs if d[0] == int(step)]
    if not dirs:
        return None, 0
    step_num, path = dirs[-1]
    state = torch.load(os.path.join(path, STATE_NAME), map_location="cpu", weights_only=True)
    return state, step_num


class Checkpointer:
    """Saves train states one at a time: in the caller's thread with ``wait``, else
    in a background thread on a CPU copy taken before ``save`` returns. A new save
    first drains the one in flight; ``finalize`` drains the last and raises its
    error, if any."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, output_dir: str, step: int, state: Dict[str, Any],
             config: Optional[ControlLoRAConfig], keep: Optional[int] = None,
             wait: bool = True, artifact: Optional[Callable[[str, Any], Any]] = None) -> str:
        self.finalize()
        state = cpu_copy(state)
        path = os.path.join(output_dir, f"checkpoint-{step}")
        if wait:
            save_train_state(output_dir, step, state, config, keep, artifact)
            return path

        def run():
            try:
                save_train_state(output_dir, step, state, config, keep, artifact)
            except Exception as e:  # re-raised by finalize()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-{step}")
        self._thread.start()
        return path

    def finalize(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
