"""Whole runs of the harness on the CPU at a reduced size (the smoke stacks of
``tests/data``), past its look for a card: each comes out correct, and with the timed
path broken underneath, each fault the cell can have makes ``correct`` false. The
control, the plain reference in fp8 in the program's place, fails the limits too.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import control, run, spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 2**31 + 12345  # wider than 32 signed bits, as the driver's are


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.enable_grad():
        yield
    torch.set_num_threads(n)


def cell(name):
    return spec.load_cell(name, root=DATA, bench_dir=DATA)


def run_once(name, trace=False):
    return run.run_cell(cell(name), SEED, 1.0, trace, "cpu", log=lambda line: None)


def alter_image(slot):
    """A fault in one slot of every batch the window renders: its image inverted."""

    def fault(monkeypatch):
        from controllora_tpu_torch.pipelines.text_to_image import (
            StableDiffusionControlLoRAPipeline,
        )

        call = StableDiffusionControlLoRAPipeline.__call__

        def altered(self, *a, **kw):
            out = call(self, *a, **kw)
            if kw.get("num_inference_steps", 20) > 2 and len(out) > slot:  # not warm-up
                out[slot] = (255 - out[slot]).astype(np.uint8)
            return out

        monkeypatch.setattr(StableDiffusionControlLoRAPipeline, "__call__", altered)

    fault.__name__ = f"alter_image_slot{slot}"
    return fault


def sampler_step_unchanged(monkeypatch):
    from controllora_tpu_torch.schedulers.dpmsolver import DPMSolverMultistepScheduler

    monkeypatch.setattr(DPMSolverMultistepScheduler, "step", lambda self, state, *a, **k: state)


def optimizer_step_unchanged(monkeypatch):
    from controllora_tpu_torch.training.trainer import AdapterOptimizer

    monkeypatch.setattr(AdapterOptimizer, "step", lambda self, grads: True)


def half_batch(monkeypatch):
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer

    loss = ControlLoRATrainer.loss

    def half(self, batch, *a, **kw):
        return loss(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(ControlLoRATrainer, "loss", half)


@pytest.mark.parametrize("name", ["smoke-serve", "smokexl-serve", "smoke-serve-open", "smoke-train"])
def test_sound_run_is_correct(name):
    result = run_once(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    ("smoke-serve", alter_image(0)),
    ("smoke-serve", alter_image(1)),
    ("smoke-serve", sampler_step_unchanged),
    ("smoke-train", optimizer_step_unchanged),
    ("smoke-train", half_batch),
])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run_once(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["smoke-serve", "smoke-train"])
def test_control_fails_the_limits(name):
    c = cell(name)
    driver = spec.driver(c.traffic["kind"])
    session = driver.Session(c, SEED, "cpu")
    readings = ([control.serve_control(session, SEED)] if driver.KIND == "serve"
                else list(control.train_controls(session, SEED)))
    limits = c.traffic["limits"]
    for reading in readings:
        assert any(reading[k] > limits[k] for k in limits), reading
