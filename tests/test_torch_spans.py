"""The port's host spans (``controllora_tpu_torch/utils/spans.py``) on the CPU: off
unless a ``torch.profiler`` session records, on the profiler's clock (``time.time_ns``),
nested by thread; the sites in the serving engine, the pipeline, the trainer and the
prefetch queue; the engine's queue-wait counters and ``snapshot``.

    python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.data.fastloader import Prefetcher
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import derive_cross_attention_dims
from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
from controllora_tpu_torch.serving import BatchingEngine
from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch
from controllora_tpu_torch.utils import spans

RES, STEPS = 64, 2


@pytest.fixture(autouse=True)
def _fresh():
    spans.clear()
    with torch.enable_grad():
        yield
    spans.clear()


@pytest.fixture
def recording(monkeypatch):
    """The flag a recording profiler sets, without the profiler."""
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)


def named(name):
    return [s for s in spans.recorded() if s.name == name]


# ---------------------------------------------------------------------------- recorder


def test_off_by_default_records_nothing():
    assert not autograd_profiler._is_profiler_enabled
    assert spans.span("a") is spans.span("b", x=1) is spans._NULL
    with spans.span("a"):
        pass
    spans.record("q", 1, 2, request=3)
    assert spans.traced("t")(lambda: 5)() == 5
    assert spans.recorded() == []


def test_a_recording_profiler_turns_spans_on_and_off():
    from torch.profiler import ProfilerActivity, profile

    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("during", k=1):
            torch.ones(4).sum()
        spans.record("queued", 10, 20)
    with spans.span("after"):
        pass
    got = spans.recorded()
    assert [s.name for s in got] == ["during", "queued"]
    assert got[0].attrs == {"k": 1}


def test_nesting_gives_parents_and_threads(recording):
    def work(tag):
        with spans.span("outer", tag=tag):
            with spans.span("inner", tag=tag):
                spans.record("queued", 1, 2, tag=tag)

    thread = threading.Thread(target=work, args=("t",))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    work("main")
    got = spans.recorded()
    assert len(got) == 6
    for tag in ("t", "main"):
        mine = {s.name: s for s in got if s.attrs["tag"] == tag}
        outer, inner, queued = mine["outer"], mine["inner"], mine["queued"]
        assert outer.parent_id is None
        assert inner.parent_id == outer.span_id and queued.parent_id == inner.span_id
        assert outer.thread_id == inner.thread_id == queued.thread_id
    tids = {s.attrs["tag"]: s.thread_id for s in got}
    assert tids["main"] == threading.get_native_id() != tids["t"]
    assert len({s.span_id for s in got}) == 6


def test_stamps_are_unix_ns_and_ordered(recording):
    t0 = time.time_ns()
    with spans.span("outer"):
        with spans.span("inner"):
            time.sleep(0.002)
    t1 = time.time_ns()
    inner, outer = spans.recorded()
    assert t0 <= outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns <= t1
    assert inner.end_ns - inner.start_ns >= 2_000_000


def test_chrome_trace_holds_the_spans(recording, tmp_path):
    import json

    with spans.span("outer", request=4):
        pass
    path = tmp_path / "spans.json"
    spans.chrome_trace(str(path), spans.recorded())
    (ev,) = json.loads(path.read_text())["traceEvents"]
    (s,) = spans.recorded()
    assert ev["ph"] == "X" and ev["name"] == "outer" and ev["tid"] == s.thread_id
    assert ev["ts"] == s.start_ns / 1e3 and ev["dur"] == (s.end_ns - s.start_ns) / 1e3
    assert ev["args"]["request"] == 4 and ev["args"]["span_id"] == s.span_id


# ---------------------------------------------------------------------------- sites


@pytest.fixture(scope="module")
def smoke():
    gen = torch.Generator().manual_seed(0)
    unet, vae, text = zoo.build_models("smoke", torch.float32, "cpu", gen)
    cfg = ControlLoRAConfig(
        block_out_channels=(8, 16, 16, 32), lora_block_in_channels=(32, 32, 32, 32),
        lora_block_out_channels=(32, 64, 96, 96),
        lora_cross_attention_dims=derive_cross_attention_dims(zoo.SMOKE_UNET))
    control = zoo.build_control_lora(cfg, "cpu", gen)
    return SimpleNamespace(unet=unet, vae=vae, text=text, control=control)


def guide(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (RES, RES, 3)).astype(np.float32)


@pytest.mark.parametrize("clients,buckets", [(1, (1,)), (3, (1, 2, 4))])
def test_engine_queue_and_pipeline_spans(smoke, recording, clients, buckets):
    """One ``engine.queue`` a request, from after its submit to no later than its
    batch's ``pipeline.call`` (and after the call before it); ``queue_wait_s`` is their
    sum; ``pipeline.step`` once a grid index of every call."""
    pipe = StableDiffusionControlLoRAPipeline(smoke.unet, smoke.vae, smoke.text,
                                              HashTokenizer(), smoke.control, device="cpu")
    engine = BatchingEngine(pipe, max_wait_ms=500.0, buckets=buckets, device="cpu")
    try:
        before = time.time_ns()
        futures = [engine.submit(f"p{k}", guide=guide(k), seed=k, num_inference_steps=STEPS,
                                 height=RES, width=RES) for k in range(clients)]
        for f in futures:
            f.result(timeout=600)
    finally:
        engine.stop(timeout=600)
    assert not engine._worker.is_alive()
    queues = named("engine.queue")
    calls = sorted(named("pipeline.call"), key=lambda c: c.start_ns)
    assert len(queues) == clients == engine.stats["requests"]
    assert len(calls) == engine.stats["batches"]
    for q in queues:
        k = next(k for k, c in enumerate(calls) if c.start_ns >= q.end_ns)
        assert before <= q.start_ns <= q.end_ns <= calls[k].start_ns <= calls[k].end_ns
        assert k == 0 or calls[k - 1].end_ns <= q.end_ns
    waits = [(q.end_ns - q.start_ns) * 1e-9 for q in queues]
    assert engine.stats["queue_wait_s"] == pytest.approx(sum(waits), rel=1e-12)
    assert engine.stats["queue_wait_max_s"] == pytest.approx(max(waits), rel=1e-12)
    for call in calls:
        kids = [s for s in spans.recorded() if s.parent_id == call.span_id]
        assert [s.name for s in kids] == ["pipeline.step"] * STEPS
        assert [s.attrs["index"] for s in kids] == list(range(STEPS))
        assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in kids)


def test_train_step_spans(smoke, recording):
    """``train.upload``, then one ``train.step`` whose children are ``train.forward``,
    ``train.backward`` and ``train.optimizer`` in that order."""
    trainer = ControlLoRATrainer(smoke.control, smoke.unet, smoke.vae, smoke.text,
                                 remat_unet=False)
    rng = np.random.default_rng(0)
    batch = {"pixel_values": rng.uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32),
             "guide_values": rng.uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 1000, (1, 77))}
    trainer.train_step(to_device_batch(batch, "cpu"), torch.Generator().manual_seed(0))
    got = spans.recorded()
    assert [s.name for s in got] == ["train.upload", "train.forward", "train.backward",
                                     "train.optimizer", "train.step"]
    step = got[-1]
    assert got[0].parent_id is None and step.parent_id is None
    assert all(s.parent_id == step.span_id for s in got[1:4])
    assert all(a.end_ns <= b.start_ns for a, b in zip(got[1:4], got[2:4]))


@pytest.mark.parametrize("items", [1, 5])
def test_prefetcher_one_wait_a_next(recording, items):
    got = list(Prefetcher(iter(range(items))))
    assert got == list(range(items))
    # the last next() finds the end marker: one wait more than items
    assert len(named("data.wait")) == items + 1
    assert all(s.thread_id == threading.get_native_id() for s in named("data.wait"))


# ---------------------------------------------------------------------------- counters


class _FastPipe:
    """A pipeline that renders at once: the engine's counters, under load."""

    device = torch.device("cpu")
    unet = SimpleNamespace(config=SimpleNamespace(in_channels=4))
    mesh = None

    def __call__(self, prompts, **kw):
        return [np.zeros((8, 8, 3), np.uint8) for _ in prompts]


def test_snapshot_never_shows_a_batch_half_counted():
    """Readers of ``snapshot`` (``GET /stats``) racing the batcher: every copy has
    slots - padding == requests, with the thread switch interval shortened."""
    engine = BatchingEngine(_FastPipe(), max_wait_ms=0.0, buckets=(1, 2, 4, 8),
                            device="cpu")
    bad, seen = [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            s = engine.snapshot()
            slots = sum(int(b) * n for b, n in s["batch_sizes"].items())
            if slots - s["padded_slots"] != s["requests"]:
                bad.append(s)
            seen.append(s["requests"])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=reader) for _ in range(12)]
    try:
        for t in readers:
            t.start()
        for round_ in range(60):
            futures = [engine.submit("x", seed=k, height=64, width=64)
                       for k in range(1 + round_ % 7)]
            for f in futures:
                f.result(timeout=60)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=60)
        sys.setswitchinterval(switch)
        engine.stop(timeout=60)
    assert not any(t.is_alive() for t in readers) and not engine._worker.is_alive()
    assert not bad, bad[:3]
    final = engine.snapshot()
    assert final["requests"] == sum(1 + r % 7 for r in range(60)) and max(seen) > 0
    assert final["queue_wait_max_s"] <= final["queue_wait_s"]
    assert final["queue_wait_s"] > 0 and final["batch_sizes"] is not engine.stats["batch_sizes"]
