"""Continuous micro-batching serving engine (counterpart of
``controllora_tpu/serving/engine.py``).

Concurrent requests coalesce into per-image-prompt batches over one pipeline:

* **Bucketed batch shapes.** Batches pad up to the next bucket (default 1/2/4/8) by
  repeating the last request; padded outputs are dropped.
* **Composition-independent results.** Each request's initial latents come from its
  own seed at submit time, ``torch.Generator().manual_seed(seed)`` drawing an
  (1, H/8, W/8, 4) standard normal, and ride the pipeline's ``latents=`` argument, so
  a request renders the same image in a batch of 1 or 8 (up to fp reassociation),
  under ToMe too: its merge maps are per row and its window draws do not depend on
  the batch.
  The torch generator is not ``jax.random``: the same seed gives DIFFERENT latents,
  hence different images, than the JAX engine.
* **Compatibility groups.** Only requests with identical (steps, resolution,
  guidance, lora_scale, guided-ness, output kind) share a batch; others are held for
  the next one. So an SDXL batch shares its size ids, and each request's prompt
  brings its own pooled text vector (per-image prompts in the pipeline).
* **One dispatch thread** owns the device; a forming batch waits at most
  ``max_wait_ms`` for companions.
* **Counters and spans.** ``stats`` counts requests, batches by bucket, padded slots,
  errors and the queue wait (``queue_wait_s`` summed, ``queue_wait_max_s``), a batch's
  counters changing together under a lock that ``snapshot()`` also takes. The wait
  runs from ``submit`` to the batch's pipeline call, on the monotonic clock; while a
  ``torch.profiler`` records, each request's wait is also span ``engine.queue``
  (``utils/spans.py``), ending at that call.
* **Data meshes** (a pipeline with a 'data' axis, JAX :93-105, 138-147, 213-217): the
  buckets snap up to multiples of the axis, since the batch must divide over it; a
  data mesh takes one replicated guide a call, so a guided request's guide joins its
  group key as a SHA-256 fingerprint and a batch passes the one shared guide.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from controllora_tpu_torch.utils import spans


@dataclass
class Request:
    prompt: str
    negative_prompt: str = ""
    guide: Optional[np.ndarray] = None  # (H, W, 3) in [-1, 1]
    num_inference_steps: int = 20
    guidance_scale: float = 9.0
    height: int = 512
    width: int = 512
    seed: int = 0
    lora_scale: float = 1.0
    return_array: bool = False
    # internal
    _latents: Any = field(default=None, repr=False)
    _future: Any = field(default=None, repr=False)
    _guide_fp: Any = field(default=None, repr=False)  # guide identity on a data mesh
    _submitted_ns: int = field(default=0, repr=False)  # time.monotonic_ns() at submit

    @property
    def group_key(self):
        """Requests sharing this key can render in one batched pipeline call."""
        return (self.num_inference_steps, self.height, self.width,
                float(self.guidance_scale), float(self.lora_scale),
                self.guide is not None, self.return_array, self._guide_fp)


def request_latents(seed: int, height: int, width: int, channels: int = 4) -> np.ndarray:
    """A request's initial latents (1, H/8, W/8, C) from its seed."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn((1, height // 8, width // 8, channels), generator=g).numpy()


class BatchingEngine:
    def __init__(self, pipe, max_wait_ms: float = 25.0,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 pipe_kwargs: Optional[Dict[str, Any]] = None, device=None):
        """``pipe``: a StableDiffusionControlLoRAPipeline. ``max_wait_ms``: how long a
        forming batch waits for companions. ``buckets``: allowed batch sizes; the
        largest is the cap. ``pipe_kwargs``: extra kwargs for every pipeline call.
        ``device``: the device the engine serves on, which must be the pipeline's
        (default: the pipeline's); latents are drawn on the CPU and moved there."""
        self.device = torch.device(device) if device is not None else pipe.device
        if self.device != pipe.device:
            raise ValueError(f"engine device {self.device} but the pipeline runs on "
                             f"{pipe.device}")
        self.pipe = pipe
        self.pipe_kwargs = dict(pipe_kwargs or {})
        self.max_wait_ms = float(max_wait_ms)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        mesh = getattr(pipe, "mesh", None)
        self._data_axis = mesh.size("data") if mesh is not None else 1
        if self._data_axis > 1:
            # a lone request on a data-4 mesh renders as a padded batch of 4
            d = self._data_axis
            self.buckets = tuple(sorted({-(-b // d) * d for b in self.buckets}))
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._held: list = []  # incompatible leftovers, FIFO priority next round
        self._stop = threading.Event()
        self.stats: Dict[str, Any] = {"requests": 0, "batches": 0, "padded_slots": 0,
                                      "batch_sizes": {}, "errors": 0,
                                      "queue_wait_s": 0.0, "queue_wait_max_s": 0.0}
        self._stats_lock = threading.Lock()  # held while a batch's counters change
        if mesh is not None:
            self.stats["mesh"] = mesh.shape
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._worker.start()

    # ------------------------------------------------------------------ client

    def submit(self, prompt: str, **kw) -> Future:
        """Enqueue one request; resolves to its image (HWC uint8, or a float array
        with return_array=True)."""
        req = Request(prompt=prompt, **kw)
        if req.guide is not None:
            g = np.asarray(req.guide, np.float32)
            if g.ndim != 3 or g.shape[:2] != (req.height, req.width):
                raise ValueError(f"guide shape {g.shape} must be "
                                 f"({req.height}, {req.width}, 3)")
            req.guide = g
            if self._data_axis > 1:
                # a digest: a colliding 64-bit hash would render with the wrong guide
                req._guide_fp = hashlib.sha256(g.tobytes()).digest()
        req._latents = request_latents(req.seed, req.height, req.width,
                                       self.pipe.unet.config.in_channels)
        req._future = Future()
        req._submitted_ns = time.monotonic_ns()
        self._q.put(req)
        return req._future

    def snapshot(self) -> Dict[str, Any]:
        """A copy of ``stats`` with no batch half counted (``GET /stats``)."""
        with self._stats_lock:
            return dict(self.stats, batch_sizes=dict(self.stats["batch_sizes"]))

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._worker.join(timeout=timeout)

    # ------------------------------------------------------------------ worker

    def _take_first(self) -> Optional[Request]:
        if self._held:
            return self._held.pop(0)
        try:
            return self._q.get(timeout=0.05)
        except queue.Empty:
            return None

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self._take_first()
            if first is None:
                continue
            batch = [first]
            cap = self.buckets[-1]
            deadline = time.monotonic() + self.max_wait_ms / 1000.0
            keep = []
            for r in self._held:
                (batch if len(batch) < cap and r.group_key == first.group_key
                 else keep).append(r)
            self._held = keep
            while len(batch) < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if r.group_key == first.group_key:
                    batch.append(r)
                else:
                    self._held.append(r)
            self._run(batch)

    def _run(self, batch) -> None:
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        pad = bucket - n
        reqs = batch + [batch[-1]] * pad  # padded slots repeat the last request
        first = batch[0]
        kw: Dict[str, Any] = dict(
            self.pipe_kwargs,
            negative_prompt=[r.negative_prompt for r in reqs],
            num_inference_steps=first.num_inference_steps,
            guidance_scale=first.guidance_scale,
            height=first.height, width=first.width,
            lora_scale=first.lora_scale,
            latents=np.concatenate([r._latents for r in reqs], axis=0),
            return_array=first.return_array,
        )
        if first.guide is not None:
            # a data mesh: the one guide the group key pinned, replicated
            kw["guide"] = (first.guide if self._data_axis > 1
                           else np.stack([r.guide for r in reqs]))
        try:
            t0 = time.monotonic()
            called_ns, wall_ns = time.monotonic_ns(), time.time_ns()
            waits_ns = [called_ns - r._submitted_ns for r in batch]
            for w in waits_ns:  # on the profiler's clock: the same wait, ending now
                spans.record("engine.queue", wall_ns - w, wall_ns)
            waits = [w * 1e-9 for w in waits_ns]
            imgs = self.pipe([r.prompt for r in reqs], **kw)
            dt = time.monotonic() - t0
            for r, img in zip(batch, imgs[:n]):
                r._future.set_result(img)
            with self._stats_lock:
                self.stats["requests"] += n
                self.stats["queue_wait_s"] += sum(waits)
                self.stats["queue_wait_max_s"] = max(self.stats["queue_wait_max_s"], *waits)
                self.stats["batches"] += 1
                self.stats["padded_slots"] += pad
                sizes = self.stats["batch_sizes"]
                sizes[bucket] = sizes.get(bucket, 0) + 1
                self.stats["last_batch_seconds"] = dt
        except Exception as e:  # fail the whole batch, keep serving
            with self._stats_lock:
                self.stats["errors"] += 1
            for r in batch:
                if not r._future.done():
                    r._future.set_exception(e)
