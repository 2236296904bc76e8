"""The native data plane (counterpart of ``controllora_tpu/data/fastloader.py``):
batch synthesis and normalisation in C (``csrc/fastloader.c``, pthreads), and a
background-thread prefetch queue that makes the next batches while the card runs
the step.

The C source is the port's copy of ``native/fastloader.c`` behind a plain C
interface: it is compiled with the host's C compiler (``$CC``, default ``cc``) into
``csrc/_build/libfastloader.so`` at first use, and loaded with ctypes. Where that
fails, ``native_available()`` is False and says why (``native_error()``), and the
trainers use the Python ``batch_iterator``.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from controllora_tpu_torch.utils import spans

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fastloader.c"
LIBRARY = SOURCE.parent / "_build" / "libfastloader.so"
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile the C source when the library is missing or older, then load it."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if (not LIBRARY.exists()
                    or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
                LIBRARY.parent.mkdir(parents=True, exist_ok=True)
                tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
                subprocess.run([os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
                                "-pthread", str(SOURCE), "-o", str(tmp), "-lm"],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, LIBRARY)
            lib = ctypes.CDLL(str(LIBRARY))
            lib.fill50k_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.normalize_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_size_t, ctypes.c_int]
            lib.fill50k_batch.restype = lib.normalize_u8.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None) or ""
            _error = f"{e} {detail}".strip()
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def native_error() -> Optional[str]:
    """Why the native library could not be built or loaded (None if it was)."""
    _build_and_load()
    return _error


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def fill50k_batch_native(specs: np.ndarray, resolution: int, nthreads: int = 8):
    """specs: (B, 9) float32 [cx, cy, radius, bg RGB, fg RGB] -> (pixels, guides)
    float32 NHWC in [-1, 1]."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    specs = np.ascontiguousarray(specs, np.float32)
    if specs.ndim != 2 or specs.shape[1] != 9:
        raise ValueError(f"specs must be (B, 9), got {specs.shape}")
    b = specs.shape[0]
    pixels = np.empty((b, resolution, resolution, 3), np.float32)
    guides = np.empty((b, resolution, resolution, 3), np.float32)
    lib.fill50k_batch(_ptr(specs), _ptr(pixels), _ptr(guides), b, resolution, nthreads)
    return pixels, guides


def normalize_u8_native(src: np.ndarray, nthreads: int = 8) -> np.ndarray:
    """uint8 (B, ...) -> float32 [-1, 1], multi-threaded in C."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(src.shape, np.float32)
    items = src.shape[0]
    lib.normalize_u8(_ptr(src), _ptr(dst), items, src.size // max(items, 1), nthreads)
    return dst


class NativeFill50kBatcher:
    """Batch-level fill50k synthesis in C, in place of ``batch_iterator`` over
    ``Fill50kSynthetic``: indices drawn with replacement from ``seed`` (as the JAX
    batcher draws them), ``start_step`` batches skipped by replaying the draws only."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, nthreads: int = 8,
                 start_step: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.nthreads = nthreads
        self.start_step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from controllora_tpu_torch.data.fill50k import _COLORS

        rng = np.random.default_rng(self.seed)
        n = len(self.ds)
        for _ in range(self.start_step):
            rng.integers(0, n, self.batch_size)
        while True:
            idx = rng.integers(0, n, self.batch_size)
            specs = np.empty((self.batch_size, 9), np.float32)
            ids = np.empty((self.batch_size, 77), np.int32)
            for row, i in enumerate(idx):
                bg, fg, cx, cy, radius = self.ds._sample_spec(int(i))
                specs[row] = [cx, cy, radius, *_COLORS[bg], *_COLORS[fg]]
                ids[row] = self.ds.tokenizer([f"{fg} circle with {bg} background"])[0]
            pixels, guides = fill50k_batch_native(specs, self.ds.resolution, self.nthreads)
            yield {"pixel_values": pixels, "guide_values": guides, "input_ids": ids}


class NativeNormalizeBatcher:
    """``batch_iterator`` for datasets with ``getitem_u8`` (the column datasets):
    samples stay uint8 through decode and crop, and each batch's conversion to
    [-1, 1] is one threaded C call a tensor. Index order, epochs and the
    ``start_step`` fast-forward are ``batch_iterator``'s (the same draws)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, start_step: int = 0, nthreads: int = 8):
        if not hasattr(dataset, "getitem_u8"):
            raise TypeError("NativeNormalizeBatcher needs a dataset with getitem_u8")
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.start_step = start_step
        self.nthreads = nthreads

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = len(self.ds)
        bs = self.batch_size
        skip = self.start_step
        while True:
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for s in range(0, n - (bs - 1 if self.drop_last else 0), bs):
                if skip > 0:
                    skip -= 1
                    continue
                items = [self.ds.getitem_u8(int(i)) for i in order[s:s + bs]]
                pix = np.stack([it["pixel_values_u8"] for it in items])
                gui = np.stack([it["guide_values_u8"] for it in items])
                yield {"pixel_values": normalize_u8_native(pix, self.nthreads),
                       "guide_values": normalize_u8_native(gui, self.nthreads),
                       "input_ids": np.stack([it["input_ids"] for it in items])}


class Prefetcher:
    """A background thread that keeps up to ``depth`` items of ``iterator`` ready,
    in order. An exception in the producer is raised by the next ``next``. The
    consumer's wait for an item is span ``data.wait`` (``utils/spans.py``)."""

    def __init__(self, iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = iterator
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except Exception as e:  # handed to the consumer
            self._q.put(e)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        with spans.span("data.wait"):
            item = self._q.get()
        if item is self._done:
            self._q.put(self._done)
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
