"""Host spans on the profiler's clock: what the host was doing while the device ran.

A span is (name, start_ns, end_ns, span_id, parent_id, thread_id, attrs), stamped with
``time.time_ns()``: the Unix-epoch nanoseconds in which ``torch.profiler`` reports its
device events, so a span and a kernel of one trace share one time axis. The parent is
the innermost span the same thread has open.

Spans record exactly while a ``torch.profiler`` session records, whatever its
activities (``torch.autograd.profiler._is_profiler_enabled``, a process-wide flag the
profiler sets on start and clears on stop, read at every call). Otherwise ``span()``
returns one shared null context and ``record`` returns at once: a site costs one
attribute read. Spans are kept in memory, in a buffer of at most ``CAP`` (the oldest
go first); ``recorded()`` copies it out, ``chrome_trace`` writes it as Chrome trace
events beside the profiler's own trace.

    with spans.span("pipeline.step", index=i):
        ...
    spans.record("engine.queue", called_ns - wait_ns, called_ns)
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAP = 1_000_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    attrs: Dict[str, Any]


_buffer: "collections.deque[tuple]" = collections.deque(maxlen=CAP)  # Span fields
_ids = itertools.count(1)
_local = threading.local()


def _thread() -> threading.local:
    """The calling thread's state: its stack of open span ids and its native id."""
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.tid = threading.get_native_id()
    return _local


class _Null:
    """What ``span()`` returns while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    __slots__ = ("name", "attrs", "start_ns", "span_id", "parent_id", "thread")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.thread = t = _thread()
        self.parent_id = t.stack[-1] if t.stack else None
        self.span_id = next(_ids)
        t.stack.append(self.span_id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        t = self.thread
        t.stack.pop()
        _buffer.append((self.name, self.start_ns, end, self.span_id, self.parent_id, t.tid,
                        self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager timing its block as span ``name``."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, attrs)


def traced(name: str):
    """Decorator: each call of the function is span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def record(name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
           **attrs) -> None:
    """A span whose start was stamped earlier (a request's wait in the queue); its
    parent is ``parent`` or else the innermost span the calling thread has open."""
    if not _profiler._is_profiler_enabled:
        return
    t = _thread()
    if parent is None and t.stack:
        parent = t.stack[-1]
    _buffer.append((name, int(start_ns), int(end_ns), next(_ids), parent, t.tid, attrs))


def recorded() -> List[Span]:
    """A copy of the spans kept, in the order they ended."""
    return [Span._make(fields) for fields in list(_buffer)]


def clear() -> None:
    _buffer.clear()


def chrome_trace(path: str, kept: List[Span]) -> None:
    """Write ``kept`` as Chrome trace events ("ph": "X", microseconds since the Unix
    epoch, ``tid`` the native thread id), to lay over the profiler's trace."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.thread_id,
               "args": dict(s.attrs, span_id=s.span_id, parent_id=s.parent_id)}
              for s in kept]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f, default=str)
