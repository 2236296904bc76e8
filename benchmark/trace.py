"""The device trace of a traced run: ``torch.profiler`` with CUDA activity only (the
host's operator events cost tens of seconds to gather over a long window), started and
stopped by a driver at boundaries of its own work. The summary keeps each device
operation (kernel, copy, set) with its start and length; busy time is the measure of
their union."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

Op = Tuple[str, float, float]  # (name, start s, duration s) on the device clock


def _ops(prof) -> List[Op]:
    """Device operations of a finished profile, from the profiler's raw events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((e.name(), start, dur))
    out.sort(key=lambda op: op[1])
    return out


def union(ops: List[Op]) -> List[Tuple[float, float, str]]:
    """The busy intervals (start, end, name of the op that opened each), merged."""
    merged: List[list] = []
    for name, start, dur in sorted(ops, key=lambda op: op[1]):
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end, name])
    return [tuple(m) for m in merged]


@dataclass
class Trace:
    """A traced window: its host length and the device operations in it."""

    window_s: float
    ops: List[Op] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end, _ in union(self.ops))

    def time_of(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose name ``match`` accepts."""
        return sum(dur for name, _, dur in self.ops if match(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps summed by the
        operation that ended each, the longest first."""
        by_name: dict = {}
        for name, _, dur in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        gaps: dict = {}
        intervals = union(self.ops)
        for (_, end, _), (start, _, name) in zip(intervals, intervals[1:]):
            label = "before " + name[:120]
            gaps[label] = gaps.get(label, 0.0) + (start - end)
        rank = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])
        return {"device_ops": rank(by_name)[:top], "idle_gaps": rank(gaps)[:top]}


class Tracer:
    """Starts and stops the profiler; ``stop`` returns the Trace of the window."""

    def __init__(self):
        self._prof = None
        self._t0: Optional[float] = None
        self.result: Optional[Trace] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None and self.result is None

    def stop(self) -> Trace:
        """Call when the device has finished the window's work."""
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.result = Trace(window, _ops(self._prof))
        self._prof = None
        return self.result
