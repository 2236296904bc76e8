"""Idle device time traced to what the host was doing: the program's host spans
(``controllora_tpu_torch/utils/spans.py``, recorded while the profiler records, stamped
on its clock: Unix-epoch ns) against the traced window's device operations.

The idle intervals are the gaps between consecutive merged device intervals
(``trace.union``). Idle time attributed to a set of span names is the measure of the
idle intervals inside the union of those spans' intervals (nested or overlapping spans
count once), over the traced window's length (the base of ``device_idle_pct.*``), %.

A run with no device operations or no matching spans gives None: a CPU run, a
``--trace 0`` run, or a program that records no spans.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from benchmark.trace import union

Interval = Tuple[float, float]  # (start s, end s) on the profiler's clock


def program_spans() -> list:
    """The spans the program recorded, or none where it records none."""
    try:
        from controllora_tpu_torch.utils import spans
    except ImportError:
        return []
    return spans.recorded()


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        start, end = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if start < end:
            out.append((start, end))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """``a`` without ``b`` (both sorted and disjoint)."""
    out = []
    for start, end in a:
        for cut_start, cut_end in b:
            if cut_end <= start or cut_start >= end:
                continue
            if cut_start > start:
                out.append((start, cut_start))
            start = max(start, cut_end)
            if start >= end:
                break
        if start < end:
            out.append((start, end))
    return out


def measure(intervals: List[Interval]) -> float:
    return sum(end - start for start, end in intervals)


def idle_intervals(ops) -> List[Interval]:
    """The gaps between consecutive merged device intervals."""
    busy = union(ops)
    return [(end, start) for (_, end, _), (start, _, _) in zip(busy, busy[1:])]


def covered(spans, names: Sequence[str]) -> List[Interval]:
    """The union of the intervals of the spans named ``names``, in seconds."""
    return merge((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans if s.name in names)


def idle_share(trace, spans, names: Sequence[str], minus: Sequence[str] = ()) -> Optional[float]:
    """Idle time inside the spans ``names`` (and outside the spans ``minus``), % of the
    traced window; None without device operations or without such spans."""
    inside = covered(spans, names)
    if not trace.ops or not inside:
        return None
    if minus:
        inside = subtract(inside, covered(spans, minus))
    return 100.0 * measure(intersect(idle_intervals(trace.ops), inside)) / trace.window_s


def mean_ms(spans, name: str) -> Optional[float]:
    """The mean length of the spans ``name``, ms; None without any."""
    lengths = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(lengths) / len(lengths) * 1e-6 if lengths else None


def idle_in(run, kind: str, names: Sequence[str], minus: Sequence[str] = ()) -> Optional[float]:
    """``idle_share`` of a traced run of ``kind`` over the spans the program recorded."""
    if run.kind != kind or not run.traced:
        return None
    return idle_share(run.traced["trace"], program_spans(), names, minus)


def span_mean_ms(run, kind: str, name: str) -> Optional[float]:
    """``mean_ms`` of a traced run of ``kind`` over the spans the program recorded."""
    if run.kind != kind or not run.traced or not run.traced["trace"].ops:
        return None
    return mean_ms(program_spans(), name)
