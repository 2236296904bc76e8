"""The host spans' clock against the profiler's device clock, on the card: a span and a
kernel of one trace lie on one time axis (``controllora_tpu_torch/utils/spans.py``
stamps ``time.time_ns()``; the profiler reports device events in Unix-epoch ns).

These need an NVIDIA GPU; elsewhere they skip. On the card (``-s`` prints the offsets):
    python -m pytest tests/test_torch_spans_gpu.py --noconftest -m gpu -q -s

The profiler's mapping of device timestamps onto the host clock can drift within a
session: on the H100 device events slid later against the host by 0.2-1 ms over a
session's first 0.6 s in some sessions and not in others. Such a session fails these
probes, and the wait probe shows it is the mapping: kernel B then reads as starting
before the host span that precedes its launch has ended, while the device gap holds.
"""

from __future__ import annotations

import time

import pytest
import torch

from controllora_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu
ROUNDS = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler's device clock)")
    torch.ones(1, device="cuda").add_(1)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    spans.clear()
    yield torch.device("cuda")
    spans.clear()


def traced(work, cpu=False):
    """(device ops as (start ns, end ns) in time order, runtime cudaDeviceSynchronize
    calls likewise, spans) of ``work`` in one profiling session, as long as a traced
    benchmark window's part: CUDA activity only (the benchmark's), or with the host's."""
    from torch.profiler import ProfilerActivity, profile

    spans.clear()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        work()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                 if e.device_type() == cuda)
    syncs = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "cudaDeviceSynchronize")
    return ops, syncs, spans.recorded()


def nearest(intervals, t):
    """The interval whose end lies nearest ``t``."""
    return min(intervals, key=lambda iv: abs(iv[1] - t))


def median(values):
    return sorted(values)[len(values) // 2]


def test_a_cuda_only_profiler_turns_spans_on(cuda):
    from torch.profiler import ProfilerActivity, profile

    assert spans.span("x") is spans._NULL
    with profile(activities=[ProfilerActivity.CUDA]):
        assert spans.span("x") is not spans._NULL
    assert spans.span("x") is spans._NULL


def test_span_clock_is_the_profilers_host_clock(cuda):
    """A span around ``synchronize()`` holds the runtime's own cudaDeviceSynchronize
    event of the same trace, ending after it: within 0.1 ms (the median of the rounds)
    and 0.5 ms (every round)."""
    def work():
        for _ in range(ROUNDS):
            torch.cuda._sleep(2_000_000)
            with spans.span("probe.sync"):
                torch.cuda.synchronize()
            time.sleep(0.005)

    _, syncs, got = traced(work, cpu=True)
    assert len(got) == ROUNDS and syncs
    ends = [s.end_ns - nearest(syncs, s.end_ns)[1] for s in got]
    starts = [nearest(syncs, s.end_ns)[0] - s.start_ns for s in got]
    print(f"span end - runtime sync end, us: {[round(x / 1e3, 1) for x in ends]}; "
          f"runtime sync start - span start, us: {[round(x / 1e3, 1) for x in starts]}")
    assert 0 <= median(ends) <= 100_000, (ends, starts)
    assert all(0 <= e <= 500_000 for e in ends) and all(s >= 0 for s in starts), (ends, starts)


def sync_lags(work, warm=1):
    """span end - the end of the nearest kernel of 10 ms or more, ns, for each span of
    ``work`` after the first ``warm`` (a fresh session's first round returns late)."""
    ops, _, got = traced(work)
    kernels = [op for op in ops if op[1] - op[0] >= 10_000_000]
    assert got and kernels
    return len(got), [s.end_ns - nearest(kernels, s.end_ns)[1] for s in got[warm:]]


def test_span_around_synchronize_ends_with_a_long_kernel(cuda):
    """A span around ``synchronize()`` after a kernel of 10 ms or more ends no earlier
    than the kernel's end in the trace and no more than 0.5 ms after it, in every round
    after the first. The card idles 0.2 s between rounds."""
    def work():
        for _ in range(ROUNDS):
            torch.cuda._sleep(40_000_000)
            with spans.span("probe.sync"):
                torch.cuda.synchronize()
            time.sleep(0.2)

    n, lags = sync_lags(work)
    print(f"span end - kernel end, us: {[round(x / 1e3, 1) for x in lags]}")
    assert n == ROUNDS and all(0 <= lag <= 500_000 for lag in lags), lags


def test_span_around_synchronize_on_a_busy_card(cuda):
    """The same bound with the card kept busy, as in a traced window: 20 ms kernels back
    to back for 2 s, the host launching the next at once after each ``synchronize()``."""
    def work():
        until = time.perf_counter() + 2.0
        while time.perf_counter() < until:
            torch.cuda._sleep(40_000_000)
            with spans.span("probe.sync"):
                torch.cuda.synchronize()

    n, lags = sync_lags(work)
    print(f"span end - kernel end, us, every 5th of {n}: "
          f"{[round(x / 1e3, 1) for x in lags[::5]]}; max {max(lags) / 1e3:.1f}")
    assert n >= 50 and all(0 <= lag <= 500_000 for lag in lags), lags


def test_span_around_a_wait_lies_in_the_device_gap(cuda):
    """A span around a 20 ms host wait between two short kernels, the queue drained
    before it, lies inside the device gap between them, which reads 20 +- 1 ms, in every
    round after the first. The host spins for the 20 ms, since ``time.sleep`` overslept
    by up to 1 ms; both kernels run once before the session (a first launch loads its
    module)."""
    x = torch.ones(1 << 16, device=cuda)
    x.add_(1)
    x.mul_(0.5)  # a kernel's first launch loads its module
    torch.cuda.synchronize()

    def work():
        for _ in range(ROUNDS):
            x.add_(1)
            torch.cuda.synchronize()
            with spans.span("probe.wait"):
                until = time.perf_counter() + 0.02
                while time.perf_counter() < until:
                    pass
            x.mul_(0.5)
            torch.cuda.synchronize()
            time.sleep(0.01)

    ops, _, got = traced(work)
    rows = []
    for s in got[1:]:  # the first round warms the session
        a_end = max(op[1] for op in ops if op[1] <= s.start_ns + 5_000_000)
        b_start = min(op[0] for op in ops if op[0] >= s.end_ns - 5_000_000)
        rows.append((s.start_ns - a_end, b_start - s.end_ns, b_start - a_end))
    print("kernel A end -> span start, span end -> kernel B start, gap, us: "
          f"{[tuple(round(v / 1e3, 1) for v in r) for r in rows]}")
    assert all(abs(g - 20_000_000) <= 1_000_000 for _, _, g in rows), rows
    # a negative edge is a kernel placed before the host work that precedes it
    assert all(b >= 0 and a >= 0 for b, a, _ in rows), ("device mapping drifted", rows)
