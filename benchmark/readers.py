"""Arithmetic the per-layer metric readers share: each reads the traced part of a
window (``run.traced``: the device trace and the units of work done in it) and the
cell's work model (``run.session``: FLOPs of a unit, the flash kernels' sites)."""

from __future__ import annotations

from typing import Optional

from benchmark import work

# the port's hand-written kernels (controllora_tpu_torch/csrc/*.cu), by kernel name
FLASH_KERNELS = ("flash_", "bias_add", "combine_splits")


def bucket(n: int, buckets) -> int:
    return next(b for b in sorted(buckets) if b >= n)


def units(run):
    """The traced units: (images of each batch) when serving, else steps."""
    return run.traced["sizes"] if run.kind == "serve" else [None] * run.traced["steps"]


def mfu(run) -> Optional[float]:
    """Model FLOPs of the traced units over the traced window, % of the bf16 peak."""
    if not run.traced:
        return None
    flops, per = 0.0, {}
    for n in units(run):
        if n not in per:
            per[n] = run.session.unit_flops(n)
        flops += per[n]
    return 100.0 * flops / run.traced["trace"].window_s / work.PEAK_BF16_FLOPS


def flash_roofline(run) -> Optional[float]:
    """Least time of the attention work the flash kernels were sent (at the rows each
    call ran, padding included) over their traced device time, %."""
    if not run.traced:
        return None
    kernel_s = run.traced["trace"].time_of(lambda name: any(k in name for k in FLASH_KERNELS))
    if kernel_s <= 0:
        return None
    buckets = run.session.t.get("buckets")
    least = sum(site.least_s for n in units(run)
                for site in run.session.sites(bucket(n, buckets) if n else None))
    return 100.0 * least / kernel_s


def idle(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran, %."""
    if not run.traced:
        return None
    tr = run.traced["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def batch_fill(run) -> Optional[float]:
    """Requests over the slots of the batches the engine formed, from its counters, %."""
    stats = run.window["engine"]
    slots = sum(int(b) * n for b, n in stats["batch_sizes"].items())
    return 100.0 * stats["requests"] / slots if slots else None
