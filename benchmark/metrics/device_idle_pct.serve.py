"""device_idle_pct.serve: the share of the traced window in which no operation ran on
the device (one minus the union of the profiler's device intervals), %."""

from benchmark import readers


def read(run):
    return readers.idle(run) if run.kind == "serve" else None
