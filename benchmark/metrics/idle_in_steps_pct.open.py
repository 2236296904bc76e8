"""idle_in_steps_pct.open: as ``idle_in_steps_pct.serve``, in an open-loop cell, %."""

from benchmark import host_spans


def read(run):
    return host_spans.idle_in(run, "serve", ["pipeline.step"])
