"""device_idle_pct.open: as ``device_idle_pct.serve``, in an open-loop cell, where the
device also idles between arrivals, %."""

from benchmark import readers


def read(run):
    return readers.idle(run) if run.kind == "serve" else None
