"""idle_in_steps_pct.serve: device idle time inside the pipeline's sampling loop (the
program's ``pipeline.step`` spans: a CFG UNet eval, guidance and the scheduler update
each), % of the traced window: the host dispatching slower than the card runs."""

from benchmark import host_spans


def read(run):
    return host_spans.idle_in(run, "serve", ["pipeline.step"])
