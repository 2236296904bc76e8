"""idle_in_edges_pct.serve: device idle time inside a pipeline call but outside its
sampling loop (``pipeline.call`` less ``pipeline.step``: arguments and uploads, text
encode, hint encoder and fold, VAE decode and the copy to the host), % of the traced
window."""

from benchmark import host_spans


def read(run):
    return host_spans.idle_in(run, "serve", ["pipeline.call"], minus=["pipeline.step"])
