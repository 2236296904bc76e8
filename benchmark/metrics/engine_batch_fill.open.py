"""engine_batch_fill.open: as ``engine_batch_fill.serve``, in an open-loop cell, where
batches form from the requests queued at the time and the buckets pad them, %."""

from benchmark import readers


def read(run):
    return readers.batch_fill(run) if run.kind == "serve" else None
