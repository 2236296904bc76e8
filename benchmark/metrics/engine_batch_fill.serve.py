"""engine_batch_fill.serve: requests the serving engine rendered over the slots its
batches took (each batch padded up to its bucket), from the engine's own counters
(``BatchingEngine.stats``) over the run's window and the requests in flight at its
end, %."""

from benchmark import readers


def read(run):
    return readers.batch_fill(run) if run.kind == "serve" else None
