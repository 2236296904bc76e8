"""queue_wait_ms.open: as ``queue_wait_ms.serve``, in an open-loop cell, where a request
due while a batch runs waits for it to end, ms."""

from benchmark import host_spans


def read(run):
    return host_spans.span_mean_ms(run, "serve", "engine.queue")
