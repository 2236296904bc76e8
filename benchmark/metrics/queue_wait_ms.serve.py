"""queue_wait_ms.serve: the mean time a request waited in the serving engine's queue,
from ``submit`` to the start of its batch's pipeline call (the program's
``engine.queue`` spans, one a request, over the traced part of the window), ms."""

from benchmark import host_spans


def read(run):
    return host_spans.span_mean_ms(run, "serve", "engine.queue")
