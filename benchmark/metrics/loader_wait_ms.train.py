"""loader_wait_ms.train: the mean time a step waited for its batch inside the data
plane's prefetch queue (the program's ``data.wait`` spans, over the traced steps), ms."""

from benchmark import host_spans


def read(run):
    return host_spans.span_mean_ms(run, "train", "data.wait")
