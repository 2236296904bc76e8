"""idle_in_data_pct.train: device idle time while the host waited for a batch or
uploaded it (the program's ``data.wait`` and ``train.upload`` spans), % of the traced
window."""

from benchmark import host_spans


def read(run):
    return host_spans.idle_in(run, "train", ["data.wait", "train.upload"])
