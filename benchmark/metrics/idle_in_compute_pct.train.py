"""idle_in_compute_pct.train: device idle time while the host dispatched the step's
work (the program's ``train.forward``, ``train.backward`` and ``train.optimizer``
spans), % of the traced window."""

from benchmark import host_spans


def read(run):
    return host_spans.idle_in(run, "train", ["train.forward", "train.backward",
                                             "train.optimizer"])
