"""data_wait_ms.train: host milliseconds a step waited on the next batch of the data
stream (``next()`` of the CLI's prefetching fill50k stream), the mean over the
window's steps, timed by the harness around the call."""


def read(run):
    waits = run.window.get("data_wait_s") if run.kind == "train" else None
    return 1000.0 * sum(waits) / len(waits) if waits else None
