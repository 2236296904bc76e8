"""CPU tests of the readers that trace idle device time to the program's host spans
(``benchmark/host_spans.py`` and the metrics that use it): the interval arithmetic on
synthetic device operations and spans with exact expected shares, and None from every
new reader where a run has no device operations or no spans.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from benchmark import host_spans, spec
from benchmark.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S = 1_000_000_000  # ns a second

NEW = {  # reader -> the kind of run it reads
    "queue_wait_ms.serve": "serve", "queue_wait_ms.open": "serve",
    "idle_in_steps_pct.serve": "serve", "idle_in_steps_pct.open": "serve",
    "idle_in_edges_pct.serve": "serve", "loader_wait_ms.train": "train",
    "idle_in_data_pct.train": "train", "idle_in_compute_pct.train": "train",
}


def sp(name, start_s, end_s):
    return SimpleNamespace(name=name, start_ns=round(start_s * S), end_ns=round(end_s * S))


# device busy [0, 1), [2, 3), [3.5, 4), [6, 7): idle gaps (1, 2), (3, 3.5), (4, 6)
OPS = [("k0", 0.0, 1.0), ("k1", 2.0, 0.5), ("k2", 2.25, 0.75), ("k3", 3.5, 0.5),
       ("k4", 6.0, 1.0)]
TRACE = Trace(window_s=10.0, ops=OPS)


def test_idle_intervals_are_the_gaps_between_merged_device_intervals():
    assert host_spans.idle_intervals(OPS) == [(1.0, 2.0), (3.0, 3.5), (4.0, 6.0)]


@pytest.mark.parametrize("spans,names,minus,share", [
    # a gap wholly inside a span
    ([sp("a", 0.5, 2.5)], ["a"], [], 10.0),
    # a span inside a gap
    ([sp("a", 4.5, 5.0)], ["a"], [], 5.0),
    # a span across two gaps and the busy interval between them
    ([sp("a", 1.5, 3.25)], ["a"], [], 7.5),
    # outside every gap: in a busy interval, before the first op, after the last
    ([sp("a", 2.1, 2.9), sp("a", -1.0, 0.0), sp("a", 7.0, 9.0)], ["a"], [], 0.0),
    # nested and overlapping spans count once
    ([sp("a", 4.0, 6.0), sp("b", 4.5, 5.5), sp("a", 5.0, 5.2)], ["a", "b"], [], 20.0),
    # spans of other names are not counted
    ([sp("a", 1.0, 2.0), sp("b", 4.0, 6.0)], ["a"], [], 10.0),
    # a call less its steps: the gap (4, 6) less a step over (4.5, 5)
    ([sp("call", 0.0, 7.0), sp("step", 4.5, 5.0), sp("step", 1.0, 2.0)], ["call"],
     ["step"], 20.0),
])
def test_attribution_shares(spans, names, minus, share):
    assert host_spans.idle_share(TRACE, spans, names, minus) == pytest.approx(share,
                                                                             abs=1e-9)


def test_attributed_shares_add_up_to_no_more_than_the_idle():
    spans = [sp("call", 0.5, 6.5), sp("step", 1.5, 3.2), sp("step", 4.0, 5.0)]
    steps = host_spans.idle_share(TRACE, spans, ["step"])
    edges = host_spans.idle_share(TRACE, spans, ["call"], ["step"])
    idle = 100.0 * (1.0 - TRACE.busy_s / TRACE.window_s)
    assert steps == pytest.approx(17.0) and edges == pytest.approx(18.0)
    assert steps + edges <= idle


def test_no_ops_or_no_spans_give_none():
    assert host_spans.idle_share(Trace(5.0, []), [sp("a", 0, 1)], ["a"]) is None
    assert host_spans.idle_share(TRACE, [sp("b", 0, 1)], ["a"]) is None
    assert host_spans.mean_ms([sp("b", 0, 1)], "a") is None
    assert host_spans.mean_ms([sp("a", 0, 0.002), sp("a", 1, 1.004)], "a") == \
        pytest.approx(3.0)


def run(kind, traced=True, ops=OPS):
    return SimpleNamespace(kind=kind, window={}, session=None,
                           traced={"trace": Trace(10.0, list(ops))} if traced else None)


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_new_reader_gives_none_without_ops_or_spans(monkeypatch, name):
    read = spec.metric_reader(name).read
    every = [sp(n, 0.0, 7.0) for n in ("engine.queue", "pipeline.call", "pipeline.step",
                                       "data.wait", "train.upload", "train.forward",
                                       "train.backward", "train.optimizer")]
    monkeypatch.setattr(host_spans, "program_spans", lambda: every)
    kind = NEW[name]
    assert read(run(kind, traced=False)) is None
    assert read(run(kind, ops=[])) is None
    assert read(run("train" if kind == "serve" else "serve")) is None
    value = read(run(kind))
    assert value is not None and value >= 0.0
    monkeypatch.setattr(host_spans, "program_spans", lambda: [])
    assert read(run(kind)) is None


def test_every_new_reader_is_a_listed_per_layer_metric():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name, kind in NEW.items():
        m = per_layer[name]
        assert m["workloads"] and m["better"] == "lower"
        assert m["moves"] == {"train": "train_step_ms", "serve": (
            "serve_latency_p90_s" if name.endswith(".open") else "serve_img_per_s")}[kind]


def test_program_spans_reads_the_recorder(monkeypatch):
    import sys

    import torch.autograd.profiler as autograd_profiler

    from controllora_tpu_torch.utils import spans

    spans.clear()
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    with spans.span("pipeline.step"):
        pass
    assert [s.name for s in host_spans.program_spans()] == ["pipeline.step"]
    spans.clear()
    # a program without the recorder (an older checkout): no spans, no error
    monkeypatch.setitem(sys.modules, "controllora_tpu_torch.utils.spans", None)
    monkeypatch.delattr("controllora_tpu_torch.utils.spans")
    assert host_spans.program_spans() == []
