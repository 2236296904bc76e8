"""What a run is asked to do, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``, whose ``kind`` names a
driver ``drivers/<kind>.py``) and the readers of its per-layer metrics
(``metrics/<name>.py``). Nothing here lists them: a new file is found by its name."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric belongs to a cell: listed there, or (no list) a per-layer
    metric of every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: str = ".", bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; configuration files are paths
    relative to ``root``, traffic mixes ``<bench_dir>/traffic/<traffic>.json``."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, int(cell["chips"]), e2e, per_layer)


def driver(kind: str, bench_dir: str = HERE) -> ModuleType:
    """The driver module of a traffic kind: ``drivers/<kind>.py``."""
    return _module(os.path.join(bench_dir, "drivers", kind + ".py"), f"drivers.{kind}")


def metric_reader(name: str, bench_dir: str = HERE) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py``, with a ``read(run)``
    that returns the value, or None where the run gave it nothing to read."""
    return _module(os.path.join(bench_dir, "metrics", name + ".py"), f"metrics.{name}")


def _module(path: str, key: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(
        "benchmark_found_" + key.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
