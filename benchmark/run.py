"""Runs one cell of the benchmark once and prints its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. The cell's traffic kind
names its driver (``drivers/<kind>.py``), which builds the system under test
(``controllora_tpu_torch``) from the cell's configuration and the seed, warms up the
shapes the traffic uses, and measures for ``--seconds``. ``--trace 0`` reports the
end-to-end metrics; ``--trace 1`` traces part of the window with the profiler and
reports the per-layer metrics (each read by ``metrics/<name>.py``). After the window
the system is freed and the plain reference checks what it produced: each number
compared is printed with its limit, as the last lines of standard error and as the
``checks`` key that ends the result line.

Exits non-zero, with no result, without a CUDA device or with fewer than the cell
asks for, and when JAX or the JAX package is loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "controllora_tpu")


def process_age() -> float:
    """Seconds since this process started (its start time in /proc, 10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


_T0 = time.monotonic() - process_age()


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def reader_run(session, window: dict):
    """What a per-layer metric reader sees."""
    from types import SimpleNamespace

    return SimpleNamespace(kind=window["kind"], window=window, traced=window.get("traced"),
                           session=session)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, log=print) -> dict:
    """Set-up, window, metrics and check of one run; returns the result object."""
    import torch

    from benchmark import spec
    from benchmark.trace import Tracer

    on_card = torch.device(device).type == "cuda"
    session = spec.driver(cell.traffic["kind"]).Session(cell, seed, device)
    t_call = time.monotonic()
    session.setup()
    setup_s = time.monotonic() - _T0
    log(f"set-up {setup_s:.3f} s, of which {t_call - _T0:.3f} s before the driver's set-up")
    setup_peak = peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    window = session.measure(seconds, Tracer() if trace else None)
    if on_card:
        peak = torch.cuda.max_memory_allocated()
    for line in session.notes(window):
        log(line)
    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if on_card else torch.device(device).type,
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": max(peak, setup_peak)}
    if not trace:
        values = dict(session.end_to_end(window), peak_mem_gib=peak / 2**30, setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": values[name], "unit": unit} for name, unit in units.items()
                   if name in values}
    else:
        run = reader_run(session, window)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = window["traced"]["trace"]
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
    session.release()
    t_check = time.monotonic()
    checks = session.check(window)
    log(f"check by the reference: {time.monotonic() - t_check:.3f} s")
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.pop("CONTROLLORA_FLASH_IMPL", None)  # the cells run the default kernels

    def log(line):
        print(line, file=sys.stderr, flush=True)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, found {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log)
    loaded = forbidden_modules()
    if loaded:
        log(f"JAX or the JAX package is loaded in this process: {loaded}")
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
