"""The readings a cell's correctness limits are set from, on the card.

    python3 -m benchmark.control --workload <name> --program-seeds 1,2 --control-seeds 3,4

For each program seed: the system's reading of every number the cell compares, from
a short window at the cell's own load (serving) or from set-up's first steps
(training), in one process. For each control seed: the control's reading, the plain
reference in fp8 (``reference/numerics.py``) in the system's place, against the
float32 reference; for a training cell also the planted fault "half the batch left
out, the mean over the rest" (in the reference). One JSON line a reading. The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def serve_control(session, seed: int) -> dict:
    """The fp8 reference against the float32 reference on as many requests as a run's
    check renders: the first of a run, one whole batch as the window forms it for each
    of ``check_batches``."""
    from benchmark.drivers.serve_closed import image_gap, request_plan
    from benchmark.reference import fill50k

    t = session.t
    session.items, session.latent_seed = request_plan(seed, int(t["guide_pool"]), session.res)
    session.guides = [fill50k.draw(it, session.res)[1] for it in session.items]
    per_batch = min(int(t.get("clients", max(t["buckets"]))), max(t["buckets"]))
    recs = [session.request(k) for k in range(int(t["check_batches"]) * per_batch)]
    want = session.reference_images(recs, "float32")
    got = session.reference_images(recs, "fp8")
    return {"control": "fp8", "image_rel_l2": image_gap(got, want)}


def train_controls(session, seed: int):
    from benchmark.drivers import train_cli

    cfg, t, dev = session.cell.config, session.t, session.device
    stream, step = train_cli.seeds(seed)
    want = train_cli.reference_steps(cfg, t, seed, dev, stream, step, "float32")
    for name, kw in (("fp8", dict(precision="fp8")), ("half_batch", dict(fault="half_batch"))):
        got = train_cli.reference_steps(cfg, t, seed, dev, stream, step, **kw)
        yield dict({"control": name}, **train_cli.gaps(got, want))


def program_train_readings(session) -> dict:
    """Every number of ``train_cli.gaps``, the compared and the others, and where the
    worst leaf's change gap comes from."""
    from benchmark.drivers import train_cli

    want = train_cli.reference_steps(session.cell.config, session.t, session.seed,
                                     session.device, session.stream_seed, session.step_seed)
    got = {"losses": session.losses, "g1": session.g1, "p0": session.p0,
           "p_end": session.p_end}
    readings = train_cli.gaps(got, want)
    return dict(readings, worst=train_cli.worst_change_leaf(got, want,
                                                            readings["change_worst_leaf"]))


def main(argv=None) -> int:
    from benchmark import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    driver = spec.driver(cell.traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=cell.name))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds(args.program_seeds):
        session = driver.Session(cell, seed, "cuda")
        session.setup()
        window = session.measure(args.seconds) if driver.KIND == "serve" else None
        session.release()
        if driver.KIND == "serve":
            readings = {k: v for k, (v, _) in session.check(window).items()}
        else:
            readings = program_train_readings(session)
        emit(dict({"seed": seed, "side": "program"}, **readings))
        del session
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        session = driver.Session(cell, seed, "cuda")
        readings = [serve_control(session, seed)] if driver.KIND == "serve" \
            else train_controls(session, seed)
        for rec in readings:
            emit(dict({"seed": seed, "side": "control"}, **rec))
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
