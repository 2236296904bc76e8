"""Open-loop guided serving at a rate fixed in the cell: request k is due at k / ``rate``
seconds after the window opens, whatever the program is doing, and is submitted to the
program's ``BatchingEngine`` then; its latency runs from when it was due to its image.

Traffic keys: those of ``serve_closed`` (without ``clients``) and ``rate`` (requests a
second). Arrivals are evenly spaced, the same for every seed; the seed draws what each
request asks for (guide, prompt, latent seed), as in ``serve_closed``. The window holds
the requests due in its ``--seconds``; the run waits for the last of them to finish.
Set-up warms every bucket the engine may form, with a render of few steps each.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List

from benchmark.drivers import serve_closed
from benchmark.reference import fill50k

KIND = "serve"


class Session(serve_closed.Session):
    def warm_up(self) -> None:
        """A render at each bucket: batches of any size up to the largest may form."""
        for size in self.engine.buckets:
            futs = [self.engine.submit(fill50k.caption(self.items[i]), guide=self.guides[i],
                                       seed=i, num_inference_steps=int(self.t["warmup_steps"]),
                                       guidance_scale=float(self.t["guidance_scale"]),
                                       height=self.res, width=self.res)
                    for i in range(size)]
            for f in futs:
                f.result(timeout=1200)

    def measure(self, seconds: float, tracer=None) -> dict:
        rate = float(self.t["rate"])
        count = int(rate * seconds)
        stats0 = dict(self.engine.stats, batch_sizes=dict(self.engine.stats["batch_sizes"]))
        launches0 = dict(self.fa.LAUNCHES)
        futures = []
        traced: Dict[str, object] = {}
        trace_s = float(self.t["trace_seconds"])
        stop_trace = threading.Event()

        def record(k, spec, due, submitted, fut):
            t_done = time.monotonic()
            rec = dict(spec, k=k, submit=due, submitted=submitted, done=t_done,
                       batch=self.engine.stats["batches"], ok=fut.exception() is None)
            if rec["ok"]:
                rec["image"] = fut.result()
            with self.lock:
                self.done[k] = rec
            if tracer is not None and "stop_at" not in traced and t_done - t0 >= trace_s:
                traced["stop_at"] = rec["batch"]
                stop_trace.set()

        if tracer is not None:
            tracer.start()
        t0 = time.monotonic()
        for k in range(count):
            due = t0 + k / rate
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            if tracer is not None and tracer.running and stop_trace.is_set():
                paused = time.monotonic()
                traced["trace"] = tracer.stop()
                # stopping the profiler holds the interpreter for seconds: the arrivals
                # resume on their schedule after it, not in a burst
                t0 += time.monotonic() - paused
                due = t0 + k / rate
            spec = self.request(k)
            submitted = time.monotonic()
            fut = self.engine.submit(spec["prompt"], guide=self.guides[spec["guide"]],
                                     seed=spec["seed"], height=self.res, width=self.res,
                                     num_inference_steps=int(self.t["steps"]),
                                     guidance_scale=float(self.t["guidance_scale"]))
            fut.add_done_callback(lambda f, k=k, spec=spec, due=due, submitted=submitted:
                                  record(k, spec, due, submitted, f))
            futures.append(fut)
        for fut in futures:
            try:
                fut.result(timeout=900)
            except Exception:  # counted as failed by its record
                pass
        if tracer is not None and tracer.running:
            stop_trace.wait(timeout=900)
            traced["trace"] = tracer.stop()
        with self.lock:
            recs = list(self.done.values())
        ok = [r for r in recs if r["ok"]]
        if tracer is not None:
            traced["sizes"] = serve_closed.batch_sizes(recs, traced["stop_at"])
        return dict(kind=KIND, seconds=seconds, images=len(ok), attempted=len(recs),
                    failed=len(recs) - len(ok),
                    latencies=sorted(r["done"] - r["submit"] for r in ok),
                    late_s=max(r["submitted"] - r["submit"] for r in recs),
                    batches=len({r["batch"] for r in recs}), traced=traced or None,
                    launches={k: self.fa.LAUNCHES[k] - launches0[k] for k in launches0},
                    engine=serve_closed._delta(stats0, self.engine.stats),
                    units=len({r["batch"] for r in recs}), in_window=[r["k"] for r in ok])

    def end_to_end(self, w: dict) -> Dict[str, float]:
        return {"serve_latency_p90_s": statistics.quantiles(w["latencies"], n=10,
                                                            method="inclusive")[-1]}

    def notes(self, w: dict) -> List[str]:
        first, second = (lat_of(w, self.done, half) for half in (0, 1))
        recs = self.done.values()
        span = max(r["done"] for r in recs) - min(r["submit"] for r in recs)
        return super().notes(w) + [
            f"offered {self.t['rate']} requests/s, completed {w['images'] / span:.4f} img/s; "
            f"generator at most {w['late_s']:.4f} s late; p90 of the first and second half "
            f"of the arrivals {first:.4f}, {second:.4f} s (a growing queue shows here)"]


def lat_of(w: dict, done: Dict[int, dict], half: int) -> float:
    """The 90th percentile latency of the first (0) or second (1) half of the arrivals."""
    ks = sorted(k for k in w["in_window"])
    part = ks[: len(ks) // 2] if half == 0 else ks[len(ks) // 2:]
    lat = [done[k]["done"] - done[k]["submit"] for k in part]
    return statistics.quantiles(lat, n=10, method="inclusive")[-1] if len(lat) > 1 else 0.0

