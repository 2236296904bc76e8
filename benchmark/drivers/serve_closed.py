"""Closed-loop guided serving: ``clients`` threads each submit one request to the
program's ``serving/engine.py::BatchingEngine`` (over its
``StableDiffusionControlLoRAPipeline``) and submit the next when its image returns.

Traffic keys: ``clients``, ``buckets``, ``max_wait_ms`` (the engine's), ``resolution``,
``steps``, ``guidance_scale``, ``pipe_kwargs`` (a preset's pipeline arguments; {} is
``exact``), ``guide_pool`` (distinct fill50k guides, each request takes the next),
``warmup_steps`` (the set-up render at the batch the window forms), ``trace_seconds``
(the traced part of a traced run), ``check_batches`` (whole batches of the window whose
requests the reference renders again), ``check_batch`` (requests it renders together).

Request k of a run is fill50k item ``items[k % guide_pool]`` (its ring as the guide,
its caption as the prompt) with its own latent seed; the items and seeds come from
``--seed``. The window opens at the first batch completion and closes at the last one
within ``--seconds`` of it, so it holds whole batches and a stall in it counts in full.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import stack, work
from benchmark.reference import fill50k, numerics, text
from benchmark.reference import models as ref
from benchmark.reference import schedule

KIND = "serve"
NOTHING_COMPARED = 1e9  # the reading when the window finished no request


def request_plan(seed: int, pool: int, resolution: int):
    """(items, latent seeds(k)): the guide pool's fill50k items and each request's
    latent seed, from the run's seed."""
    rng = np.random.default_rng([int(seed), 1])
    items = [fill50k.spec(int(i), resolution) for i in rng.integers(0, fill50k.SIZE, pool)]
    base = int(rng.integers(0, 2**31))
    return items, (lambda k: (base + 7919 * k) % 2**31)


class Session:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.t = cell.traffic
        self.res = int(self.t["resolution"])
        self.done: Dict[int, dict] = {}  # request index -> record
        self.lock = threading.Lock()

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        started = time.monotonic()
        from controllora_tpu_torch.data.tokenizer import HashTokenizer
        from controllora_tpu_torch.ops import flash_attention
        from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
        from controllora_tpu_torch.serving import BatchingEngine

        self.fa = flash_attention
        unet, vae, text_enc, control = stack.program(self.cell.config, self.seed, self.device)
        self.pipe = StableDiffusionControlLoRAPipeline(unet, vae, text_enc, HashTokenizer(),
                                                       control, device=self.device)
        self.engine = BatchingEngine(self.pipe, max_wait_ms=float(self.t["max_wait_ms"]),
                                     buckets=tuple(self.t["buckets"]), device=self.device,
                                     pipe_kwargs=dict(self.t.get("pipe_kwargs", {})))
        self.built_at = time.monotonic()
        self.items, self.latent_seed = request_plan(self.seed, int(self.t["guide_pool"]),
                                                    self.res)
        self.guides = [fill50k.draw(it, self.res)[1] for it in self.items]
        self.warm_from = time.monotonic()
        self.warm_up()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_note = (f"set-up: program built in {self.built_at - started:.3f} s, "
                           f"inputs {self.warm_from - self.built_at:.3f} s, "
                           f"warm-up {time.monotonic() - self.warm_from:.3f} s")

    def warm_up(self) -> None:
        """One render at the batch the window forms, with few steps: every shape it uses."""
        futs = [self.engine.submit(fill50k.caption(self.items[i]), guide=self.guides[i],
                                   seed=i, num_inference_steps=int(self.t["warmup_steps"]),
                                   guidance_scale=float(self.t["guidance_scale"]),
                                   height=self.res, width=self.res)
                for i in range(int(self.t["clients"]))]
        for f in futs:
            f.result(timeout=1200)

    def request(self, k: int) -> dict:
        i = k % len(self.items)
        return dict(prompt=fill50k.caption(self.items[i]), guide=i, seed=self.latent_seed(k))

    # ------------------------------------------------------------------ window

    def measure(self, seconds: float, tracer=None) -> dict:
        clients = int(self.t["clients"])
        stop = threading.Event()
        first = threading.Event()
        # closed while the traced part ends: stopping the profiler holds the interpreter
        # for seconds, so the clients wait and nothing is in flight meanwhile
        gate = threading.Event()
        gate.set()
        counter = itertools.count()
        stats0 = dict(self.engine.stats, batch_sizes=dict(self.engine.stats["batch_sizes"]))
        launches0 = dict(self.fa.LAUNCHES)
        trace_s = float(self.t["trace_seconds"])
        traced: Dict[str, object] = {}
        t_start = [0.0]

        def record(k, spec, t_sub, fut):
            t_done = time.monotonic()
            rec = dict(spec, k=k, submit=t_sub, done=t_done, batch=self.engine.stats["batches"],
                       ok=fut.exception() is None)
            if rec["ok"]:
                rec["image"] = fut.result()
            with self.lock:
                self.done[k] = rec
            first.set()
            if tracer is not None and tracer.running and "stop_at" not in traced \
                    and t_done - t_start[0] >= trace_s:
                traced["stop_at"] = rec["batch"]
                gate.clear()
                traced["event"].set()

        def client():
            while not stop.is_set():
                gate.wait()
                k = next(counter)
                spec = self.request(k)
                t_sub = time.monotonic()
                fut = self.engine.submit(spec["prompt"], guide=self.guides[spec["guide"]],
                                         seed=spec["seed"], height=self.res, width=self.res,
                                         num_inference_steps=int(self.t["steps"]),
                                         guidance_scale=float(self.t["guidance_scale"]))
                fut.add_done_callback(lambda f, k=k, spec=spec, t_sub=t_sub:
                                      record(k, spec, t_sub, f))
                try:
                    fut.result(timeout=600)
                except Exception:  # counted as failed by its record
                    pass

        threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
        if tracer is not None:
            traced["event"] = threading.Event()
            tracer.start()
        t_start[0] = time.monotonic()
        for th in threads:
            th.start()
        first.wait(timeout=900)
        with self.lock:
            t_open = min(r["done"] for r in self.done.values())
        if tracer is not None:
            traced["event"].wait(timeout=900)
            traced["trace"] = tracer.stop()
            gate.set()
        deadline = t_open + seconds
        while time.monotonic() < deadline:
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0)))
        stop.set()
        for th in threads:
            th.join(timeout=900)
        launches = {k: self.fa.LAUNCHES[k] - launches0[k] for k in launches0}
        with self.lock:
            recs = list(self.done.values())
        if tracer is not None:
            traced.pop("event")
            traced["sizes"] = batch_sizes(recs, traced["stop_at"])
        return dict(window_of(recs, deadline), kind=KIND, traced=traced or None,
                    launches=launches, engine=_delta(stats0, self.engine.stats),
                    units=len({r["batch"] for r in recs}))

    def end_to_end(self, w: dict) -> Dict[str, float]:
        return end_to_end(w)

    def notes(self, w: dict) -> List[str]:
        lat = w["latencies"]
        lines = [self.setup_note,
                 f"window {w['seconds']:.4f} s: {w['batches']} batches, {w['images']} images "
                 f"({w['failed']} failed of {w['attempted']})"]
        if lat:
            q = statistics.quantiles(lat, n=10, method="inclusive")
            lines.append(f"latency s: median {statistics.median(lat):.4f}, p90 {q[-1]:.4f}, "
                         f"max {lat[-1]:.4f}, n {len(lat)}")
        lines.append(f"engine over the run: {w['engine']}")
        per_batch = self.batch_launches()
        units = w["units"]
        want = {k: v * units for k, v in per_batch.items()}
        if w["launches"] != want:
            lines.append(f"flash launches {w['launches']} differ from the {units} batches' "
                         f"sites {want}: the site list needs a look")
        return lines

    # ------------------------------------------------------------------ work model

    def sites(self, images: int) -> List[work.Site]:
        lat = self.res // 8
        return (work.unet_sites(self.cell.config["unet"], 2 * images, lat, "fwd",
                                int(self.t["steps"]))
                + work.vae_sites(self.cell.config["vae"], images, lat))

    def batch_launches(self) -> Dict[str, int]:
        """Flash calls a batch makes: K1 at the UNet's sites, K2 at the VAE's."""
        lat, cfg = self.res // 8, self.cell.config
        unet = work.unet_sites(cfg["unet"], 2, lat, "fwd", int(self.t["steps"]))
        return {"k1": sum(s.count for s in unet),
                "k2": sum(s.count for s in work.vae_sites(cfg["vae"], 1, lat)), "k3": 0, "k4": 0}

    def unit_flops(self, images: int) -> float:
        return work.serve_batch_flops(self.cell.config, images, self.res, int(self.t["steps"]))

    # ------------------------------------------------------------------ correctness

    def release(self) -> None:
        self.engine.stop()
        del self.engine, self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, w: dict, precision: str = "float32") -> Dict[str, tuple]:
        """The reference renders again every request of whole batches of the window
        (``whole_batches``), so that each slot a batch fills is compared; the number is
        the worst relative L2 gap of a served image."""
        sample = whole_batches(w["in_window"], self.done, int(self.t["check_batches"]),
                               self.seed)
        if not sample:
            return {"image_rel_l2": (NOTHING_COMPARED, self.t["limits"]["image_rel_l2"])}
        recs = [self.done[k] for k in sample]
        got = [r["image"] for r in recs]
        want = self.reference_images(recs, precision)
        return {"image_rel_l2": (image_gap(got, want), self.t["limits"]["image_rel_l2"])}

    def reference_images(self, recs: List[dict], precision: str) -> List[np.ndarray]:
        """uint8 (H, W, 3) renders of the requests by the plain reference."""
        cfg = self.cell.config
        with numerics.exact_float32(), torch.no_grad():
            mods = stack.reference(cfg, self.seed, self.device, precision)
            out = []
            per = int(self.t["check_batch"])
            for i in range(0, len(recs), per):
                out += self._render(mods, recs[i:i + per])
            del mods
        return out

    def _render(self, mods, recs) -> List[np.ndarray]:
        cfg, dev, n, lat = self.cell.config, self.device, len(recs), self.res // 8
        texts = [""] * n + [r["prompt"] for r in recs]
        ids = torch.as_tensor(text.token_ids(texts), device=dev)
        ids0 = torch.as_tensor(text.token_ids(texts, pad=0), device=dev)
        ctx, pooled = ref.encode_text(mods["text"], ids, ids0)
        guides = torch.as_tensor(np.stack([self.guides[r["guide"]] for r in recs]), device=dev)
        controls = mods["control"].controls(guides.permute(0, 3, 1, 2))
        adapters = mods["control"].adapters(controls, cfg["unet"])
        x = torch.cat([torch.randn((1, lat, lat, 4), generator=torch.Generator().manual_seed(
            r["seed"])) for r in recs]).permute(0, 3, 1, 2).to(dev)
        extra = {}
        if cfg["unet"]["addition_embed_type"] == "text_time":
            ids6 = torch.tensor([[self.res, self.res, 0, 0, self.res, self.res]] * 2 * n,
                                dtype=torch.float32, device=dev)
            extra = {"text_embeds": pooled, "time_ids": ids6}
        g = float(self.t["guidance_scale"])

        def eps_fn(xt, t):
            e = mods["unet"](torch.cat([xt, xt]), torch.full((2 * n,), float(t), device=dev),
                             ctx, adapters, 1.0, **extra)
            e_u, e_c = e.chunk(2)
            return e_u + g * (e_c - e_u)

        x = schedule.dpm_solve(x, int(self.t["steps"]), eps_fn)
        imgs = []
        for row in x:
            img = mods["vae"].decode(row[None]).permute(0, 2, 3, 1)[0].cpu().numpy()
            imgs.append(np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8))
        return imgs


def end_to_end(w: dict) -> Dict[str, float]:
    """Images a second over the window, and the 90th percentile of the latencies of
    its requests."""
    out = {"serve_img_per_s": w["images"] / w["seconds"] if w["seconds"] > 0 else 0.0}
    if w["latencies"]:
        out["serve_latency_p90_s"] = statistics.quantiles(w["latencies"], n=10,
                                                          method="inclusive")[-1]
    return out


def batch_sizes(recs: List[dict], last_batch: int) -> List[int]:
    """The requests of each batch up to ``last_batch`` (the traced part's batches)."""
    sizes: Dict[int, int] = {}
    for r in recs:
        if r["batch"] <= last_batch:
            sizes[r["batch"]] = sizes.get(r["batch"], 0) + 1
    return list(sizes.values())


def window_of(recs: List[dict], deadline: float) -> dict:
    """The window of a run's request records ({batch, submit, done, ok, k}): it opens
    at the first batch completion and closes at the last one by ``deadline``; the
    requests of the batches completed after the opening one and up to the close are
    in it, and the rate is theirs over its length."""
    batch_done: Dict[int, float] = {}
    for r in recs:
        batch_done[r["batch"]] = min(batch_done.get(r["batch"], r["done"]), r["done"])
    t_open = min(batch_done.values())
    t_close = max(t for t in batch_done.values() if t <= deadline)
    inside = [r for r in recs if t_open < batch_done[r["batch"]] <= t_close]
    ok = [r for r in inside if r["ok"]]
    return dict(seconds=t_close - t_open, images=len(ok), attempted=len(inside),
                failed=len(inside) - len(ok),
                latencies=sorted(r["done"] - r["submit"] for r in ok),
                batches=len({r["batch"] for r in inside}), in_window=[r["k"] for r in ok])


def whole_batches(ks: List[int], done: Dict[int, dict], count: int, seed: int) -> List[int]:
    """The requests (among ``ks``, by their records in ``done``) of ``count`` batches,
    the fullest first, drawn from the seed among batches that filled as many slots."""
    by_batch: Dict[int, List[int]] = {}
    for k in ks:
        by_batch.setdefault(done[k]["batch"], []).append(k)
    ids = sorted(by_batch)
    ties = np.random.default_rng([int(seed), 2]).permutation(len(ids))
    order = sorted(range(len(ids)), key=lambda i: (-len(by_batch[ids[i]]), ties[i]))
    return sorted(k for i in order[:count] for k in by_batch[ids[i]])


def image_gap(got, want) -> float:
    """The worst relative L2 gap of uint8 images, over the reference's deviation from
    mid-grey (the gap in the [-1, 1] frame the pipeline decodes to)."""
    return max(float(np.linalg.norm(a.astype(np.float64) - b)
                     / np.linalg.norm(b.astype(np.float64) - 127.5))
               for a, b in zip(got, want))


def _delta(before: dict, after: dict) -> dict:
    sizes = {b: n - before["batch_sizes"].get(b, 0) for b, n in after["batch_sizes"].items()}
    return {k: after[k] - before[k] for k in ("requests", "batches", "padded_slots", "errors")} \
        | {"batch_sizes": {b: n for b, n in sizes.items() if n}}
