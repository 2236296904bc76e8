"""The ControlLoRA train step as the program's train CLI drives it at its defaults:
``training/trainer.py::ControlLoRATrainer.train_step`` over the CLI's data path
(``train.py::make_batches``: fill50k made in C behind the prefetch thread), remat off,
fp32 AdamW through ``make_optimizer`` (lr 1e-4, betas 0.9/0.999, weight decay 1e-2,
clip 1.0), the hint encoder in bf16, the host reading the loss every ``log_every``
steps, and one synchronisation at the window's end.

Traffic keys: ``batch``, ``resolution``, ``log_every``, ``check_steps`` (the first
steps, made in set-up, that the reference follows), ``check_rows`` (rows the reference
runs together), ``trace_seconds``, ``limits``.

Set-up builds one trainer and drives it through its first ``check_steps`` steps, the
window's own call and feed, keeping what the check compares: each step's loss, the
gradient the optimizer got at step 1 (from AdamW's first moment: m = (1 - beta1) g),
and the parameters before step 1 and after the last. The window then goes on with
the same trainer and stream.
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark import stack, work
from benchmark.reference import fill50k, numerics, schedule, text
from benchmark.reference import models as ref

KIND = "train"
LR, BETAS, WEIGHT_DECAY, EPS, CLIP = 1e-4, (0.9, 0.999), 1e-2, 1e-8, 1.0


def seeds(seed: int):
    """(data stream seed, step generator seed) of a run."""
    rng = np.random.default_rng([int(seed), 3])
    return int(rng.integers(0, 2**31)), int(rng.integers(0, 2**31))


class Session:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.t = cell.traffic
        self.res, self.batch = int(self.t["resolution"]), int(self.t["batch"])

    def setup(self) -> None:
        started = time.monotonic()
        from controllora_tpu_torch import train as cli
        from controllora_tpu_torch.data.tokenizer import HashTokenizer
        from controllora_tpu_torch.ops import flash_attention
        from controllora_tpu_torch.training.trainer import (
            ControlLoRATrainer,
            make_optimizer,
            to_device_batch,
        )

        self.fa, self.to_device_batch = flash_attention, to_device_batch
        cfg = self.cell.config
        unet, vae, text_enc, control = stack.program(cfg, self.seed, self.device)
        optimizer = make_optimizer(control.parameters(), learning_rate=LR, beta1=BETAS[0],
                                   beta2=BETAS[1], weight_decay=WEIGHT_DECAY, eps=EPS,
                                   max_grad_norm=CLIP)
        dtype = stack.DTYPES[cfg["dtype"]]
        self.trainer = ControlLoRATrainer(
            control, unet, vae, text_enc, optimizer=optimizer, remat_unet=False,
            hint_compute_dtype=None if dtype == torch.float32 else dtype)
        self.built_at = time.monotonic()
        self.stream_seed, step_seed = seeds(self.seed)
        args = SimpleNamespace(dataset_name="process/fill50k", resolution=self.res,
                               device=str(self.device), max_train_samples=None,
                               cache_latents=False, train_batch_size=self.batch)
        dataset = cli.build_dataset(args, HashTokenizer(), self.stream_seed)
        self.batches, self.plane = cli.make_batches(args, dataset, self.stream_seed, 0)
        self.gen = torch.Generator(self.device).manual_seed(step_seed)
        self.step_seed = step_seed
        self.warm_from = time.monotonic()
        # the first steps: warm-up, and what the reference follows
        named = list(control.named_parameters())
        self.p0 = {n: p.detach().clone() for n, p in named}
        self.losses = []
        for i in range(int(self.t["check_steps"])):
            m = self.step()
            self.losses.append(m["loss"].detach().float().clone())
            if i == 0:
                state = self.trainer.optimizer.adamw.state
                # a parameter the optimizer never stepped has no first moment: it got nothing
                self.g1 = {n: state[p]["exp_avg"].detach().clone() / (1 - BETAS[0])
                           if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                           for n, p in named}
        self.p_end = {n: p.detach().clone() for n, p in named}
        self.losses = [float(x) for x in self.losses]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_note = (f"set-up: program built in {self.built_at - started:.3f} s, "
                           f"inputs {self.warm_from - self.built_at:.3f} s, "
                           f"warm-up {time.monotonic() - self.warm_from:.3f} s")

    def step(self, waits: List[float] = None):
        t0 = time.perf_counter()
        batch = next(self.batches)
        if waits is not None:
            waits.append(time.perf_counter() - t0)
        return self.trainer.train_step(self.to_device_batch(batch, self.device), self.gen)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def measure(self, seconds: float, tracer=None) -> dict:
        log_every = int(self.t["log_every"])
        launches0 = dict(self.fa.LAUNCHES)
        traced = None
        waits: List[float] = []
        steps = 0
        t_open = time.perf_counter()
        if tracer is not None:
            tracer.start()
            t_stop = t_open + float(self.t["trace_seconds"])
        while time.perf_counter() - t_open < seconds:
            m = self.step(waits)
            steps += 1
            if steps % log_every == 0:
                float(m["loss"]), float(m["grad_norm"])  # the CLI's log line reads them
            if tracer is not None and tracer.running and time.perf_counter() >= t_stop:
                self._sync()
                traced = {"trace": tracer.stop(), "steps": steps,
                          "data_wait_s": list(waits)}
        self._sync()
        t_close = time.perf_counter()
        launches = {k: self.fa.LAUNCHES[k] - launches0[k] for k in launches0}
        return dict(kind=KIND, seconds=t_close - t_open, steps=steps, attempted=steps,
                    failed=0, traced=traced, launches=launches, units=steps,
                    data_wait_s=waits)

    def end_to_end(self, w: dict) -> Dict[str, float]:
        return {"train_step_ms": w["seconds"] * 1000.0 / w["steps"]}

    def notes(self, w: dict) -> List[str]:
        lines = [self.setup_note, f"data plane: {self.plane}",
                 f"window {w['seconds']:.4f} s: {w['steps']} steps of batch {self.batch}",
                 f"data wait per step ms: median {statistics.median(w['data_wait_s']) * 1e3:.4f}, "
                 f"max {max(w['data_wait_s']) * 1e3:.4f}",
                 f"set-up losses {self.losses}"]
        want = {k: v * w["steps"] for k, v in self.step_launches().items()}
        if w["launches"] != want:
            lines.append(f"flash launches {w['launches']} differ from the {w['steps']} steps' "
                         f"sites {want}: the site list needs a look")
        return lines

    # ------------------------------------------------------------------ work model

    def sites(self, images: int = None) -> List[work.Site]:
        cfg, lat, b = self.cell.config, self.res // 8, self.batch
        fwd = work.unet_sites(cfg["unet"], b, lat, "fwd", 1)
        bwd = work.unet_sites(cfg["unet"], b, lat, "bwd", 1)
        return fwd + bwd + work.vae_sites(cfg["vae"], b, lat)

    def step_launches(self) -> Dict[str, int]:
        cfg, lat = self.cell.config, self.res // 8
        unet = sum(s.count for s in work.unet_sites(cfg["unet"], 1, lat, "fwd", 1))
        vae = sum(s.count for s in work.vae_sites(cfg["vae"], 1, lat))
        return {"k1": 0, "k2": unet + vae, "k3": unet, "k4": unet}

    def unit_flops(self, images: int = None) -> float:
        return work.train_step_flops(self.cell.config, self.batch, self.res)

    # ------------------------------------------------------------------ correctness

    def release(self) -> None:
        del self.trainer, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, w: dict, precision: str = "float32") -> Dict[str, tuple]:
        """The reference follows the first steps from the same weights, batches and
        draws (``reference_steps``); ``gaps`` gives the numbers."""
        want = reference_steps(self.cell.config, self.t, self.seed, self.device,
                               self.stream_seed, self.step_seed, precision)
        got = {"losses": self.losses, "g1": self.g1, "p0": self.p0, "p_end": self.p_end}
        lim = self.t["limits"]
        return {name: (value, lim[name]) for name, value in gaps(got, want).items()
                if name in lim}


def gaps(got: dict, want: dict) -> Dict[str, object]:
    """The worst step's relative loss gap; by the worst leaf, the gap between the two
    sides' norms of the step-1 gradient, over the larger of the reference leaf's norm
    and the median leaf's; the same gap of the parameters' change after the steps, by
    the worst leaf and by the median over the leaves, and the worst leaf's name. Leaves
    whose reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change. Leaves pair by parameter name."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    names = list(want["g1"])
    g_want = {n: float(want["g1"][n].norm()) for n in names}
    g_med = float(np.median(list(g_want.values())))
    grad_gap = max(abs(float(got["g1"][n].norm()) - g_want[n]) / max(g_want[n], g_med)
                   for n in names)
    moved = [n for n in names if g_want[n] >= 1e-3 * g_med]

    def change(side, n):
        return float((side["p_end"][n] - side["p0"][n].to(side["p_end"][n].device)).norm())

    d_want = {n: change(want, n) for n in moved}
    d_med = float(np.median(list(d_want.values())))
    leaf = {n: abs(change(got, n) - d_want[n]) / max(d_want[n], d_med) for n in moved}
    worst = max(leaf, key=leaf.get)
    return {"loss_rel_gap": loss_gap, "grad_leaf_gap": grad_gap, "change_leaf_gap": leaf[worst],
            "change_median_gap": float(np.median(list(leaf.values()))),
            "change_worst_leaf": worst}


def worst_change_leaf(got: dict, want: dict, leaf: str) -> dict:
    """Where the worst leaf's change gap comes from: the leaf's size, its reference
    gradient over the median leaf's, and the share of its step-1 gradient's elements
    whose sign the two sides give differently."""
    g_med = float(np.median([float(g.norm()) for g in want["g1"].values()]))
    a, b = got["g1"][leaf].flatten(), want["g1"][leaf].flatten().to(got["g1"][leaf].device)
    return {"leaf": leaf, "numel": a.numel(), "grad_over_median": float(b.norm()) / g_med,
            "sign_flips": float((torch.sign(a) != torch.sign(b)).float().mean())}


def reference_steps(cfg: dict, t: dict, seed: int, device, stream_seed: int, step_seed: int,
                    precision: str = "float32", fault: str = None):
    """{losses, g1 (step-1 clipped gradients), p0, p_end (parameters before the first
    step and after the last)} of the plain reference: VAE encode (posterior sample), DDPM noising, text encode, hint encoder,
    UNet with the threaded adapters, MSE against the noise, backward to the adapters,
    global-norm clip and AdamW written out. Rows run in blocks of ``check_rows`` and
    their gradients add up. ``fault`` plants a fault for the control readings:
    "half_batch" takes the mean over the first half of each batch only."""
    res, batch, lat = int(t["resolution"]), int(t["batch"]), int(t["resolution"]) // 8
    rows = int(t["check_rows"])
    with numerics.exact_float32():
        mods = stack.reference(cfg, seed, device, precision)
        control = mods["control"].requires_grad_(True)
        named = list(control.named_parameters())
        params = [p for _, p in named]
        p0 = {n: p.detach().clone() for n, p in named}
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        gen = torch.Generator(device).manual_seed(step_seed)
        losses, g1 = [], None
        data = fill50k.stream_batches(stream_seed, batch, int(t["check_steps"]), res)
        for step, b in enumerate(data, start=1):
            shape = (batch, 4, lat, lat)
            sample_noise = torch.randn(shape, generator=gen, device=device)
            noise = torch.randn(shape, generator=gen, device=device)
            steps_t = torch.randint(0, schedule.TRAIN_STEPS, (batch,), generator=gen,
                                    device=device)
            px = torch.as_tensor(b["images"], device=device).permute(0, 3, 1, 2)
            guides = torch.as_tensor(b["guides"], device=device).permute(0, 3, 1, 2)
            ids = torch.as_tensor(text.token_ids(b["captions"]), device=device)
            ids0 = torch.as_tensor(text.token_ids(b["captions"], pad=0), device=device)
            used = batch // 2 if fault == "half_batch" else batch
            total = 0.0
            for r0 in range(0, used, rows):
                sl = slice(r0, min(r0 + rows, used))
                with torch.no_grad():
                    latents = mods["vae"].encode(px[sl], sample_noise[sl])
                    noisy = schedule.add_noise(latents, noise[sl], steps_t[sl])
                    ctx, pooled = ref.encode_text(mods["text"], ids[sl], ids0[sl])
                extra = {}
                if cfg["unet"]["addition_embed_type"] == "text_time":
                    n = noisy.shape[0]
                    extra = {"text_embeds": pooled, "time_ids": torch.tensor(
                        [[res, res, 0, 0, res, res]] * n, dtype=torch.float32, device=device)}
                adapters = control.adapters(control.controls(guides[sl]), cfg["unet"])
                pred = mods["unet"](noisy, steps_t[sl], ctx, adapters, 1.0, **extra)
                part = (pred - noise[sl]).pow(2).sum() / (used * pred[0].numel())
                part.backward()
                total += float(part.detach())
            losses.append(total)
            with torch.no_grad():
                grads = [p.grad.clone() for p in params]
                for p in params:
                    p.grad = None
                norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
                if float(norm) >= CLIP:
                    grads = [g * (CLIP / norm) for g in grads]
                if step == 1:
                    g1 = {n: g.clone() for (n, _), g in zip(named, grads)}
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    vi.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    p.mul_(1 - LR * WEIGHT_DECAY)
                    m_hat = mi / (1 - BETAS[0] ** step)
                    denom = (vi / (1 - BETAS[1] ** step)).sqrt() + EPS
                    p.sub_(LR * m_hat / denom)
        p_end = {n: p.detach().clone() for n, p in named}
        del mods
    return {"losses": losses, "g1": g1, "p0": p0, "p_end": p_end}
