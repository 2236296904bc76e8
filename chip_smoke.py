#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs its main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) when it fails:
  1. device   the CUDA device, its name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc builds the hand-written kernels from controllora_tpu_torch/csrc.
  3. kernels  K1-K4 against their plain PyTorch versions on the card, bf16 inputs,
              at the serving and training paths' shapes, other resolutions' shapes,
              and (K3/K4) ragged L, not a multiple of the 64-row tile; times of both.
              Then the gradient of FlashAttention (K2 forward, K3 + K4 backward)
              through dot_product_attention against autograd of the plain fp32
              attention, at the training shape and a ragged one.
  4. parity   full-width SD1.5 (random seeded bf16 weights) + the `base` ControlLoRA
              (perturbed so the folded biases are nonzero): one folded UNet eval,
              one VAE decode and the CLIP encoder on the card against the same
              weights in fp32 on the CPU, where the port takes its plain versions.
  5. serve    the BatchingEngine over the full-width pipeline on the card: one
              guided 512² request (20 steps, CFG 9, DPM-Solver++), then 3 guided
              together (one padded batch of 4), then 1 unguided; exact kernel launch
              counts per call, finite 512x512x3 images, latency and img/s.
  6. decode   VAE decode times at batch 1 and batch 4.
  7. train parity  one ControlLoRA train step's loss and adapter gradient at batch 1
              (same weights, latents, noise, t, ids, guide) on the card (bf16,
              kernels; then again with the adapters cast to bf16 as well) against
              the CPU (fp32, plain versions); VAE encode_moments.
  8. train    the training slice: ControlLoRATrainer.train_step on full-width SD1.5
              + `base` at 512², batch 8 of fill50k, bf16 frozen stack: 2 warm-up and
              5 timed steps, exact launches per step, finite loss, nonzero gradient,
              params updated; ms/step, img/s, peak memory, one profiled step.
  9. entry    `python -m controllora_tpu_torch.train` for 2 steps at 512² batch 8;
              its artifact loads back into the port's ControlLoRA strictly.
The last lines are the kernel record, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

O_BOUND, LSE_BOUND, GRAD_BOUND, REL_BOUND = 1e-2, 1e-3, 1e-2, 5e-2
STEPS, CFG, RES = 20, 9.0, 512
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 5
TRAIN_LAUNCHES = {"k1": 0, "k2": 6, "k3": 5, "k4": 5}  # per step: 5 UNet + 1 VAE
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() over `iters` runs, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_l2(out, ref):
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).norm() / ref.norm())


def plain_fp32(fa, q, k, v, heads, qb, kb, vb):
    """K1's plain version with an fp32 result: the biases TILED over the batch (row
    i reads bias row i % Bc, the [uncond || cond] CFG layout), the biased sums
    rounded to bf16 as the kernel (and the JAX caller) rounds them, then attention
    in fp32. Comparing with the unrounded output keeps the bound clear of the
    output's own bf16 ulp."""
    b = q.shape[0]
    qe, ke, ve = (x + xb.repeat(b // xb.shape[0], 1, 1)
                  for x, xb in ((q, qb), (k, kb), (v, vb)))
    return fa.attention_lse_plain(qe.float(), ke.float(), ve.float(), heads)[0]


def phase_kernels(torch, fa, device):
    """K1/K2 vs plain; returns {kernel: {"max_abs_err", "ms", "plain_ms"}}."""
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    record = {"k1": {"max_abs_err": 0.0}, "k2": {"max_abs_err": 0.0}}
    # K1: (B, heads, L, D, bias batch Bc). The main path gives the first two: the
    # 512² batch-1 render (one guide under the CFG pair) and the batch-4 render
    # (per-image biases, every row different, tiled over the 8-row CFG batch).
    for b, h, l, d, bc in ((2, 8, 4096, 40, 1), (8, 8, 4096, 40, 4),
                           (2, 8, 2304, 80, 1), (2, 8, 7744, 40, 1)):
        q, k, v = rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        qb, kb, vb = (0.25 * rnd(bc, l, h * d) for _ in range(3))
        out = fa.biased_attention(q, k, v, h, qb, kb, vb)
        torch.cuda.synchronize()
        ref = plain_fp32(fa, q, k, v, h, qb, kb, vb)
        err = (out.float() - ref).abs().max().item()
        if not (out.shape == ref.shape and torch.isfinite(out).all() and err <= O_BOUND):
            raise AssertionError(f"K1 B{b} H{h} L{l} D{d} Bc{bc}: max|dO| {err} > {O_BOUND}")
        line = (f"K1 B={b} H={h} L={l} D={d} (biases batch {bc} -> {b}): "
                f"max|dO| {err:.3e} <= {O_BOUND}")
        if (l, d) == (4096, 40):
            ms = cuda_ms(lambda: fa.biased_attention(q, k, v, h, qb, kb, vb))
            pms = cuda_ms(lambda: fa.biased_attention_plain(q, k, v, h, qb, kb, vb))
            if b == 2:
                record["k1"].update(ms=ms, plain_ms=pms)
            line += f"  kernel {ms:.4f} ms  plain {pms:.4f} ms"
        record["k1"]["max_abs_err"] = max(record["k1"]["max_abs_err"], err)
        log(line)
        del q, k, v, qb, kb, vb, out, ref
    # K2: the VAE mid-attention and the unguided UNet self-attention of serving
    # (batch 1), then the training path's (batch 8): UNet self-attention and VAE encoder
    for b, h, l, d in ((1, 1, 4096, 512), (2, 8, 4096, 40), (8, 8, 4096, 40),
                       (8, 1, 4096, 512)):
        q, k, v = rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        o, lse = fa.flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), h)
        err = (o.float() - o_ref).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        if not (torch.isfinite(o).all() and err <= O_BOUND and lerr <= LSE_BOUND):
            raise AssertionError(f"K2 B{b} H{h} L{l} D{d}: max|dO| {err}, max|dLSE| {lerr}")
        line = (f"K2 B={b} H={h} L={l} D={d}: max|dO| {err:.3e} <= {O_BOUND}, "
                f"max|dLSE| {lerr:.3e} <= {LSE_BOUND}")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, h))
        pms = cuda_ms(lambda: fa.attention_lse_plain(q, k, v, h))
        line += f"  kernel {ms:.4f} ms  plain {pms:.4f} ms"
        if (b, d) == (1, 512):
            record["k2"].update(ms=ms, plain_ms=pms)
        record["k2"]["max_abs_err"] = max(record["k2"]["max_abs_err"], err)
        log(line)
        del q, k, v, o, lse, o_ref, lse_ref
    return record


def build_stack(torch, device):
    from controllora_tpu.config import get_preset
    from controllora_tpu.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline

    gen = torch.Generator(device=device).manual_seed(0)
    unet, vae, text = zoo.build_models("sd15", torch.bfloat16, device, gen)
    control = zoo.build_control_lora(get_preset("base"), device, gen)
    with torch.no_grad():
        for p in control.parameters():  # fresh `up` factors are zero: fold would be a no-op
            p.add_(0.01)
    return StableDiffusionControlLoRAPipeline(unet, vae, text, HashTokenizer(), control,
                                              device=device)


def cpu_copy(torch, module, cls, config):
    from controllora_tpu_torch.models import zoo

    copy = zoo.materialize(cls, config, torch.device("cpu"), None, torch.float32)
    copy.load_state_dict(module.state_dict())
    return copy


def phase_parity(torch, pipe, device):
    """Card (bf16, kernels) against CPU (fp32, plain versions) on one latent row."""
    import numpy as np
    from torch.func import functional_call

    from controllora_tpu_torch.models.clip import CLIPTextModel
    from controllora_tpu_torch.models.control_lora import ControlLoRA
    from controllora_tpu_torch.models.unet import UNet2DConditionModel
    from controllora_tpu_torch.models.vae import AutoencoderKL
    from controllora_tpu_torch.ops.folding import fold_adapters

    rng = np.random.default_rng(1)
    guide = torch.from_numpy(rng.uniform(-1, 1, (1, 3, RES, RES)).astype(np.float32))
    lat = torch.from_numpy(rng.normal(size=(1, 4, RES // 8, RES // 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 49408, (1, 77))).long()
    t = torch.tensor([500])

    with torch.inference_mode():
        ctx = pipe.text_encoder(ids.to(device))
        weights, biases = fold_adapters(
            pipe.unet, pipe.control_lora.adapters_for(guide.to(device), pipe.unet.config))
        biases = {k: b.to(torch.bfloat16) for k, b in biases.items()}
        eps = functional_call(pipe.unet, weights, (lat.to(device), t.to(device), ctx),
                              {"biases": biases})
        img = pipe.vae.decode(lat.to(device))
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    c_text = cpu_copy(torch, pipe.text_encoder, CLIPTextModel, pipe.text_encoder.config)
    c_unet = cpu_copy(torch, pipe.unet, UNet2DConditionModel, pipe.unet.config)
    c_vae = cpu_copy(torch, pipe.vae, AutoencoderKL, pipe.vae.config)
    c_control = cpu_copy(torch, pipe.control_lora, ControlLoRA, pipe.control_lora.config)
    with torch.inference_mode():
        c_ctx = c_text(ids)
        c_weights, c_biases = fold_adapters(
            c_unet, c_control.adapters_for(guide, c_unet.config))
        c_eps = functional_call(c_unet, c_weights, (lat, t, c_ctx), {"biases": c_biases})
        c_img = c_vae.decode(lat)
    cpu_s = time.perf_counter() - t0
    errs = {"clip": rel_l2(ctx, c_ctx), "folded unet eval": rel_l2(eps, c_eps),
            "vae decode": rel_l2(img, c_img)}
    for name, err in errs.items():
        log(f"parity {name}: card bf16 vs CPU fp32 relative L2 {err:.4e} <= {REL_BOUND}")
    log(f"parity CPU side (fp32, batch 1, L=4096) {cpu_s:.1f} s")
    for name, out in (("unet", eps), ("vae", img)):
        if not torch.isfinite(out).all():
            raise AssertionError(f"parity: non-finite {name} output on the card")
    bad = {k: v for k, v in errs.items() if not v <= REL_BOUND}
    if bad:
        raise AssertionError(f"parity outside {REL_BOUND}: {bad}")


def phase_breakdown(torch, pipe, device):
    """Host-clock times of each layer of one guided batch-1 render (synchronised)."""
    import numpy as np
    from torch.func import functional_call

    from controllora_tpu_torch.ops.folding import fold_adapters

    guide = torch.from_numpy(np.zeros((1, 3, RES, RES), np.float32)).to(device)
    lat = torch.zeros((1, 4, RES // 8, RES // 8), device=device)

    def timed(fn, n=5):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n * 1e3

    with torch.inference_mode():
        ctx, t_text = timed(lambda: pipe.encode_prompt("a photo"))
        ctx2 = ctx.reshape(2, 77, -1)

        def hint_fold():
            w, b = fold_adapters(pipe.unet, pipe.control_lora.adapters_for(
                guide, pipe.unet.config))
            return w, {k: v.to(torch.bfloat16) for k, v in b.items()}

        (w, b), t_fold = timed(hint_fold)
        lat2, tt = torch.cat([lat, lat]), torch.full((2,), 500, device=device)
        _, t_unet = timed(lambda: functional_call(pipe.unet, w, (lat2, tt, ctx2),
                                                  {"biases": b}))
        _, t_dec = timed(lambda: pipe.vae.decode(lat))
    log(f"layers (guided, batch 1): text encode {t_text:.2f} ms, hint + fold "
        f"{t_fold:.2f} ms, CFG UNet eval {t_unet:.2f} ms, VAE decode {t_dec:.2f} ms")


def phase_serve(torch, fa, pipe):
    """The main path through the serving engine; returns the launch counts."""
    import numpy as np

    from controllora_tpu_torch.serving import BatchingEngine

    rng = np.random.default_rng(2)
    guides = [rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32) for _ in range(4)]
    common = dict(num_inference_steps=STEPS, guidance_scale=CFG, height=RES, width=RES,
                  return_array=True)
    eng = BatchingEngine(pipe, max_wait_ms=500.0, buckets=(1, 4), device=pipe.device)
    images = []
    try:
        eng.submit("warm up", guide=guides[0], **dict(common, num_inference_steps=2)
                   ).result(timeout=600)
        fa.reset_launch_counts()  # the main path starts here
        plan = (("guided batch 1", [("a red square", guides[0])], 1),
                ("guided batch 4 (3 requests + 1 pad)",
                 [(f"prompt {i}", guides[i]) for i in range(1, 4)], 4),
                ("unguided batch 1", [("a blue circle", None)], 1))
        for name, reqs, bucket in plan:
            before = dict(fa.LAUNCHES)
            futs = [eng.submit(p, guide=g, seed=10 + i, **common)
                    for i, (p, g) in enumerate(reqs)]
            out = [f.result(timeout=900) for f in futs]
            per_call = {k: fa.LAUNCHES[k] - before[k] for k in before}
            guided = reqs[0][1] is not None
            want = ({"k1": 5 * STEPS, "k2": 1, "k3": 0, "k4": 0} if guided
                    else {"k1": 0, "k2": 5 * STEPS + 1, "k3": 0, "k4": 0})
            if per_call != want:
                raise AssertionError(f"{name}: launches {per_call}, expected {want}")
            dt = eng.stats["last_batch_seconds"]
            if eng.stats["batch_sizes"].get(bucket, 0) < 1:
                raise AssertionError(f"{name}: no batch of {bucket} ran "
                                     f"({eng.stats['batch_sizes']})")
            log(f"serve {name}: {dt:.3f} s per call, {bucket / dt:.3f} img/s computed, "
                f"{len(reqs) / dt:.3f} img/s served; launches {per_call}")
            images += out
        total = dict(fa.LAUNCHES)  # the main path ends here
    finally:
        eng.stop()
    if eng.stats["errors"]:
        raise AssertionError(f"serve: {eng.stats['errors']} failed batches")
    if len(images) != 5:
        raise AssertionError(f"serve: {len(images)} images, expected 5")
    for img in images:
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all():
            raise AssertionError(f"serve: bad image {img.shape}")
    log(f"serve: 5 images, all {RES}x{RES}x3 and finite; main-path launches {total}")
    return total


def phase_decode(torch, pipe, device):
    lat1 = torch.randn((1, 4, RES // 8, RES // 8), device=device)
    lat4 = torch.randn((4, 4, RES // 8, RES // 8), device=device)
    with torch.inference_mode():
        b1 = cuda_ms(lambda: pipe.vae.decode(lat1), iters=5)
        b4 = cuda_ms(lambda: pipe.vae.decode(lat4), iters=5)
        loop4 = cuda_ms(lambda: [pipe.vae.decode(lat4[i:i + 1]) for i in range(4)], iters=5)
    log(f"VAE decode {RES}²: batch 1 {b1:.3f} ms, batch 4 {b4:.3f} ms "
        f"({b4 / 4:.3f} ms/image), 4 x batch 1 {loop4:.3f} ms")


def grad_check(name, out, ref):
    """max|out - ref| <= GRAD_BOUND * max(1, max|ref|), finite; returns the error."""
    err = (out.float() - ref).abs().max().item()
    bound = GRAD_BOUND * max(1.0, ref.abs().max().item())
    if not (out.shape == ref.shape and bool(out.isfinite().all()) and err <= bound):
        raise AssertionError(f"{name}: max|d| {err} > {bound}")
    return err


def phase_backward_kernels(torch, fa, device):
    """K3/K4 vs plain (fp32 on the same bf16 inputs, O and LSE from K2); returns
    {kernel: {"max_abs_err", "ms", "plain_ms"}}."""
    gen = torch.Generator(device=device).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    record = {"k3": {"max_abs_err": 0.0}, "k4": {"max_abs_err": 0.0}}
    # the training path's shape (5 UNet self-attentions at 512², batch 8), the 384²
    # and 704² latents (L a multiple of the kernels' 64-row tile), then ragged L: the
    # 520² latent (4225 = 66 * 64 + 1) and a short one, where the kernels mask P by index
    for b, h, l, d in ((8, 8, 4096, 40), (2, 8, 2304, 80), (1, 8, 7744, 40),
                       (2, 8, 4225, 40), (1, 8, 300, 80)):
        q, k, v, do = (rnd(b, l, h * d) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, h)
        dcap = fa.attention_dcap(o, do, h)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dcap, h)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, dcap, h)
        torch.cuda.synchronize()
        args = [x.float() for x in (q, k, v, do)] + [lse, dcap]
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args, h)
        ref_dq = fa.flash_bwd_dq_plain(*args, h)
        tag = f"B={b} H={h} L={l} D={d}"
        errs = {n: grad_check(f"{n} {tag}", out, ref)
                for n, out, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
        del ref_dk, ref_dv, ref_dq, args
        line = (f"K3/K4 {tag}: max|d| dQ {errs['dq']:.3e}, dK {errs['dk']:.3e}, "
                f"dV {errs['dv']:.3e} <= {GRAD_BOUND} * max(1, max|ref|)")
        if (b, l, d) == (8, 4096, 40):
            bwd = (q, k, v, do, lse, dcap, h)
            ms3 = cuda_ms(lambda: fa.flash_bwd_dkv(*bwd))
            pms3 = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*bwd))
            ms4 = cuda_ms(lambda: fa.flash_bwd_dq(*bwd))
            pms4 = cuda_ms(lambda: fa.flash_bwd_dq_plain(*bwd))
            record["k3"].update(ms=ms3, plain_ms=pms3)
            record["k4"].update(ms=ms4, plain_ms=pms4)
            line += (f"  K3 {ms3:.4f} ms (plain {pms3:.4f})  K4 {ms4:.4f} ms "
                     f"(plain {pms4:.4f})")
        record["k3"]["max_abs_err"] = max(record["k3"]["max_abs_err"], errs["dk"], errs["dv"])
        record["k4"]["max_abs_err"] = max(record["k4"]["max_abs_err"], errs["dq"])
        log(line)
        del q, k, v, do, o, lse, dcap, dk, dv, dq
    return record


def phase_flash_grad(torch, fa, device):
    """Gradients through dot_product_attention (the route that used to drop them)
    against autograd of the plain fp32 attention: the training shape, and a ragged L."""
    for b, h, l, d in ((8, 8, 4096, 40), (2, 8, 4225, 40)):
        flash_grad_case(torch, fa, device, b, h, l, d)


def flash_grad_case(torch, fa, device, b, h, l, d):
    from controllora_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads

    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, do = (torch.randn((b, l, h * d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(fa.LAUNCHES)
    dot_product_attention(q, k, v, h).backward(do)
    torch.cuda.synchronize()
    used = {n: fa.LAUNCHES[n] - before[n] for n in before}
    if used != {"k1": 0, "k2": 1, "k3": 1, "k4": 1}:
        raise AssertionError(f"FlashAttention launches {used}")
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    qh, kh, vh = (split_heads(x, h) for x in ref_in)
    merge_heads(torch.softmax(qh @ kh.transpose(-1, -2) * d**-0.5, dim=-1) @ vh
                ).backward(do.float())
    errs = {n: grad_check(f"FlashAttention d{n}", x.grad, r.grad)
            for n, x, r in zip("qkv", (q, k, v), ref_in)}
    log(f"FlashAttention grad B={b} H={h} L={l} D={d} vs plain fp32 autograd: "
        + ", ".join(f"max|d{n}| {e:.3e}" for n, e in errs.items())
        + f" <= {GRAD_BOUND} * max(1, max|ref|); |dq| max {q.grad.abs().max().item():.3e}")


def phase_train_parity(torch, pipe, device):
    """One train step's loss and adapter gradient at batch 1, card (bf16, kernels)
    against CPU (fp32, plain versions) on the same weights and draws; VAE encode."""
    import numpy as np

    from controllora_tpu_torch.models.clip import CLIPTextModel
    from controllora_tpu_torch.models.control_lora import ControlLoRA
    from controllora_tpu_torch.models.unet import UNet2DConditionModel
    from controllora_tpu_torch.models.vae import AutoencoderKL
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer

    rng = np.random.default_rng(5)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    batch = {"latents": t(rng.normal(size=(1, 4, RES // 8, RES // 8))),
             "guide_values": t(rng.uniform(-1, 1, (1, 3, RES, RES))),
             "input_ids": torch.from_numpy(rng.integers(0, 49408, (1, 77))).long()}
    noise = t(rng.normal(size=(1, 4, RES // 8, RES // 8)))
    steps = torch.tensor([500])
    pixels = t(rng.uniform(-1, 1, (1, 3, RES, RES)))

    def run(unet, vae, text, control, dev, hint_dtype, adapter_dtype=None):
        trainer = ControlLoRATrainer(control, unet, vae, text, hint_compute_dtype=hint_dtype,
                                     adapter_compute_dtype=adapter_dtype)
        loss = trainer.loss({k: x.to(dev) for k, x in batch.items()},
                            noise=noise.to(dev), timesteps=steps.to(dev))
        grad = torch.cat([g.detach().float().flatten().cpu() for g in trainer.grads(loss)])
        with torch.no_grad():
            moments = torch.cat(vae.encode_moments(pixels.to(dev)), dim=1).float().cpu()
        return loss.item(), grad, moments

    card = (pipe.unet, pipe.vae, pipe.text_encoder, pipe.control_lora, device, torch.bfloat16)
    loss, grad, moments = run(*card)
    # --adapter_compute_bf16: the adapter factors and control maps cast to bf16 too
    loss16, grad16, _ = run(*card, adapter_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_loss, c_grad, c_moments = run(
        cpu_copy(torch, pipe.unet, UNet2DConditionModel, pipe.unet.config),
        cpu_copy(torch, pipe.vae, AutoencoderKL, pipe.vae.config),
        cpu_copy(torch, pipe.text_encoder, CLIPTextModel, pipe.text_encoder.config),
        cpu_copy(torch, pipe.control_lora, ControlLoRA, pipe.control_lora.config),
        torch.device("cpu"), None)
    cpu_s = time.perf_counter() - t0
    errs = {"train loss": abs(loss - c_loss) / abs(c_loss),
            "adapter gradient": rel_l2(grad, c_grad),
            "train loss (adapter compute bf16)": abs(loss16 - c_loss) / abs(c_loss),
            "adapter gradient (adapter compute bf16)": rel_l2(grad16, c_grad),
            "vae encode_moments": rel_l2(moments, c_moments)}
    for name, err in errs.items():
        log(f"train parity {name}: card bf16 vs CPU fp32 relative {err:.4e} <= {REL_BOUND}")
    log(f"train parity: loss card {loss:.6f} CPU {c_loss:.6f}; |grad| card "
        f"{grad.norm():.4e} CPU {c_grad.norm():.4e}; CPU side (fp32, batch 1, L=4096) "
        f"{cpu_s:.1f} s")
    if not (np.isfinite(loss) and np.isfinite(loss16) and bool(grad.isfinite().all())
            and bool(grad16.isfinite().all()) and c_grad.norm() > 0):
        raise AssertionError("train parity: non-finite or zero result")
    bad = {k: v for k, v in errs.items() if not v <= REL_BOUND}
    if bad:
        raise AssertionError(f"train parity outside {REL_BOUND}: {bad}")


KERNEL_CLASSES = (("flash (ours)", ("flash_",)),
                  ("GEMM", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
                  ("conv + layout", ("conv", "cudnn", "nchwToNhwc", "nhwcToNchw")),
                  ("norms", ("Moments", "norm", "Norm")),
                  ("softmax", ("softmax", "Softmax")))


def kernel_class(name):
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise, copies, other"


def device_profile(torch, fn):
    """Run fn() once under torch.profiler; returns (wall s, device busy s, kernels
    [(name, ms)] by time). Busy time is the sum of the CUDA kernel and memory
    operation durations (one stream: they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()) / 1e3, top


def phase_train(torch, fa, pipe, device):
    """The training main path; returns its launch counts."""
    from controllora_tpu.data.registry import DatasetBase, batch_iterator
    from controllora_tpu.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch

    data = batch_iterator(DatasetBase.from_name("process/fill50k")(HashTokenizer(),
                                                                   resolution=RES),
                          TRAIN_BATCH, seed=0)
    batches = [to_device_batch(next(data), device)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    trainer = ControlLoRATrainer(pipe.control_lora, pipe.unet, pipe.vae, pipe.text_encoder,
                                 hint_compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    for batch in batches[:TRAIN_WARMUP]:
        trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in trainer.params]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    metrics, per_step = [], []
    for batch in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        c0 = dict(fa.LAUNCHES)
        metrics.append(trainer.train_step(batch, gen))
        per_step.append({n: fa.LAUNCHES[n] - c0[n] for n in c0})
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    total = dict(fa.LAUNCHES)  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    changed = sum(not torch.equal(a, p.detach()) for a, p in zip(before, trainer.params))
    log(f"train {RES}² batch {TRAIN_BATCH}: {step_s * 1e3:.1f} ms/step, "
        f"{TRAIN_BATCH / step_s:.3f} img/s, peak {peak_gb:.2f} GiB allocated; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.4f}" for x in norms)
        + f"; {changed}/{len(before)} params changed; launches per step {per_step[0]}")
    if any(p != TRAIN_LAUNCHES for p in per_step):
        raise AssertionError(f"train launches per step {per_step}, expected {TRAIN_LAUNCHES}")
    import math

    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    if changed == 0:
        raise AssertionError("train: no adapter parameter changed")

    wall, busy, top = device_profile(torch, lambda: trainer.train_step(batches[-1], gen))
    classes = {}
    for name, ms in top:
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
    log(f"train profiled step: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, "
        f"idle share {1 - busy / wall:.3f} (against the unprofiled step "
        f"{1 - busy / step_s:.3f}); by class: "
        + "; ".join(f"{c} {ms:.1f} ms" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]))
        + "; top kernels: " + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top[:10]))
    return total


def phase_entry_point(torch):
    """The training CLI end to end; the saved artifact loads back strictly."""
    from controllora_tpu_torch.training.checkpoint import load_control_lora

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "controllora_tpu_torch.train", "--max_train_steps", "2",
             "--resolution", str(RES), "--train_batch_size", str(TRAIN_BATCH),
             "--log_every", "1", "--output_dir", out, "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
        if len(steps) != 2 or "nan" in proc.stdout:
            raise AssertionError(f"train CLI output:\n{proc.stdout[-2000:]}")
        model, _ = load_control_lora(out)
        n = sum(p.numel() for p in model.parameters())
    log(f"entry point: python -m controllora_tpu_torch.train 2 steps at {RES}² batch "
        f"{TRAIN_BATCH} in {time.perf_counter() - t0:.1f} s ({steps[-1]}); artifact "
        f"loads strictly ({n / 1e6:.2f}M params)")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from controllora_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s ({fa.library_path().name})")

    record = phase_kernels(torch, fa, device)
    record.update(phase_backward_kernels(torch, fa, device))
    phase_flash_grad(torch, fa, device)
    pipe = build_stack(torch, device)
    phase_parity(torch, pipe, device)
    phase_breakdown(torch, pipe, device)
    serve = phase_serve(torch, fa, pipe)
    phase_decode(torch, pipe, device)
    phase_train_parity(torch, pipe, device)
    train = phase_train(torch, fa, pipe, device)
    phase_entry_point(torch)
    # launches on the two main paths, each counted from 0 (serving, then training)
    launches = {n: serve[n] + train[n] for n in serve}

    fwd = "controllora_tpu_torch/csrc/flash_attn_fwd.cu"
    bwd = "controllora_tpu_torch/csrc/flash_attn_bwd.cu"
    vjp = "controllora_tpu/ops/pallas_attention_vjp.py"
    kernels = [
        dict(name="k1_biased_flash_fwd", route="cuda", source=fwd,
             replaces="controllora_tpu/ops/pallas_attention.py:56", launches=launches["k1"],
             **record["k1"]),
        dict(name="k2_flash_fwd_lse", route="cuda", source=fwd, replaces=f"{vjp}:46",
             launches=launches["k2"], **record["k2"]),
        dict(name="k3_flash_bwd_dkv", route="cuda", source=bwd, replaces=f"{vjp}:126",
             launches=launches["k3"], **record["k3"]),
        dict(name="k4_flash_bwd_dq", route="cuda", source=bwd, replaces=f"{vjp}:165",
             launches=launches["k4"], **record["k4"]),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
