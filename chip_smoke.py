#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs its main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) when it fails. A render
runs STEPS (10) steps and a timed training run TRAIN_STEPS (3) steps (20 and 5 until
PR 14, cut to keep the script inside its time); the counts below are at those values.
  1. device   the CUDA device, its name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc builds the hand-written kernels from controllora_tpu_torch/csrc;
              the -Xptxas -v report of each kernel (registers, spills, wgmma
              serialisation); a spill or a serialised wgmma fails the phase.
  3. kernels  K1-K4 against their plain PyTorch versions on the card, bf16 inputs,
              at the serving and training paths' shapes, other resolutions' shapes,
              and (K3/K4) D 64 and ragged L, not a multiple of the 64-row tile; at every
              main-path shape of K1 (batch-1 and batch-4 renders) and K2 (VAE,
              unguided UNet, training UNet and VAE encoder) the times of both, the
              bound (operations or bytes at the H100's peaks) and one torch SDPA
              call on the same inputs as a yardstick (a profiler device time under
              the bound means lost events: retried, else "not measured"); the same
              for K1 at the other families' head-dim-64 self-attentions (bias batch
              1 and 4) and K2 at their VAE decodes. The gradient of FlashAttention
              (K2 forward, K3 + K4 backward) against autograd of the plain fp32
              attention, at the training shape and a ragged one. Then K5 (jax's
              stock flash: forward with m and l, dK/dV and dQ on K3's and K4's
              kernels) against its plain versions at the batch-16 training shape, the
              VAE encoder's D 512, the 768² tail, D 64, a non-default and a negative
              softmax scale, and contiguous (B, H, L, D) tensors beside the head-split
              views, with times, bounds and SDPA (the forward also at the VAE
              encoder's shape); L 4225 raises; the gradient of FlashStockAttention
              against autograd. K2, K3 and K4 at SD2.1's and SDXL's training
              shapes (head dim 64 at L 9216, 2304 and 4096; K2 at their VAE encoders,
              D 512) with times, bounds and SDPA, and K3/K4 at a ragged D 64 L. K1 at
              SD1.5's 1024² hires pass (L 16384 at D 40, L 4096 at D 80) and K2 at the
              refiner's unguided level 1 (12 heads of D 64), timed the same way; K2, K3
              and K4 at the canned train_canny task's batch-1 shape (1, 8, 4096, 40); K1
              at the levels ToMe 0.5 merges on SD2.1 768² and SDXL 1024², (2, 5, 4608,
              64), (8, 5, 4608, 64), (2, 10, 2048, 64) and (8, 10, 2048, 64), with
              biases of batch B (merged per CFG row), timed the same way. Right after
              the families' shapes, every kernel's fp32 route (csrc/flash_attn_fp32.cu)
              against its plain version at the fp32 stacks' shapes (FP32_K1, FP32_K2,
              FP32_BWD, FP32_K5: SD1.5 --mixed_precision no, the smoke stacks at 512²,
              the refiner, ragged L, q scaled x4), each timed with its 3xTF32 and fp32
              FMA bounds and fp32 SDPA.
  4. parity   full-width SD1.5 (random seeded bf16 weights) + the `base` ControlLoRA
              (perturbed so the folded biases are nonzero): one folded UNet eval,
              one VAE decode and the CLIP encoder on the card against the same
              weights in fp32 on the CPU, where the port takes its plain versions.
  5. serve    the BatchingEngine over the full-width pipeline on the card: one
              guided 512² request (STEPS steps, CFG 9, DPM-Solver++), then 3 guided
              together (one padded batch of 4), then 1 unguided; exact kernel launch
              counts per call, finite 512x512x3 images, latency and img/s.
  6. presets  the serving deployment: K1 at (2, 8, 2048, 40) and (8, 8, 2048, 40) with
              biases merged per CFG row (bias batch = B) and K2 at (2, 8, 2048, 40), the
              level ToMe 0.5 leaves, against their plain versions with times, bounds and
              SDPA; DeepCache's shallow(cache_of(full)) == full and a ToMe UNet eval
              with K1 against its plain version, at full width; then guided renders
              through the engine at bucket 1 and 4 under the exact, tome and turbo
              presets (turbo: 5 full and 5 shallow UNet evals) and an unguided tome
              render, one guided render each with DDIM, PNDM, Euler and UniPC, and the
              HTTP server (turbo, buckets 1,4, --warmup) answering 4 concurrent
              /generate requests with PNG guides in one batch; exact launches and
              wall seconds of each.
  7. decode   one guided render at batch 1 and at batch 4 under torch.profiler
              (device activity only), under each preset (device busy time, idle
              share, time by kernel class); VAE decode times at batch 1 and batch 4.
  8. train parity  one ControlLoRA train step's loss and adapter gradient at batch 1
              (same weights, latents, noise, t, ids, guide) on the card (bf16,
              kernels; then again with the adapters cast to bf16 as well) against
              the CPU (fp32, plain versions); VAE encode_moments. 8-bit AdamW: the
              card's optimizer step against the CPU's on the same gradients, and one
              8-bit train step's loss card against CPU.
  9. train    ControlLoRATrainer.train_step on full-width SD1.5 + `base` at 512²,
              batch 8 of fill50k, bf16 frozen stack, no remat: 2 warm-up and 5
              timed steps, exact launches per step (K2-K4), finite loss, nonzero
              gradient, params updated; ms/step, img/s, peak memory, one profiled step.
 10. modes    the render modes and sampling entry points at full width (seeded bf16
              weights, the `base` ControlLoRA, STEPS steps, CFG 9), each render's
              launches held exactly to the counts derived from the configs and its
              device busy time profiled: SD1.5 512² with a rank-4 LoRA chained before
              the ControlLoRA (threaded: K2 in the long self-attentions), img2img and
              inpaint at strength 0.8, the hires fix 512² -> 1024² at 0.55 (K1 at
              D 40 and 80); the threaded eval against an fp32 copy with every
              attention plain and a zero-up chain (K2) against the folded eval (K1);
              inpaint's unmasked latents equal to the init's; the SDXL 1024² base
              [0, 8) -> refiner [8, 10) ensemble through `controllora_tpu_torch.
              sample`'s main in this process; `python -m controllora_tpu_torch.
              mix_lora` from a .safetensors LoRA written by the port. (The new K1/K2
              shapes are checked and timed in phase 3; the refiner's unguided eval
              against fp32 in phase 14.)
 11. entry    `python -m controllora_tpu_torch.train` for 2 steps at 512² batch 8, a
              subprocess that runs while phase 13's run in turn (then phase 12 runs
              alone); its artifact loads back into the port's ControlLoRA strictly.
 12. stock train  the K5 path: the same CLI in this process under
              CONTROLLORA_FLASH_IMPL=stock at 512² batch 16 with remat `dots`: 2
              warm-up and 3 timed steps, exact K5 launches per step, ms/step, peak
              memory, the native data plane reported by the CLI (and the host's time
              to make a batch in Python and in C); then 2 steps each of remat
              `nothing` and no remat.
 13. CLI smoke  the smoke-variant CLI with 8-bit AdamW, remat, checkpoints and the
              latent cache: 4 steps straight against 2 + resume latest for 2.
 14. families  SD2.1 (768², v-prediction DPM-Solver++) and SDXL (1024², dual text
              towers, text_time) at full width on seeded random bf16 weights with the
              `base` ControlLoRA re-derived per family, and the SDXL refiner's UNet
              (their kernel shapes are checked in phase 3): per family a folded CFG
              UNet eval, the text encoder and a VAE decode on the
              card in bf16 (kernels) against an fp32 copy on the card with every
              attention plain; a ToMe 0.5 eval with K1 against its plain version on
              one set of merge maps (within 2x the exact eval's gap); guided
              renders through the BatchingEngine under exact, tome and turbo with
              exact launches (derived from the configs: SD2.1 {k1 100, k2 1} and
              {75, 1} under turbo, SDXL {100, 1} and {50, 1}) and a profiled
              render each; `python -m controllora_tpu_torch.serve --model_variant
              sdxl` answering one 1024² /generate with a PNG guide; the refiner's UNet
              (5 ids) and text tower against fp32 and its unguided eval (K2) as the
              ensemble runs it (its fp32 server runs in phase 22).
 15. family train  SD2.1 (768², batch 4, no remat, v-prediction) and SDXL (1024², batch
              2, remat dots, text_time) ControlLoRA training at full width on seeded
              random bf16 weights with `base` re-derived (K2-K4 at their D 64 and VAE
              shapes are checked and timed in phase 3): per family one train step's loss
              and adapter gradient against an fp32 copy on the card with every attention
              plain; 2 warm-up and 3 timed steps on native fill50k batches with exact
              launches per step (from the configs: K2 per long self-attention, again per
              remat recompute, once in the VAE encoder; K3 and K4 per long
              self-attention), peak memory and one profiled step.
 16. train CLI  `python -m controllora_tpu_torch.train --model_variant sdxl --resolution
              1024` for 3 steps with --validation_steps 2 --report_to jsonl: the metrics
              lines, the validation montage PNG, the native data plane.
 17. dreambooth  `python -m controllora_tpu_torch.train_dreambooth` on SD1.5 at 512² with
              prior preservation (2 class images sampled by the frozen stack), 3 steps
              with exact launches, validation renders, the .safetensors and .bin LoRA
              equal to the trained one bit for bit.
 18. weights  the real-weights path at full width: the seeded bf16 SD1.5 stack written
              as a diffusers-layout F16 checkpoint directory (unet/, vae/,
              text_encoder/; about 2 GiB) with a small CLIP BPE vocab in
              CLIP_VOCAB_DIR; zoo.load_frozen onto the card (every tensor bitwise the
              F16 source cast to bf16; seconds, peak GiB); one guided 512² render
              through the loaded stack bitwise equal to the in-memory stack's cast the
              same way, launches exactly {k1 50, k2 1} each; the Canny annotator on
              the card equal to the CPU's at 512² and 1024², three threshold pairs (ms
              an image); the canny2image web UI answering one POST /api with a 512²
              PNG ({k1 50, k2 1}); `python -m controllora_tpu_torch.tasks train_canny`
              (3 steps, batch 1, diffusiondb_canny's Canny on the card, K2-K4) and
              `tasks test_canny` on its output beside convert_checkpoint import-sd,
              export-controllora (its artifact equal to the run's) and
              import-controllora, each a subprocess that must exit 0.
 19. annotators  OpenPose (body at detect_resolution 512, the hand net at its four
              scales), HED and MLSD at 512², MiDaS at 384² and 512², UniFormer at 512²,
              each from a seeded state dict in its checkpoint's key names, against the
              same detector on the CPU (raw maps within 1e-3 relative max error; the
              decoded peaks, centres and labels and the uint8 maps equal, or differing
              only at near-ties and level boundaries, counted), ms an image; the
              pose2image web UI answering one POST /api at 512² with the app's defaults
              (30 steps, CFG 9): exact launches {k1 150, k2 1}, wall and device busy
              time, the PNGs written.
 20. parallel  (run after "modes") the serving mesh and data-parallel training: 4 rank
              processes share cuda:0 over gloo (NCCL takes one card a rank; the
              kernels are built by this process first), each with the seeded SD1.5
              stack and `base` ControlLoRA: (a) the guided 512² render (STEPS steps,
              CFG 9) on a cfg,model=2 mesh, each rank's image against this process's
              1-process render (relative L2 <= 5e-2) with launches exactly {k1 50,
              k2 1} and K1 at (1, 4, 4096, 40); (b) two images on data,cfg (K1 at
              (1, 8, 4096, 40)); (c) a dp train step at global batch 8 on ranks 0 and
              1, the loss and all-reduced gradient against a 1-process batch-8 step
              on the same draws, {k2 6, k3 5, k4 5} a rank, parameters bitwise equal
              across ranks; (d) `python -m torch.distributed.run --nproc_per_node 2 -m
              controllora_tpu_torch.sample --serving_mesh cfg --dist_backend gloo`,
              rank 0 alone writing. The new kernel shapes are checked and timed in
              phase 3 (phase_parallel_kernels). One line "parallel: {...}".
 21. eval presets  `python -m controllora_tpu_torch.eval_presets --train_steps 100` on the
              card: the smoke ControlLoRA trained at 64², 6 specs rendered under exact,
              tome50, dc2 and turbo, the report (the JAX script's keys) printed; no
              kernel launches at 64².
 22. fp32     (run after "CLI smoke") the fp32 stacks end to end on the kernels' fp32
              route: `python -m controllora_tpu_torch.train --mixed_precision no` on
              SD1.5 at 512², batch 8, remat dots, 3 steps, then 1 step under
              CONTROLLORA_FLASH_IMPL=stock (K5); one step's adapter gradient on the
              kernels against plain attention (relative 1e-4); the smoke stack's train
              step and sample CLI at 512²; the refiner's unguided eval in fp32 against
              plain attention and `serve --model_variant sdxl-refiner --warmup` (fp32, as
              scripts/serve.py serves it) answering one unguided 1024² request, {k1 0,
              k2 401}. Every launch exact and on the fp32 route.
The last lines are the kernel record (each route with the CUDA kernel it launches, and
under "fp32" its fp32 route's kernels, launches and times),
the card's name and power limit, and {"ok": true, "device": {...}}.
``python3 chip_smoke.py --cards`` on a host with 4 cards runs only phase 20, one rank
a card over nccl.
"""

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

O_BOUND, LSE_BOUND, GRAD_BOUND, REL_BOUND = 1e-2, 1e-3, 1e-2, 5e-2
# K1 has no LSE output to check: its max|dO| is also held to this share of max|ref|,
# which keeps the check sharp at long L, where O shrinks as 1/sqrt(L) (at L 16384 a
# typical |O| is near O_BOUND itself)
K1_SCALED_BOUND = 2e-2
# a ToMe eval's K1-vs-plain gap, on shared merge maps, within this many times the
# exact eval's (the bf16 noise of the same five self-attentions), and each merged
# self-attention's own gap (relative L2) within TOME_LAYER_BOUND
TOME_NOISE_FACTOR, TOME_LAYER_BOUND = 2, 1e-2
# H100 SXM peaks (NVIDIA data sheet): bf16 dense tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# a render's steps (20 until PR 14) and the timed train steps (5 until PR 14): the
# paths' depth, cut to keep the script inside its time as it grew (PERF.md, PR 15)
STEPS, CFG, RES = 10, 9.0, 512
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 3
TRAIN_LAUNCHES = {"k1": 0, "k2": 6, "k3": 5, "k4": 5}  # per step: 5 UNet + 1 VAE
# the K5 path (CONTROLLORA_FLASH_IMPL=stock), batch 16, launches per step by remat
# policy: 5 UNet self-attentions at L 4096, 5 more where the remat recomputes them,
# 1 in the VAE encoder
STOCK_BATCH = 16
_K5 = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5_dkv": 5, "k5_dq": 5}
STOCK_LAUNCHES = {"dots": dict(_K5, k5_fwd=11), "nothing": dict(_K5, k5_fwd=11),
                  None: dict(_K5, k5_fwd=6)}
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


def device_ms(fn, iters=10, floor_ms=None):
    """Mean device milliseconds of fn() over `iters` runs under torch.profiler: the
    summed durations of the kernels and memory operations it issued. CUDA events
    around one call (cuda_ms) also take in the host's time to issue the call, which
    a sub-millisecond kernel does not hide; this time leaves it out. Where a window
    records no device activity, or less than `floor_ms` a call (the least time the
    card could take, so the profiler lost events), one more window of 3 * iters
    calls is profiled; None if that fails too (logged with the names the profiler
    did record)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for n in (iters, 3 * iters):
        _, busy, top = device_profile(torch, lambda: [fn() for _ in range(n)])
        if busy > 0 and (floor_ms is None or busy * 1e3 / n >= floor_ms):
            return busy * 1e3 / n
        if busy > 0:
            log(f"  device_ms: {busy * 1e3 / n:.4f} ms a call over {n} profiled calls is "
                f"under the {floor_ms:.4f} ms bound: the profiler lost events")
    log(f"  device_ms: not measured in {iters} + {3 * iters} profiled calls; "
        f"events recorded: {sorted(top)[:8]}")
    return None


def num(ms):
    """A time for the log: 4 decimals, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def rel_l2(out, ref):
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).norm() / ref.norm())


def roofline(flops, nbytes):
    """The least time the card could take: the larger of the operations over the
    bf16 peak and the bytes (each input read once, each output written once) over
    the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def attention_roofline(products, b, h, lq, lk, d, bf16_q, bf16_k, fp32_rows):
    """roofline() of an attention kernel: `products` L x L x D products per head
    (2 flops each); bf16_q / bf16_k tensors of the query / key length read or
    written (B x L x H*D bf16 each); fp32_rows fp32 values per query row and head
    (LSE, Dcap, m, l, di)."""
    flops = 2 * products * b * h * lq * lk * d
    nbytes = 2 * b * h * d * (bf16_q * lq + bf16_k * lk) + 4 * fp32_rows * b * h * lq
    return roofline(flops, nbytes)


def sdpa_ms(torch, q, k, v, scale=None, do=None, floor_ms=None):
    """Time of one torch scaled_dot_product_attention call on (B, H, L, D) inputs
    (the library yardstick; the port never calls it): the forward, or with `do` the
    backward of one call, which gives dq, dk and dv together. Every fused backend that
    takes the inputs (flash, efficient, cudnn) is timed, math only where none does,
    by CUDA events (cuda_ms) and by device time (device_ms); returns
    {"library_ms", "library_backend"} of the fastest by events,
    {"library_device_ms", "library_device_backend"} of the fastest by device time,
    and "library_backends": {backend: [ms, device ms]}. `floor_ms` (the bound)
    goes to device_ms."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times, device = {}, {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and times:
            break
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                if do is None:
                    def fn():
                        return sdpa(q, k, v, scale=scale)
                else:
                    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                    out = sdpa(qq, kk, vv, scale=scale)

                    def fn():
                        return torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True)
                fn()
                torch.cuda.synchronize()
                times[backend.name] = cuda_ms(fn)
                device[backend.name] = device_ms(fn, floor_ms=floor_ms)
        except RuntimeError:
            continue
        finally:
            fn = out = None
    if not times:
        return {"library_ms": None, "library_backend": None, "library_device_ms": None,
                "library_device_backend": None, "library_backends": {}}
    best = min(times, key=times.get)
    measured = {name: ms for name, ms in device.items() if ms is not None}
    best_device = min(measured, key=measured.get) if measured else None
    return {"library_ms": times[best], "library_backend": best,
            "library_device_ms": measured.get(best_device), "library_device_backend": best_device,
            "library_backends": {name: [times[name], device[name]] for name in times}}


def fmt_sdpa(library):
    """The fastest SDPA backend's time and name, then every backend's time (events /
    device)."""
    if library["library_ms"] is None:
        return "none ran"
    each = ", ".join(f"{name.split('_')[0].lower()} {ms:.4f} / {num(dms)}"
                     for name, (ms, dms) in library["library_backends"].items())
    return (f"{library['library_ms']:.4f} ms ({library['library_backend']}), device "
            f"{num(library['library_device_ms'])} ms ({library['library_device_backend']}); "
            f"events / device: {each}")


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


def kernel_label(mangled):
    """`flash_fwd_kernel<48,64,3,0>` from a mangled kernel name (the identifier that
    ends in `_kernel`, with its integer template arguments)."""
    import re

    for start in range(len(mangled)):  # the length prefix may follow a hash's digits
        m = re.match(r"\d+", mangled[start:])
        if m is None:
            continue
        n, end = int(m.group()), start + m.end()
        ident = mangled[end:end + n]
        if len(ident) == n and ident.endswith("_kernel"):
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end + n:])
            return ident + (f"<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
                            if args else "")
    return mangled


def ptxas_report(fa):
    """The `-Xptxas -v` reports the build keeps beside its objects, one dict per
    kernel instance: its source, label, registers, spill bytes and whether ptxas
    serialised its wgmma (warning C7512). Empty where the library was built by an
    earlier run."""
    import glob
    import re

    entries = []
    pattern = str(fa.BUILD_DIR / f"{fa.library_path().stem}.*.o.log")
    for path in sorted(glob.glob(pattern)):
        text = open(path).read()
        serialised = set(re.findall(r"C7512\).*?function '(\S+?)'", text))
        for name, stores, loads, regs in re.findall(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, (\d+) bytes "
                r"spill loads.*?Used (\d+) registers", text, re.S):
            entries.append(dict(source=os.path.basename(path).split('.')[-3],
                                kernel=kernel_label(name), registers=int(regs),
                                spill_stores=int(stores), spill_loads=int(loads),
                                serialised=name in serialised))
    return entries


def ptxas_line(e):
    return (f"{e['source']}: {e['kernel']} {e['registers']} registers, spill stores "
            f"{e['spill_stores']} B, loads {e['spill_loads']} B"
            + (", wgmma serialised" if e["serialised"] else ""))


def shape_entry(shape, ms, dms, pms, bound, library):
    """One main-path shape of a kernel in the kernel record."""
    return dict(shape=list(shape), ms=ms, device_ms=dms, plain_ms=pms, **bound, **library)


def k1_error(torch, out, ref, tag):
    """K1's max|dO| against its fp32 plain version `ref`, held to the smaller of
    O_BOUND and K1_SCALED_BOUND * max|ref|; returns (error, tolerance) or raises."""
    err = (out.float() - ref).abs().max().item()
    tol = min(O_BOUND, K1_SCALED_BOUND * ref.abs().max().item())
    if not (out.shape == ref.shape and torch.isfinite(out).all() and err <= tol):
        raise AssertionError(f"{tag}: max|dO| {err} > {tol} (O_BOUND {O_BOUND}, "
                             f"{K1_SCALED_BOUND} * max|ref|)")
    return err, tol


def k1_case(torch, fa, rnd, record, b, h, l, d, bc, timed, label=""):
    """K1 at (B, H, L, D) with biases of batch Bc against its plain version; with
    `timed`, the kernel's time (events and device), the plain version's, the bound
    and SDPA on the biased q/k/v, appended to record["k1"]["shapes"]. Returns the
    entry (None untimed)."""
    from controllora_tpu_torch.ops.attention import split_heads

    q, k, v = rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
    qb, kb, vb = (0.25 * rnd(bc, l, h * d) for _ in range(3))
    out = fa.biased_attention(q, k, v, h, qb, kb, vb)
    torch.cuda.synchronize()
    ref = plain_fp32(fa, q, k, v, h, qb, kb, vb)
    err, tol = k1_error(torch, out, ref, f"K1 B{b} H{h} L{l} D{d} Bc{bc}")
    del ref
    line = (f"K1{label} B={b} H={h} L={l} D={d} (biases batch {bc} -> {b}): "
            f"max|dO| {err:.3e} <= {tol:.3e}")
    record["k1"]["max_abs_err"] = max(record["k1"]["max_abs_err"], err)
    entry = None
    if timed:
        bound = attention_roofline(2, b, h, l, l, d, 2 + bc / b, 2 + 2 * bc / b, 0)
        ms = cuda_ms(lambda: fa.biased_attention(q, k, v, h, qb, kb, vb))
        dms = device_ms(lambda: fa.biased_attention(q, k, v, h, qb, kb, vb),
                        floor_ms=bound["bound_ms"])
        pms = cuda_ms(lambda: fa.biased_attention_plain(q, k, v, h, qb, kb, vb))
        biased = [split_heads(x + xb.repeat(b // bc, 1, 1), h)
                  for x, xb in ((q, qb), (k, kb), (v, vb))]
        library = sdpa_ms(torch, *biased, floor_ms=bound["bound_ms"])
        del biased
        entry = shape_entry((b, h, l, d, bc), ms, dms, pms, bound, library)
        if label:
            entry["path"] = label.strip(" ()")
        record["k1"]["shapes"].append(entry)
        line += (f"  kernel {ms:.4f} ms (device {num(dms)})  plain {pms:.4f} ms  bound "
                 f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}  SDPA on the biased "
                 f"q/k/v {fmt_sdpa(library)}")
    log(line)
    return entry


def k2_case(torch, fa, device, rnd, record, b, h, l, d, label=""):
    """K2 at (B, H, L, D) against its plain version (O and LSE), timed as k1_case;
    where the plan splits the key range, also the same call in one pass (both held to
    the plain version). Returns the entry appended to record["k2"]["shapes"]."""
    from controllora_tpu_torch.ops.attention import split_heads

    q, k, v = rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
    o, lse = fa.flash_attention(q, k, v, h)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), h)
    err = (o.float() - o_ref).abs().max().item()
    lerr = (lse - lse_ref).abs().max().item()
    if not (torch.isfinite(o).all() and err <= O_BOUND and lerr <= LSE_BOUND):
        raise AssertionError(f"K2 B{b} H{h} L{l} D{d}: max|dO| {err}, max|dLSE| {lerr}")
    line = (f"K2{label} B={b} H={h} L={l} D={d}: max|dO| {err:.3e} <= {O_BOUND}, "
            f"max|dLSE| {lerr:.3e} <= {LSE_BOUND}")
    bound = attention_roofline(2, b, h, l, l, d, 2, 2, 1)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, h))
    dms = device_ms(lambda: fa.flash_attention(q, k, v, h), floor_ms=bound["bound_ms"])
    pms = cuda_ms(lambda: fa.attention_lse_plain(q, k, v, h))
    library = sdpa_ms(torch, *(split_heads(x, h) for x in (q, k, v)),
                      floor_ms=bound["bound_ms"])
    line += (f"  kernel {ms:.4f} ms (device {num(dms)})  plain {pms:.4f} ms  bound "
             f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}  SDPA {fmt_sdpa(library)}")
    entry = shape_entry((b, h, l, d), ms, dms, pms, bound, library)
    if label:
        entry["path"] = label.strip(" ()")
    splits = fa.kv_splits(b * h, l, l, fa.fwd_tiles(d),
                          torch.cuda.get_device_properties(device).multi_processor_count)
    if splits > 1:  # the same call with the key range in one pass, for its gain
        plan, fa.kv_splits = fa.kv_splits, lambda *args: 1
        try:
            o_one, lse_one = fa.flash_attention(q, k, v, h)
            one_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, h))
            one_dms = device_ms(lambda: fa.flash_attention(q, k, v, h),
                                floor_ms=bound["bound_ms"])
        finally:
            fa.kv_splits = plan
        oerr = (o_one.float() - o_ref).abs().max().item()
        lerr1 = (lse_one - lse_ref).abs().max().item()
        if not (oerr <= O_BOUND and lerr1 <= LSE_BOUND):
            raise AssertionError(f"K2 B{b} H{h} L{l} D{d} in one pass: max|dO| {oerr}, "
                                 f"max|dLSE| {lerr1}")
        entry.update(splits=splits, one_pass_ms=one_ms, one_pass_device_ms=one_dms)
        line += (f"\n  {splits} key splits {ms:.4f} ms (device {num(dms)}), one pass "
                 f"{one_ms:.4f} ms (device {num(one_dms)}; max|dO| {oerr:.3e}, max|dLSE| "
                 f"{lerr1:.3e})")
    record["k2"]["shapes"].append(entry)
    record["k2"]["max_abs_err"] = max(record["k2"]["max_abs_err"], err)
    log(line)
    return entry


def phase_kernels(torch, fa, device):
    """K1/K2 vs plain; returns {kernel: {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by", "library_ms", "library_backend", "shapes"}}: the top-level numbers are
    those of K1's batch-1 render shape and K2's VAE shape; "shapes" holds every
    main-path shape's time, plain time, bound and SDPA time."""
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    record = {"k1": {"max_abs_err": 0.0, "shapes": []}, "k2": {"max_abs_err": 0.0, "shapes": []}}
    # K1: (B, heads, L, D, bias batch Bc). The main path gives the first two: the
    # 512² batch-1 render (one guide under the CFG pair) and the batch-4 render
    # (per-image biases, every row different, tiled over the 8-row CFG batch).
    for b, h, l, d, bc in ((2, 8, 4096, 40, 1), (8, 8, 4096, 40, 4),
                           (2, 8, 2304, 80, 1), (2, 8, 7744, 40, 1)):
        entry = k1_case(torch, fa, rnd, record, b, h, l, d, bc, timed=(l, d) == (4096, 40))
        if entry is not None and b == 2:
            record["k1"].update({k: v for k, v in entry.items() if k != "shape"})
    # K2: the VAE mid-attention of serving at batch 1 and 4 (the batch-4 render decodes
    # its 4 latents in one call) and the unguided UNet self-attention (batch 1), then
    # the training path's (batch 8): UNet self-attention and VAE encoder
    for b, h, l, d in ((1, 1, 4096, 512), (4, 1, 4096, 512), (2, 8, 4096, 40),
                       (8, 8, 4096, 40), (8, 1, 4096, 512)):
        entry = k2_case(torch, fa, device, rnd, record, b, h, l, d)
        if (b, d) == (1, 512):
            record["k2"].update({k: v for k, v in entry.items()
                                 if k not in ("shape", "splits", "one_pass_ms",
                                              "one_pass_device_ms")})
    return record


def base_control(torch, unet_config, device, gen):
    """The `base` ControlLoRA re-derived for a UNet family, every parameter +0.01
    (fresh `up` factors are zero: the fold would be a no-op)."""
    from controllora_tpu_torch.config import get_preset
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.models.control_lora import config_for_unet

    control = zoo.build_control_lora(config_for_unet(get_preset("base"), unet_config),
                                     device, gen)
    with torch.no_grad():
        for p in control.parameters():
            p.add_(0.01)
    return control


def build_stack(torch, device, variant="sd15", scheduler=None, dtype=None):
    """A full-width stack of `variant` with seeded random weights (bf16 unless `dtype`
    says otherwise) and the re-derived `base` ControlLoRA, as a pipeline."""
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline

    gen = torch.Generator(device=device).manual_seed(0)
    unet, vae, text = zoo.build_models(variant, dtype or torch.bfloat16, device, gen)
    control = base_control(torch, unet.config, device, gen)
    return StableDiffusionControlLoRAPipeline(unet, vae, text, HashTokenizer(), control,
                                              scheduler=scheduler, device=device)


def cpu_copy(torch, module, cls, config):
    from controllora_tpu_torch.models import zoo

    copy = zoo.materialize(cls, config, torch.device("cpu"), None, torch.float32)
    copy.load_state_dict(module.state_dict())
    return copy


def fp32_copy(torch, module, device):
    """An fp32 copy of `module` (of any of the port's model classes) on `device`."""
    from controllora_tpu_torch.models import zoo

    copy = zoo.materialize(type(module), module.config, device, None, torch.float32)
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


def phase_merged_kernels(torch, fa, device, record):
    """K1 and K2 on the 2048-token level ToMe 0.5 leaves of the 4096 at 512², against
    their plain versions, with times, bounds and SDPA, added to `record`'s shapes. K1's
    biases are merged per CFG row, so their batch is the full batch (bc = B)."""
    from controllora_tpu_torch.ops.attention import split_heads

    gen = torch.Generator(device=device).manual_seed(10)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    for name, (b, h, l, d) in (("k1", (2, 8, 2048, 40)), ("k1", (8, 8, 2048, 40)),
                               ("k2", (2, 8, 2048, 40))):
        q, k, v = rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        if name == "k1":
            qb, kb, vb = (0.25 * rnd(b, l, h * d) for _ in range(3))
            args = (q, k, v, h, qb, kb, vb)
            out = fa.biased_attention(*args)
            ref = plain_fp32(fa, *args)
            kernel, plain = (lambda: fa.biased_attention(*args),
                             lambda: fa.biased_attention_plain(*args))
            bound = attention_roofline(2, b, h, l, l, d, 3, 4, 0)
            library = sdpa_ms(torch, *(split_heads(x + xb, h)
                                       for x, xb in ((q, qb), (k, kb), (v, vb))))
            tag, shape = f"K1 B={b} H={h} L={l} D={d} (biases batch {b}, merged)", (b, h, l, d, b)
        else:
            out, lse = fa.flash_attention(q, k, v, h)
            ref, lse_ref = fa.attention_lse_plain(q.float(), k.float(), v.float(), h)
            if not (lse - lse_ref).abs().max().item() <= LSE_BOUND:
                raise AssertionError(f"K2 B{b} L{l}: LSE off by more than {LSE_BOUND}")
            kernel, plain = (lambda: fa.flash_attention(q, k, v, h),
                             lambda: fa.attention_lse_plain(q, k, v, h))
            bound = attention_roofline(2, b, h, l, l, d, 2, 2, 1)
            library = sdpa_ms(torch, *(split_heads(x, h) for x in (q, k, v)))
            tag, shape = f"K2 B={b} H={h} L={l} D={d} (unguided, merged)", (b, h, l, d)
        torch.cuda.synchronize()
        if name == "k1":
            err, tol = k1_error(torch, out, ref, tag)
        else:
            err, tol = (out.float() - ref).abs().max().item(), O_BOUND
            if not (out.shape == ref.shape and torch.isfinite(out).all() and err <= tol):
                raise AssertionError(f"{tag}: max|dO| {err} > {tol}")
        ms, dms, pms = cuda_ms(kernel), device_ms(kernel), cuda_ms(plain)
        splits = fa.kv_splits(b * h, l, l, fa.fwd_tiles(d), sms)
        record[name]["shapes"].append(dict(shape_entry(shape, ms, dms, pms, bound, library),
                                           splits=splits))
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
        log(f"{tag}: max|dO| {err:.3e} <= {tol:.3e}; {splits} key split(s) on {sms} SMs  "
            f"kernel {ms:.4f} ms (device {num(dms)}, {bound['bound_ms'] / dms * 100 if dms else 0:.1f}% "
            f"of bound)  plain {pms:.4f} ms  bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']}  SDPA {fmt_sdpa(library)}")
        del q, k, v, out, ref


def tome_shared_maps(fa, net, weights, unet, tome_kw):
    """K1 against its plain version inside a ToMe UNet eval, both evals on the same
    merge maps: the eval with K1 records each block's maps and the eval with the
    plain version replays them in order. (A later block's merge reads the block input,
    which depends on the earlier attention outputs, so two evals that built their own
    maps could move a whole token on a near-tie.) Also the exact eval with the plain
    version, whose gap to the exact eval with K1 is the bf16 noise of the same
    self-attentions unmerged, and each merged self-attention on its own, on the
    inputs the eval with K1 gave it (under ``weights``, the folded parameters).
    ``unet(**kw)`` runs ``net``. Returns (with K1, with plain, exact with plain,
    relative L2 of each merged self-attention, number of merges)."""
    from torch.func import functional_call

    from controllora_tpu_torch.ops import tome as tome_ops

    maps, layers, real_build = [], [], tome_ops.build_merge

    def recording(*a, **k):
        maps.append(real_build(*a, **k))
        return maps[-1]

    def keep_merged(module, a, out):  # each merge is followed by its block's attn1
        if len(layers) < len(maps):
            layers.append((module, a, out))

    names = {m: n for n, m in net.named_modules()}
    hooks = [m.register_forward_hook(keep_merged) for m, n in names.items()
             if n.endswith(".attn1")]
    tome_ops.build_merge = recording
    try:
        with_kernel = unet(**tome_kw)
    finally:
        tome_ops.build_merge = real_build
        for hook in hooks:
            hook.remove()
    if len(layers) != len(maps):
        raise AssertionError(f"{len(maps)} merges but {len(layers)} merged attn1 calls")
    replay = iter(maps)
    kernel, fa.biased_attention = fa.biased_attention, fa.biased_attention_plain
    tome_ops.build_merge = lambda *a, **k: next(replay)
    try:
        with_plain = unet(**tome_kw)
        exact_plain = unet()
        layer_errs = []
        for module, a, out in layers:
            prefix = names[module] + "."
            own = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
            layer_errs.append(rel_l2(out, functional_call(module, own, a)))
    finally:
        fa.biased_attention, tome_ops.build_merge = kernel, real_build
    return with_kernel, with_plain, exact_plain, layer_errs, len(maps)


def folded_eval(torch, pipe, guide, lat, res):
    """(weights, unet): the folded weights of `pipe`'s ControlLoRA for `guide` (1, 3,
    res, res) and unet(**kw), one guided CFG UNet eval of `lat` (2, 4, res/8, res/8)
    at timestep 500 with the bf16 folded biases (and, for a text_time UNet, the pooled
    prompt and the size ids of `res`), under ``torch.func.functional_call``."""
    from torch.func import functional_call

    from controllora_tpu_torch.ops.folding import fold_adapters

    weights, biases = fold_adapters(pipe.unet, pipe.control_lora.adapters_for(
        guide, pipe.unet.config))
    biases = {k: b.to(torch.bfloat16) for k, b in biases.items()}
    enc = pipe.encode_prompt("a photo")
    ctx, pooled = enc if isinstance(enc, tuple) else (enc, None)
    added = {} if pooled is None else dict(
        added_text_embeds=pooled, added_time_ids=pipe.text_time_ids(pooled, res, res, 6.0, 2.5))
    args = (lat, torch.full((lat.shape[0],), 500.0, device=lat.device), ctx)

    def unet(**kw):
        return functional_call(pipe.unet, weights, args, dict(kw, biases=biases, **added))

    return weights, unet


def merges_per_eval(unet_config, res, tome_ratio=0.5):
    """The self-attentions ToMe merges in one UNet eval at `res` (ToMeConfig's default
    min_tokens: the grids of at least 4096 tokens that tile its window)."""
    from controllora_tpu_torch.models.unet import attention_processor_names, processor_bucket
    from controllora_tpu_torch.ops.tome import ToMeConfig, maybe_tome

    n, side = len(unet_config.block_out_channels), res // 8
    return sum(".attn1." in name and maybe_tome(ToMeConfig(ratio=tome_ratio),
                                                side >> processor_bucket(name, n),
                                                side >> processor_bucket(name, n))
               for name in attention_processor_names(unet_config))


def tome_check(torch, fa, pipe, weights, unet, res, label):
    """A ToMe 0.5 eval (``unet`` of folded_eval) with K1 against the same eval, on the
    same merge maps, with K1's plain version (tome_shared_maps): within
    TOME_NOISE_FACTOR x the exact eval's K1-vs-plain gap (and REL_BOUND), each merged
    self-attention within TOME_LAYER_BOUND; K1 launched k1_per_eval(..., 0.5) times and
    merges_per_eval maps built."""
    from controllora_tpu_torch.ops.tome import ToMeConfig

    cfg = pipe.unet.config
    plain = unet()
    tome_kw = dict(tome=ToMeConfig(ratio=0.5), tome_step=(0, 500, 3))
    before = fa.LAUNCHES["k1"]
    with_kernel, with_plain, exact_plain, layer_errs, n_maps = tome_shared_maps(
        fa, pipe.unet, weights, unet, tome_kw)
    used = fa.LAUNCHES["k1"] - before
    want = (k1_per_eval(cfg, res, tome_ratio=0.5), merges_per_eval(cfg, res))
    if (used, n_maps) != want:
        raise AssertionError(f"{label} ToMe eval: K1 launched {used} times, {n_maps} merges; "
                             f"expected {want}")
    tome_err, noise = rel_l2(with_kernel, with_plain), rel_l2(plain, exact_plain)
    tome_bound = min(REL_BOUND, TOME_NOISE_FACTOR * noise)
    log(f"{label} ToMe 0.5 merged self-attentions on the ToMe eval's own inputs, K1 vs its "
        f"plain version: relative L2 {', '.join(f'{e:.4e}' for e in layer_errs)} <= "
        f"{TOME_LAYER_BOUND}")
    log(f"{label} ToMe 0.5 UNet eval ({n_maps} merged self-attentions, biases batch 2, one "
        f"set of merge maps; K1 {used} times) with K1 vs with K1's plain version: relative "
        f"L2 {tome_err:.4e} <= {tome_bound:.4e} ({TOME_NOISE_FACTOR}x the exact eval's K1 "
        f"vs plain {noise:.4e}); vs the exact eval {rel_l2(with_kernel, plain):.4e}")
    if not (torch.isfinite(with_kernel).all() and tome_err <= tome_bound
            and max(layer_errs) <= TOME_LAYER_BOUND):
        raise AssertionError(f"{label} ToMe eval with K1 off its plain version by "
                             f"{tome_err}, its merged layers by {layer_errs}")
    return plain


PRESETS = {"exact": {}, "tome": {"tome_ratio": 0.5},
           "turbo": {"tome_ratio": 0.5, "deepcache_interval": 2}}
GUIDED_LAUNCHES = {"k1": 5 * STEPS, "k2": 1, "k3": 0, "k4": 0}
UNGUIDED_LAUNCHES = {"k1": 0, "k2": 5 * STEPS + 1, "k3": 0, "k4": 0}


def phase_presets(torch, fa, pipe, device, card):
    """The serving deployment's speed presets and samplers at full width. First the
    checks beside the main path: shallow(cache_of(full)) equals full on the card, and
    a ToMe UNet eval with K1 against the same eval, on the same merge maps, with K1's
    plain version. Then the main path, its launches counted from 0: guided 512²
    renders through the BatchingEngine at bucket 1 and 4 under exact, tome and turbo
    (turbo: 10 full and 10 shallow UNet evals), an unguided tome render, one guided
    render with each of DDIM, PNDM, Euler and UniPC, and the HTTP server (turbo,
    buckets 1 and 4, --warmup) answering 4 concurrent /generate requests. Returns the
    launch counts."""
    import base64
    import threading
    import urllib.request

    import numpy as np

    from controllora_tpu_torch import schedulers, serve
    from controllora_tpu_torch.ops.tome import ToMeConfig, build_merge, window_choice
    from controllora_tpu_torch.serving import BatchingEngine
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    rng = np.random.default_rng(12)
    guides = [rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32) for _ in range(4)]
    with torch.inference_mode():
        lat = torch.from_numpy(rng.normal(size=(2, 4, RES // 8, RES // 8))
                               .astype(np.float32)).to(device)
        weights, unet = folded_eval(torch, pipe, torch.from_numpy(guides[0]).permute(
            2, 0, 1)[None].to(device), lat, RES)
        plain = tome_check(torch, fa, pipe, weights, unet, RES, f"SD1.5 {RES}²")
        full, cache = unet(deepcache="full")
        shallow = unet(deepcache="shallow", deepcache_feat=cache)
        dc_err = max((full - plain).abs().max().item(), (shallow - full).abs().max().item())
        log(f"DeepCache at full width on the card: full == plain eval and "
            f"shallow(cache_of(full)) == full: max|d| {dc_err:.3e} (must be 0); cache "
            f"{tuple(cache.shape)}")
        if dc_err != 0:
            raise AssertionError(f"DeepCache: shallow or full eval differs by {dc_err}")
        del weights, unet, plain, full, cache, shallow

        x = torch.randn((2, 4096, 320), device=device).to(torch.bfloat16)

        def merge_once():  # one block's ToMe bookkeeping at the batch-1 render's level 0
            merge, unmerge, _ = build_merge(x, 64, 64, ToMeConfig(ratio=0.5),
                                            window_choice(0, 500, 3, "p", 0, 32, 32))
            return unmerge(merge(x))

        merge_once()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            merge_once()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        log(f"ToMe window draw + build_merge + merge + unmerge at (2, 4096, 320): host "
            f"{host_ms:.3f} ms a call to issue, device {num(device_ms(merge_once))} ms "
            f"(100 a render)")
        for kw in PRESETS.values():  # first calls of the new code paths, before timing
            pipe("warm up", guide=guides[0], num_inference_steps=2, **kw)

    evals = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda module, a, kw: evals.append(kw.get("deepcache")), with_kwargs=True)
    common = dict(num_inference_steps=STEPS, guidance_scale=CFG, height=RES, width=RES,
                  return_array=True)

    def check(name, images, per_call, want, n):
        if per_call != want:
            raise AssertionError(f"{name}: launches {per_call}, expected {want}")
        if len(images) != n or any(img.shape != (RES, RES, 3) or not np.isfinite(img).all()
                                   for img in images):
            raise AssertionError(f"{name}: bad images {[img.shape for img in images]}")

    walls = []
    fa.reset_launch_counts()  # the presets' main path starts here
    try:
        for preset, kw in PRESETS.items():
            eng = BatchingEngine(pipe, max_wait_ms=100.0, buckets=(1, 4), pipe_kwargs=kw)
            try:
                runs = [(1, guides[:1]), (4, guides)]
                if preset == "tome":
                    runs.append((1, [None]))
                for bucket, reqs in runs:
                    before = dict(fa.LAUNCHES)
                    evals.clear()
                    t0 = time.perf_counter()
                    futs = [eng.submit(f"prompt {i}", guide=g, seed=20 + i, **common)
                            for i, g in enumerate(reqs)]
                    images = [f.result(timeout=900) for f in futs]
                    wall = time.perf_counter() - t0
                    per_call = {n: fa.LAUNCHES[n] - before[n] for n in before}
                    guided = reqs[0] is not None
                    name = f"{preset} {'guided' if guided else 'unguided'} batch {bucket}"
                    check(name, images, per_call,
                          GUIDED_LAUNCHES if guided else UNGUIDED_LAUNCHES, bucket)
                    full = sum(e in (None, "full") for e in evals)
                    want = ({"full": STEPS // 2, "shallow": STEPS // 2} if preset == "turbo"
                            else {"full": STEPS, "shallow": 0})
                    if {"full": full, "shallow": evals.count("shallow")} != want:
                        raise AssertionError(f"{name}: UNet evals {evals}, expected {want}")
                    walls.append((name, wall))
                    log(f"preset {name}: {wall:.3f} s wall ({eng.stats['last_batch_seconds']:.3f}"
                        f" s in the pipeline), {bucket / wall:.3f} img/s; launches {per_call}; "
                        f"UNet evals {want}; {card}")
            finally:
                eng.stop()
            if eng.stats["errors"]:
                raise AssertionError(f"preset {preset}: {eng.stats['errors']} failed batches")

        for cls in (schedulers.DDIMScheduler, schedulers.PNDMScheduler,
                    schedulers.EulerDiscreteScheduler, schedulers.UniPCMultistepScheduler):
            dpm, pipe.scheduler = pipe.scheduler, cls()
            try:
                before = dict(fa.LAUNCHES)
                t0 = time.perf_counter()
                images = pipe("a photo", guide=guides[1], **common)
                wall = time.perf_counter() - t0
            finally:
                pipe.scheduler = dpm
            per_call = {n: fa.LAUNCHES[n] - before[n] for n in before}
            check(cls.__name__, images, per_call, GUIDED_LAUNCHES, 1)
            log(f"sampler {cls.__name__}: guided batch 1 {wall:.3f} s, finite "
                f"{RES}x{RES}x3; launches {per_call}")

        with tempfile.TemporaryDirectory() as control_dir:
            save_control_lora(control_dir, pipe.control_lora)
            args = serve.parse_args(["--preset", "turbo", "--buckets", "1,4", "--warmup",
                                     "--host", "127.0.0.1", "--port", "0", "--max_wait_ms",
                                     "500", "--control_lora_dir", control_dir])
            t0 = time.perf_counter()
            spipe = serve.build_pipeline(args)
        eng = BatchingEngine(spipe, max_wait_ms=args.max_wait_ms,
                             buckets=tuple(int(b) for b in args.buckets.split(",")),
                             pipe_kwargs=serve.speed_kwargs(args))
        server = None
        try:
            serve.warmup(eng)
            warm_s = time.perf_counter() - t0
            server = serve.build_server(eng, args.host, args.port, args.result_timeout_s)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{server.server_address[1]}"

            def call(path, payload=None):
                data = None if payload is None else json.dumps(payload).encode()
                with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                            timeout=600) as r:
                    return r.status, r.read()

            if call("/healthz") != (200, b"ok"):
                raise AssertionError("server: /healthz")
            stats0 = json.loads(call("/stats")[1])
            pngs = [base64.b64encode(encode_png(((g + 1) * 127.5).astype(np.uint8))).decode()
                    for g in guides]
            before = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                replies = list(pool.map(lambda i: call("/generate", dict(
                    prompt=f"request {i}", steps=STEPS, seed=i, guide=pngs[i], height=RES,
                    width=RES)), range(4)))
            wall = time.perf_counter() - t0
            per_call = {n: fa.LAUNCHES[n] - before[n] for n in before}
            images = [decode_png(base64.b64decode(json.loads(raw)["image"]))
                      for code, raw in replies if code == 200]
            stats = json.loads(call("/stats")[1])
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
            eng.stop()
        batches4 = stats["batch_sizes"].get("4", 0) - stats0["batch_sizes"].get("4", 0)
        if (len(images) != 4 or any(img.shape != (RES, RES, 3) for img in images)
                or batches4 != 1 or per_call != GUIDED_LAUNCHES or stats["errors"]):
            raise AssertionError(f"server: {len(images)} images, {batches4} new batches of "
                                 f"4, launches {per_call}, stats {stats}")
        log(f"server (python -m controllora_tpu_torch.serve --preset turbo --buckets 1,4 "
            f"--warmup): built and warmed in {warm_s:.1f} s; 4 concurrent /generate with PNG "
            f"guides in {wall:.3f} s, one batch of 4 ({stats['last_batch_seconds']:.3f} s in "
            f"the pipeline), each {RES}x{RES}x3; launches {per_call}; /stats {stats}")
        del spipe
    finally:
        hook.remove()
    total = dict(fa.LAUNCHES)  # the presets' main path ends here
    log("preset render walls (s): " + ", ".join(f"{n} {w:.3f}" for n, w in walls)
        + f"; {card}; main-path launches {total}")
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


def bwd_case(torch, fa, rnd, record, b, h, l, d, timed, label=""):
    """K3/K4 at (B, H, L, D) against their plain versions (fp32 on the same bf16
    inputs, O and LSE from K2); with `timed`, the kernels' times (events and
    device), the plain versions', the bounds and one SDPA backward (dq, dk and dv
    together: the yardstick of K3 + K4), appended to record["k3"/"k4"]["shapes"].
    Returns (K3 entry, K4 entry), or None untimed."""
    from controllora_tpu_torch.ops.attention import split_heads

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
    record["k3"]["max_abs_err"] = max(record["k3"]["max_abs_err"], errs["dk"], errs["dv"])
    record["k4"]["max_abs_err"] = max(record["k4"]["max_abs_err"], errs["dq"])
    line = (f"K3/K4{label} {tag}: max|d| dQ {errs['dq']:.3e}, dK {errs['dk']:.3e}, "
            f"dV {errs['dv']:.3e} <= {GRAD_BOUND} * max(1, max|ref|)")
    entries = None
    if timed:
        bwd = (q, k, v, do, lse, dcap, h)
        b3 = attention_roofline(4, b, h, l, l, d, 2, 4, 2)
        b4 = attention_roofline(3, b, h, l, l, d, 3, 2, 2)
        ms3 = cuda_ms(lambda: fa.flash_bwd_dkv(*bwd))
        dms3 = device_ms(lambda: fa.flash_bwd_dkv(*bwd), floor_ms=b3["bound_ms"])
        pms3 = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*bwd))
        ms4 = cuda_ms(lambda: fa.flash_bwd_dq(*bwd))
        dms4 = device_ms(lambda: fa.flash_bwd_dq(*bwd), floor_ms=b4["bound_ms"])
        pms4 = cuda_ms(lambda: fa.flash_bwd_dq_plain(*bwd))
        library = sdpa_ms(torch, *(split_heads(x, h) for x in (q, k, v)),
                          do=split_heads(do, h))
        entries = (shape_entry((b, h, l, d), ms3, dms3, pms3, b3, library),
                   shape_entry((b, h, l, d), ms4, dms4, pms4, b4, library))
        for name, entry in zip(("k3", "k4"), entries):
            if label:
                entry["path"] = label.strip(" ()")
            record[name]["shapes"].append(entry)
        line += (f"  K3 {ms3:.4f} ms (device {num(dms3)}, plain {pms3:.4f}, bound "
                 f"{b3['bound_ms']:.4f})  K4 {ms4:.4f} ms (device {num(dms4)}, "
                 f"plain {pms4:.4f}, bound {b4['bound_ms']:.4f})  SDPA "
                 f"backward (dq, dk, dv) {fmt_sdpa(library)}")
    log(line)
    del q, k, v, do, o, lse, dcap, dk, dv, dq
    return entries


def phase_backward_kernels(torch, fa, device):
    """K3/K4 vs plain; returns {kernel: {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by", "library_ms", "library_backend", "shapes"}}: the top-level numbers
    are those of the SD1.5 training shape."""
    gen = torch.Generator(device=device).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    record = {n: {"max_abs_err": 0.0, "shapes": []} for n in ("k3", "k4")}
    # the training path's shape (5 UNet self-attentions at 512², batch 8), the 384²
    # and 704² latents (L a multiple of the kernels' 64-row tile), then ragged L: the
    # 520² latent (4225 = 66 * 64 + 1) and a short one, where the kernels mask P by index
    # and D 64 (K3's third instance), and L 40, under one tile of either kernel
    for b, h, l, d in ((8, 8, 4096, 40), (2, 8, 2304, 80), (1, 8, 7744, 40),
                       (2, 8, 4225, 40), (1, 8, 300, 80), (2, 8, 1024, 64), (2, 4, 40, 40)):
        entries = bwd_case(torch, fa, rnd, record, b, h, l, d, timed=(b, l, d) == (8, 4096, 40))
        if entries is not None:
            for name, entry in zip(("k3", "k4"), entries):
                record[name].update({k: v for k, v in entry.items() if k != "shape"})
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
                                     adapter_compute_dtype=adapter_dtype, remat_unet=False)
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


KERNEL_CLASSES = (("flash (ours)", ("flash_", "bias_add_kernel", "combine_splits_kernel")),
                  ("GEMM", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
                  ("conv + layout", ("conv", "cudnn", "nchwToNhwc", "nhwcToNchw")),
                  ("norms", ("Moments", "norm", "Norm")),
                  ("softmax", ("softmax", "Softmax")))


def kernel_class(name):
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise, copies, other"


def device_profile(torch, fn, host=True):
    """Run fn() once under torch.profiler; returns (wall s, device busy s, kernels
    [(name, ms)] by time). Busy time is the sum of the CUDA kernel and memory
    operation durations (one stream: they do not overlap). `host=False` records the
    device's activity only: the host's operator events of a long render take the
    profiler tens of seconds to gather afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
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


def profile_line(name, wall, busy, top):
    classes = {}
    for kname, ms in top:
        classes[kernel_class(kname)] = classes.get(kernel_class(kname), 0.0) + ms
    return (f"{name}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, idle share "
            f"{1 - busy / wall:.3f}; by class: "
            + "; ".join(f"{c} {ms:.1f} ms" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1])))


def phase_render_profile(torch, pipe):
    """One guided 512² render at batch 1 and one at batch 4 (per-image guides) through
    the pipeline under torch.profiler, under each preset: wall, device busy time,
    idle share, and device time by kernel class (K1 is in "flash (ours)"). The
    profiler records device activity only: the host's operator events added about
    20 s a render to gather and up to 30% to its wall."""
    import numpy as np

    rng = np.random.default_rng(9)
    guides = rng.uniform(-1, 1, (4, RES, RES, 3)).astype(np.float32)
    common = dict(num_inference_steps=STEPS, guidance_scale=CFG, height=RES, width=RES)
    pipe("warm up", guide=guides[:1], **dict(common, num_inference_steps=2))
    for preset, kw in PRESETS.items():
        for n in (1, 4):
            wall, busy, top = device_profile(torch, lambda: pipe(
                [f"prompt {i}" for i in range(n)], guide=guides[:n], **common, **kw),
                host=False)
            label = "" if preset == "exact" else f" ({preset})"
            log(profile_line(f"render profiled{label}, guided batch {n}", wall, busy, top))


def phase_train(torch, fa, pipe, device):
    """The training main path; returns its launch counts."""
    from controllora_tpu_torch.data.registry import DatasetBase, batch_iterator
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch

    data = batch_iterator(DatasetBase.from_name("process/fill50k")(HashTokenizer(),
                                                                   resolution=RES),
                          TRAIN_BATCH, seed=0)
    batches = [to_device_batch(next(data), device)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    trainer = ControlLoRATrainer(pipe.control_lora, pipe.unet, pipe.vae, pipe.text_encoder,
                                 hint_compute_dtype=torch.bfloat16, remat_unet=False)
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
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    if changed == 0:
        raise AssertionError("train: no adapter parameter changed")

    wall, busy, top = device_profile(torch, lambda: trainer.train_step(batches[-1], gen))
    log(profile_line("train profiled step", wall, busy, top)
        + f"; idle share against the unprofiled step {1 - busy / step_s:.3f}; top kernels: "
        + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top[:10]))
    return total


def phase_entry_point(torch, beside=None):
    """The training CLI end to end; the saved artifact loads back strictly. The CLI is
    a subprocess: `beside` (a function) runs in this process meanwhile, so that the two
    subprocess-bound phases share their start-up time."""
    from controllora_tpu_torch.training.checkpoint import load_control_lora

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "controllora_tpu_torch.train", "--max_train_steps", "2",
             "--resolution", str(RES), "--train_batch_size", str(TRAIN_BATCH),
             "--log_every", "1", "--output_dir", out, "--device", "cuda"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            if beside is not None:
                beside()
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed ({proc.returncode}):\n{stderr[-3000:]}")
        steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
        if len(steps) != 2 or "nan" in stdout:
            raise AssertionError(f"train CLI output:\n{stdout[-2000:]}")
        model, _ = load_control_lora(out)
        n = sum(p.numel() for p in model.parameters())
    log(f"entry point: python -m controllora_tpu_torch.train 2 steps at {RES}² batch "
        f"{TRAIN_BATCH} in {time.perf_counter() - t0:.1f} s ({steps[-1]}; sharing the card "
        f"with the CLI smoke runs); artifact loads strictly ({n / 1e6:.2f}M params)")


def phase_stock_kernels(torch, fs, device):
    """K5 (forward, dK/dV, dQ) vs plain (fp32 on the same bf16 inputs, m and l from
    the K5 forward) at the training shape, the VAE encoder's (forward only), the 768²
    tail, D 64, a non-default and a negative scale, and contiguous (B, H, L, D)
    tensors; returns {kernel: {"max_abs_err", "ms", ...}}."""
    from controllora_tpu_torch.ops.attention import split_heads

    gen = torch.Generator(device=device).manual_seed(6)

    def heads(b, h, l, d, contiguous):
        """A head-split view of a (B, L, H*D) projection, as routed, or a contiguous
        (B, H, L, D) copy of one."""
        x = split_heads(torch.randn((b, l, h * d), generator=gen, device=device)
                        .to(torch.bfloat16), h)
        return x.contiguous() if contiguous else x

    record = {n: {"max_abs_err": 0.0} for n in ("k5_fwd", "k5_dkv", "k5_dq")}
    record["k5_fwd"]["shapes"] = []
    for b, h, l, d, scale, grads, contiguous in ((16, 8, 4096, 40, None, True, False),
                                                 (16, 1, 4096, 512, None, False, False),
                                                 (2, 8, 2304, 80, None, True, False),
                                                 (2, 8, 4096, 40, 0.3, True, False),
                                                 (2, 8, 4096, 40, -0.3, True, False),
                                                 (2, 8, 1024, 64, None, True, False),
                                                 (2, 8, 1024, 40, 0.3, True, True)):
        scale = d**-0.5 if scale is None else scale
        q, k, v, do = (heads(b, h, l, d, contiguous) for _ in range(4))
        o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(q.float(), k.float(), v.float(), scale)
        err = (o.float() - o_ref).abs().max().item()
        merr = ((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max().item()
        lerr = ((lsum - l_ref).abs() / l_ref).max().item()
        del o_ref, m_ref, l_ref
        tag = (f"B={b} H={h} L={l} D={d} scale={scale:.4g}"
               + (" contiguous (B, H, L, D)" if contiguous else ""))
        if not (torch.isfinite(o).all() and err <= O_BOUND and merr <= LSE_BOUND
                and lerr <= LSE_BOUND):
            raise AssertionError(f"K5 fwd {tag}: max|dO| {err}, rel m {merr}, rel l {lerr}")
        record["k5_fwd"]["max_abs_err"] = max(record["k5_fwd"]["max_abs_err"], err)
        line = (f"K5 fwd {tag}: max|dO| {err:.3e} <= {O_BOUND}, relative m {merr:.3e}, "
                f"l {lerr:.3e} <= {LSE_BOUND}")
        if grads:
            di = (o.float() * do.float()).sum(-1)
            dk, dv = fs.stock_flash_bwd_dkv(q, k, v, do, m, lsum, di, scale)
            dq = fs.stock_flash_bwd_dq(q, k, v, do, m, lsum, di, scale)
            torch.cuda.synchronize()
            args = [x.float() for x in (q, k, v, do)] + [m, lsum, di, scale]
            ref_dk, ref_dv = fs.stock_flash_bwd_dkv_plain(*args)
            errs = {"dk": grad_check(f"K5 dK {tag}", dk, ref_dk),
                    "dv": grad_check(f"K5 dV {tag}", dv, ref_dv)}
            del ref_dk, ref_dv
            errs["dq"] = grad_check(f"K5 dQ {tag}", dq, fs.stock_flash_bwd_dq_plain(*args))
            record["k5_dkv"]["max_abs_err"] = max(record["k5_dkv"]["max_abs_err"],
                                                  errs["dk"], errs["dv"])
            record["k5_dq"]["max_abs_err"] = max(record["k5_dq"]["max_abs_err"], errs["dq"])
            line += (f"; max|d| dQ {errs['dq']:.3e}, dK {errs['dk']:.3e}, dV {errs['dv']:.3e}"
                     f" <= {GRAD_BOUND} * max(1, max|ref|)")
            del args, dk, dv, dq
        if (b, h, l, d) == (16, 1, 4096, 512):  # the VAE encoder's launch on the stock step
            fms = cuda_ms(lambda: fs.stock_flash_fwd(q, k, v, scale))
            fdms = device_ms(lambda: fs.stock_flash_fwd(q, k, v, scale))
            fpms = cuda_ms(lambda: fs.stock_flash_fwd_plain(q.float(), k.float(), v.float(),
                                                            scale))
            bound = attention_roofline(2, b, h, l, l, d, 2, 2, 2)
            library = sdpa_ms(torch, q, k, v, scale=scale)
            record["k5_fwd"]["shapes"].append(
                shape_entry((b, h, l, d), fms, fdms, fpms, bound, library))
            line += (f"\n  k5_fwd {fms:.4f} ms (device {num(fdms)}, plain {fpms:.4f}, bound {bound['bound_ms']:.4f} "
                     f"by {bound['bound_by']})  SDPA forward {fmt_sdpa(library)}")
        if (b, h, l, d) == (16, 8, 4096, 40):
            fwd = (q, k, v, scale)
            bwd = (q, k, v, do, m, lsum, di, scale)
            plain = [x.float() for x in (q, k, v, do)] + [m, lsum, di, scale]
            calls = {"k5_fwd": (lambda: fs.stock_flash_fwd(*fwd),
                                lambda: fs.stock_flash_fwd_plain(*plain[:3], scale)),
                     "k5_dkv": (lambda: fs.stock_flash_bwd_dkv(*bwd),
                                lambda: fs.stock_flash_bwd_dkv_plain(*plain)),
                     "k5_dq": (lambda: fs.stock_flash_bwd_dq(*bwd),
                               lambda: fs.stock_flash_bwd_dq_plain(*plain))}
            times = {name: (cuda_ms(kernel), device_ms(kernel), cuda_ms(ref))
                     for name, (kernel, ref) in calls.items()}
            del plain
            forward = sdpa_ms(torch, q, k, v, scale=scale)
            backward = sdpa_ms(torch, q, k, v, scale=scale, do=do)
            costs = {"k5_fwd": (2, 2, 2, 2), "k5_dkv": (4, 2, 4, 3), "k5_dq": (3, 3, 2, 3)}
            for name, (ms, dms, pms) in times.items():
                products, nq, nk, rows = costs[name]
                bound = attention_roofline(products, b, h, l, l, d, nq, nk, rows)
                if name == "k5_fwd":
                    record[name]["shapes"].insert(0, shape_entry(
                        (b, h, l, d), ms, dms, pms, bound, forward))
                record[name].update(ms=ms, device_ms=dms, plain_ms=pms,
                                    **(forward if name == "k5_fwd" else backward), **bound)
                line += (f"\n  {name} {ms:.4f} ms (device {num(dms)}, plain {pms:.4f}, bound "
                         f"{bound['bound_ms']:.4f} by {bound['bound_by']})")
            line += (f"\n  SDPA forward {fmt_sdpa(forward)}, backward (dq, dk, dv) "
                     f"{fmt_sdpa(backward)}")
        log(line)
        del q, k, v, do, o, m, lsum
    q = heads(1, 2, 4225, 40, False)
    try:
        fs.stock_flash_attention(q, q, q, 0.1)
    except ValueError as e:
        log(f"K5 at L 4225 (the 520² latent) raises on the card too: ValueError({e})")
    else:
        raise AssertionError("K5 took L 4225, which jax's stock kernel refuses")
    return record


def phase_stock_grad(torch, fs, device):
    """Gradients through FlashStockAttention (K5 forward, dK/dV + dQ backward) against
    autograd of the plain fp32 attention: the training shape and a non-default scale."""
    from controllora_tpu_torch.ops.attention import split_heads

    gen = torch.Generator(device=device).manual_seed(7)
    for b, h, l, d, scale in ((16, 8, 4096, 40, 40**-0.5), (2, 8, 4096, 40, 0.3)):
        leaves = [torch.randn((b, l, h * d), generator=gen, device=device)
                  .to(torch.bfloat16).requires_grad_() for _ in range(3)]
        do = split_heads(torch.randn((b, l, h * d), generator=gen, device=device)
                         .to(torch.bfloat16), h)
        before = dict(fs.LAUNCHES)
        fs.stock_flash_attention(*(split_heads(x, h) for x in leaves), scale).backward(do)
        torch.cuda.synchronize()
        used = {n: fs.LAUNCHES[n] - before[n] for n in before}
        if used != {"k5_fwd": 1, "k5_dkv": 1, "k5_dq": 1}:
            raise AssertionError(f"FlashStockAttention launches {used}")
        ref_in = [x.detach().float().requires_grad_() for x in leaves]
        qh, kh, vh = (split_heads(x, h) for x in ref_in)
        (torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1) @ vh).backward(do.float())
        errs = {n: grad_check(f"FlashStockAttention d{n}", x.grad, r.grad)
                for n, x, r in zip("qkv", leaves, ref_in)}
        log(f"FlashStockAttention grad B={b} H={h} L={l} D={d} scale={scale:.4g} vs plain "
            "fp32 autograd: " + ", ".join(f"max|d{n}| {e:.3e}" for n, e in errs.items())
            + f" <= {GRAD_BOUND} * max(1, max|ref|)")
        del leaves, do, ref_in, qh, kh, vh


def phase_adam8bit(torch, pipe, device):
    """8-bit AdamW, card against CPU: (a) the optimizer alone on the same fp32
    gradients (those of one CPU train step at batch 1): params within 1e-6, int8
    codes equal but for at most one unit at 1e-3 of the elements, scales within 1e-5
    relative; (b) one train step on the card (bf16 stack, kernels) from the same
    params: its loss within REL_BOUND of the CPU step's, finite, params updated."""
    import numpy as np

    from controllora_tpu_torch.models.clip import CLIPTextModel
    from controllora_tpu_torch.models.control_lora import ControlLoRA
    from controllora_tpu_torch.models.unet import UNet2DConditionModel
    from controllora_tpu_torch.models.vae import AutoencoderKL
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, make_optimizer

    rng = np.random.default_rng(8)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    batch = {"latents": t(rng.normal(size=(1, 4, RES // 8, RES // 8))),
             "guide_values": t(rng.uniform(-1, 1, (1, 3, RES, RES))),
             "input_ids": torch.from_numpy(rng.integers(0, 49408, (1, 77))).long()}
    draws = dict(noise=t(rng.normal(size=(1, 4, RES // 8, RES // 8))),
                 timesteps=torch.tensor([300]))
    c_control = cpu_copy(torch, pipe.control_lora, ControlLoRA, pipe.control_lora.config)
    start = [p.detach().clone() for p in pipe.control_lora.parameters()]
    c_trainer = ControlLoRATrainer(
        c_control, cpu_copy(torch, pipe.unet, UNet2DConditionModel, pipe.unet.config),
        cpu_copy(torch, pipe.vae, AutoencoderKL, pipe.vae.config),
        cpu_copy(torch, pipe.text_encoder, CLIPTextModel, pipe.text_encoder.config),
        optimizer=make_optimizer(c_control.parameters(), use_8bit=True), remat_unet=False)
    c_loss = c_trainer.loss(batch, **draws)
    grads = c_trainer.grads(c_loss)
    c_trainer.optimizer.step(grads)

    params = [torch.nn.Parameter(p.clone()) for p in start]
    opt = make_optimizer(params, use_8bit=True)
    opt.step([g.to(device) for g in grads])
    torch.cuda.synchronize()
    perr = max((p.detach().cpu() - c).abs().max().item()
               for p, c in zip(params, c_control.parameters()))
    n_codes = n_diff = 0
    max_code = serr = 0.0
    for p, c in zip(params, c_control.parameters()):
        st, c_st = opt.adamw.state[p], c_trainer.optimizer.adamw.state[c]
        for name in ("exp_avg", "exp_avg_sq"):
            if f"{name}_q" not in st:
                continue
            diff = (st[f"{name}_q"].cpu().int() - c_st[f"{name}_q"].int()).abs()
            n_codes += diff.numel()
            n_diff += int((diff > 0).sum())
            max_code = max(max_code, int(diff.max()))
            scale = c_st[f"{name}_scale"]
            serr = max(serr, ((st[f"{name}_scale"].cpu() - scale).abs()
                              / scale.clamp(min=1e-30)).max().item())
    log(f"8-bit AdamW card vs CPU on the same gradients: max|dparam| {perr:.3e} <= 1e-06; "
        f"int8 codes differing {n_diff}/{n_codes} (max {max_code} unit); scales relative "
        f"{serr:.3e} <= 1e-05")
    if not (perr <= 1e-6 and max_code <= 1 and n_diff <= 1e-3 * n_codes and serr <= 1e-5):
        raise AssertionError("8-bit AdamW: the card's step differs from the CPU's")

    trainer = ControlLoRATrainer(pipe.control_lora, pipe.unet, pipe.vae, pipe.text_encoder,
                                 optimizer=make_optimizer(pipe.control_lora.parameters(),
                                                          use_8bit=True),
                                 hint_compute_dtype=torch.bfloat16, remat_unet=False)
    metrics = trainer.train_step({k: x.to(device) for k, x in batch.items()},
                                 **{k: x.to(device) for k, x in draws.items()})
    loss = float(metrics["loss"])
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(start, pipe.control_lora.parameters()))
    err = abs(loss - c_loss.item()) / abs(c_loss.item())
    log(f"8-bit AdamW train step on the card: loss {loss:.6f} vs CPU {c_loss.item():.6f} "
        f"(relative {err:.3e} <= {REL_BOUND}); {moved}/{len(start)} params updated")
    if not (math.isfinite(loss) and err <= REL_BOUND and moved > 0):
        raise AssertionError("8-bit AdamW train step on the card failed")


def phase_stock_train(torch, fa, fs):
    """The K5 main path: ``python -m controllora_tpu_torch.train`` (in this process,
    so that the launch counters are read here) under CONTROLLORA_FLASH_IMPL=stock, on
    SD1.5 at full width with the `base` ControlLoRA, 512², batch 16,
    --gradient_checkpointing --remat_policy dots: 2 warm-up and 3 timed steps with
    exact launches per step, batches from the native data plane (C fill50k behind a
    prefetch thread), which the CLI must report; then 2 steps each of `nothing` and
    no remat, for peak memory. The host's time to make one batch of 16 in Python
    (what each CLI step paid before the native plane) and in C is logged. Returns the
    launch counts of the dots run."""
    import contextlib
    import io

    from controllora_tpu_torch import train as cli

    def run(policy, steps, out):
        args = ["--model_variant", "sd15", "--resolution", str(RES), "--train_batch_size",
                str(STOCK_BATCH), "--max_train_steps", str(steps), "--log_every", "1",
                "--checkpointing_steps", "0", "--output_dir", out, "--device", "cuda"]
        if policy:
            args += ["--gradient_checkpointing", "--remat_policy", policy]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        buf = io.StringIO()
        fa.reset_launch_counts()
        fs.reset_launch_counts()  # the main path starts here
        with contextlib.redirect_stdout(buf):
            cli.main(args)
        counts = {**fa.LAUNCHES, **fs.LAUNCHES}  # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps_out = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
        plane = [ln for ln in buf.getvalue().splitlines() if ln.startswith("data plane:")]
        if not plane or "native" not in plane[0]:
            raise AssertionError(f"stock train ({policy}): data plane {plane}")
        ms = [float(ln.split()[-2]) for ln in steps_out]
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps_out]
        want = {n: c * steps for n, c in STOCK_LAUNCHES[policy].items()}
        if counts != want or len(ms) != steps:
            raise AssertionError(f"stock train ({policy}): launches {counts}, expected "
                                 f"{want} ({STOCK_LAUNCHES[policy]} per step)\n"
                                 + buf.getvalue()[-2000:])
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"stock train ({policy}): losses {losses}")
        return counts, peak - resident, ms, losses

    from controllora_tpu_torch.data.fastloader import NativeFill50kBatcher
    from controllora_tpu_torch.data.registry import DatasetBase, batch_iterator
    from controllora_tpu_torch.data.tokenizer import HashTokenizer

    ds = DatasetBase.from_name("process/fill50k")(HashTokenizer(), resolution=RES)
    made = {}
    for name, data in (("Python batch_iterator", batch_iterator(ds, STOCK_BATCH, seed=1)),
                       ("native C", iter(NativeFill50kBatcher(ds, STOCK_BATCH, seed=1)))):
        next(data)  # the C library is built by its first call
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            next(data)
            times.append((time.perf_counter() - t0) * 1e3)
        made[name] = times
    log(f"host: one fill50k batch of {STOCK_BATCH} at {RES}² takes "
        + "; ".join(f"{n} " + ", ".join(f"{x:.1f}" for x in t) + " ms" for n, t in made.items())
        + " to make; the CLI below makes it in C on a prefetch thread, off the step")
    os.environ["CONTROLLORA_FLASH_IMPL"] = "stock"
    try:
        with tempfile.TemporaryDirectory() as out:
            counts, peak, ms, losses = run("dots", TRAIN_WARMUP + TRAIN_STEPS, out)
            step_ms = statistics.mean(ms[TRAIN_WARMUP:])
            log(f"stock train (K5) {RES}² batch {STOCK_BATCH}, remat dots, via the CLI: "
                f"{step_ms:.1f} ms/step (steps " + ", ".join(f"{x:.1f}" for x in ms)
                + f" ms), {STOCK_BATCH / step_ms * 1e3:.3f} img/s, peak {peak:.2f} GiB "
                "allocated above what was resident before the run; losses " + ", ".join(f"{x:.4f}" for x in losses)
                + f"; launches per step {STOCK_LAUNCHES['dots']}")
            for policy in ("nothing", None):
                _, p_peak, p_ms, _ = run(policy, 2, out)
                log(f"stock train remat {policy or 'off'}: peak {p_peak:.2f} GiB allocated, "
                    f"steps {p_ms[0]:.1f}, {p_ms[1]:.1f} ms; launches per step "
                    f"{STOCK_LAUNCHES[policy]}")
    finally:
        del os.environ["CONTROLLORA_FLASH_IMPL"]
    return counts


def phase_cli_resume(torch):
    """The smoke-variant CLI on the card with 8-bit AdamW, remat, checkpoints and the
    latent cache (--cache_latents --max_train_samples 32): 4 steps straight against 2
    steps, then --resume_from_checkpoint latest for 2 more. The adapters agree within
    1e-3 (cuDNN's convolution backward is not bitwise reproducible on the card; the
    CPU test holds the resume bitwise); the second run loads the cache the first
    wrote; pruning keeps the newest checkpoint."""
    from controllora_tpu_torch.training.checkpoint import checkpoint_step_dirs, load_control_lora

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        common = [sys.executable, "-m", "controllora_tpu_torch.train", "--model_variant",
                  "smoke", "--resolution", "64", "--train_batch_size", "4", "--log_every",
                  "1", "--device", "cuda", "--use_8bit_adam", "--gradient_checkpointing",
                  "--cache_latents", "--max_train_samples", "32",
                  "--latent_cache_path", os.path.join(tmp, "cache.npz")]
        runs = {"straight": ["--max_train_steps", "4", "--checkpointing_steps", "2",
                             "--checkpoints_total_limit", "1", "--output_dir",
                             os.path.join(tmp, "a")],
                "first half": ["--max_train_steps", "2", "--checkpointing_steps", "2",
                               "--output_dir", os.path.join(tmp, "b")],
                "resumed": ["--max_train_steps", "4", "--checkpointing_steps", "0",
                            "--resume_from_checkpoint", "latest", "--output_dir",
                            os.path.join(tmp, "b")]}
        outs = {}
        for name, extra in runs.items():
            proc = subprocess.run(common + extra, cwd=ROOT, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0 or "nan" in proc.stdout:
                raise AssertionError(f"CLI {name} ({proc.returncode}):\n{proc.stdout[-1500:]}"
                                     f"\n{proc.stderr[-3000:]}")
            outs[name] = proc
        if not ("latent cache: saved" in outs["straight"].stderr
                and "latent cache: loaded" in outs["first half"].stderr
                and "resumed from step 2" in outs["resumed"].stdout
                and [s for s, _ in checkpoint_step_dirs(os.path.join(tmp, "a"))] == [4]):
            raise AssertionError("CLI resume: cache, resume or pruning missing:\n"
                                 + "\n".join(p.stdout[-800:] for p in outs.values()))
        a, _ = load_control_lora(os.path.join(tmp, "a"))
        b, _ = load_control_lora(os.path.join(tmp, "b"))
        err = max((x - y).abs().max().item() for x, y in zip(a.parameters(), b.parameters()))
    log(f"CLI smoke variant on the card (8-bit AdamW, remat, latent cache of 32, "
        f"checkpoints): 4 straight vs 2 + resume 2: max|dparam| {err:.3e} <= 1e-3; "
        f"{time.perf_counter() - t0:.1f} s")
    if not err <= 1e-3:
        raise AssertionError(f"CLI resume: adapters differ by {err}")


# the other model families, each rendered guided at its own size: SD2.1 (768², v-
# prediction DPM-Solver++) and SDXL (1024², dual text towers, text_time); the
# refiner's UNet is evaluated once at 1024²
FAMILIES = {"sd21": (768, "v_prediction"), "sdxl": (1024, "epsilon")}
HTTP_FAMILY = "sdxl"  # the family the HTTP server is driven with
REFINER, REFINER_RES = "sdxl-refiner", 1024
# K1 at the families' self-attentions, (B, heads, L, D) under a batch-1 render (bias
# batch 1) and a batch-4 one (bias batch 4 under B 8), and K2 at their VAE decodes
FAMILY_K1 = (((2, 5, 9216, 64), "SD2.1 768² level 0"), ((2, 10, 2304, 64), "SD2.1 768² level 1"),
             ((2, 10, 4096, 64), "SDXL 1024² level 1"), ((2, 12, 4096, 64), "refiner 1024² level 1"))
FAMILY_K2 = (((1, 1, 9216, 512), "SD2.1 768² VAE"), ((1, 1, 16384, 512), "SDXL 1024² VAE"))
# K1 at the levels ToMe 0.5 merges (ops/tome.py::merge_count), with biases merged per
# CFG row (bias batch = B), at batch 1 and 4: SD2.1 768² level 0 (9216 -> 4608 tokens)
# and SDXL 1024² level 1 (4096 -> 2048, FLASH_MIN_LEN itself)
FAMILY_MERGED_K1 = (((2, 5, 4608, 64), "SD2.1 768² level 0, ToMe 0.5"),
                    ((2, 10, 2048, 64), "SDXL 1024² level 1, ToMe 0.5"))
FAMILY_PRESETS = ("tome", "turbo")  # each family's guided renders beside exact


def k1_per_eval(unet_config, res, tome_ratio=0.0, levels=None):
    """K1 launches of one guided CFG UNet eval at `res`: the self-attentions (attn1;
    every one carries folded biases) of the levels whose token count, after ToMe's
    merge where `tome_ratio` merges that level (ops/tome.py::maybe_tome, merge_count),
    reaches the flash route's FLASH_MIN_LEN; only those of `levels` if given (a
    DeepCache shallow eval runs level 0 alone)."""
    from controllora_tpu_torch.models.unet import attention_processor_names, processor_bucket
    from controllora_tpu_torch.ops import tome
    from controllora_tpu_torch.ops.attention import FLASH_MIN_LEN

    n, side = len(unet_config.block_out_channels), res // 8
    cfg = tome.ToMeConfig(ratio=tome_ratio) if tome_ratio else None
    count = 0
    for name in attention_processor_names(unet_config):
        level = processor_bucket(name, n)
        grid = side >> level
        tokens = grid * grid
        if tome.maybe_tome(cfg, grid, grid):
            tokens -= tome.merge_count(cfg, tokens)
        count += (".attn1." in name and (levels is None or level in levels)
                  and tokens >= FLASH_MIN_LEN)
    return count


def render_launches(unet_config, res, tome_ratio=0.0, deepcache_interval=1, guided=True,
                    steps=None):
    """Launches of one batch-1 render of `steps` (STEPS) steps at `res`, guided (K1 at
    every long self-attention) or not (K2 there), under a preset: every full eval runs
    them all (after ToMe's merge), each DeepCache shallow eval (the steps off the
    interval) those of level 0 alone; K2 once in the VAE decode's mid-attention."""
    from controllora_tpu_torch.ops.attention import FLASH_MIN_LEN

    steps = steps or STEPS
    full = len(range(0, steps, deepcache_interval))
    attn = (full * k1_per_eval(unet_config, res, tome_ratio)
            + (steps - full) * k1_per_eval(unet_config, res, tome_ratio, levels=(0,)))
    vae = int((res // 8) ** 2 >= FLASH_MIN_LEN)
    return {"k1": attn if guided else 0, "k2": vae + (0 if guided else attn), "k3": 0,
            "k4": 0}


def launched(fa, before):
    return {n: fa.LAUNCHES[n] - before[n] for n in before}


def family_parity(torch, fa, pipe, res, device, label, modules=("unet", "text", "vae")):
    """One folded CFG UNet eval (batch 2, guide at `res`), the text encoder and one
    VAE decode of the card's bf16 stack with the kernels against an fp32 copy on the
    card with every attention on its plain version (attention_backend "xla");
    relative L2 within REL_BOUND. Every kernel launch is checked: the bf16 eval
    launches K1 k1_per_eval times, the decode K2 once where its L reaches the flash
    route, the fp32 side none. The fp32 copies are freed before returning."""
    import numpy as np
    from torch.func import functional_call

    from controllora_tpu_torch.ops.folding import fold_adapters

    rng = np.random.default_rng(5)
    side = res // 8
    guide = torch.from_numpy(rng.uniform(-1, 1, (1, 3, res, res)).astype(np.float32)).to(device)
    lat = torch.from_numpy(rng.normal(size=(2, 4, side, side)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, 49407, (2, 77))).to(device)
    t = torch.tensor([500.0, 500.0], device=device)
    unet, cfg = pipe.unet, pipe.unet.config
    errs, t0 = {}, time.perf_counter()
    with torch.inference_mode():
        enc = pipe.text_encoder(ids)
        ctx, pooled = enc if isinstance(enc, tuple) else (enc, None)
        added = {}
        if cfg.addition_embed_type == "text_time":
            added = dict(added_text_embeds=pooled,
                         added_time_ids=pipe.text_time_ids(pooled, res, res, 6.0, 2.5))
        if "text" in modules:
            text32 = fp32_copy(torch, pipe.text_encoder, device)
            enc32 = text32(ids)
            enc32 = enc32 if isinstance(enc32, tuple) else (enc32,)
            for name, a, b in zip(("context", "pooled"), (ctx, pooled), enc32):
                errs[f"text encoder {name}"] = rel_l2(a, b)
            del text32, enc32
        adapters = pipe.control_lora.adapters_for(guide, cfg)
        weights, biases = fold_adapters(unet, adapters)
        biases = {k: b.to(torch.bfloat16) for k, b in biases.items()}
        before = dict(fa.LAUNCHES)
        eps = functional_call(unet, weights, (lat, t, ctx), dict(biases=biases, **added))
        torch.cuda.synchronize()
        used = launched(fa, before)
        del weights, biases
        unet32 = fp32_copy(torch, unet, device)
        weights, biases = fold_adapters(unet32, adapters)
        before = dict(fa.LAUNCHES)
        eps32 = functional_call(unet32, weights, (lat, t, ctx), dict(
            biases=biases, attention_backend="xla", **added))
        torch.cuda.synchronize()
        used32 = launched(fa, before)
        errs["folded UNet eval"] = rel_l2(eps, eps32)
        del unet32, weights, biases, adapters, eps32
        want = {"k1": k1_per_eval(cfg, res), "k2": 0, "k3": 0, "k4": 0}
        if "vae" in modules:
            before = dict(fa.LAUNCHES)
            img = pipe.vae.decode(lat[:1])
            torch.cuda.synchronize()
            used = {n: used[n] + c for n, c in launched(fa, before).items()}
            want["k2"] = render_launches(cfg, res)["k2"]
            vae32 = fp32_copy(torch, pipe.vae, device)
            before = dict(fa.LAUNCHES)
            img32 = vae32.decode(lat[:1], attention_backend="xla")
            torch.cuda.synchronize()
            used32 = {n: used32[n] + c for n, c in launched(fa, before).items()}
            errs[f"VAE decode {res}²"] = rel_l2(img, img32)
            del vae32, img32
            if not torch.isfinite(img).all():
                raise AssertionError(f"{label}: non-finite VAE decode")
    gc.collect()
    torch.cuda.empty_cache()
    for name, err in errs.items():
        log(f"{label} parity {name}: card bf16 (kernels) vs card fp32 (plain versions) "
            f"relative L2 {err:.4e} <= {REL_BOUND}")
    log(f"{label} parity: launches bf16 {used}, fp32 {used32}; {time.perf_counter() - t0:.1f} s")
    if used != want or any(used32.values()):
        raise AssertionError(f"{label} parity launches: bf16 {used} (want {want}), fp32 {used32}")
    if not torch.isfinite(eps).all():
        raise AssertionError(f"{label}: non-finite UNet eval")
    bad = {k: v for k, v in errs.items() if not v <= REL_BOUND}
    if bad:
        raise AssertionError(f"{label} parity outside {REL_BOUND}: {bad}")


def refiner_unguided_parity(torch, fa, refiner, res, device):
    """The refiner's CFG UNet eval as the ensemble runs it (no adapters: K2 in every
    long self-attention) on the card's bf16 stack against an fp32 copy on the card
    with every attention plain; relative L2 within REL_BOUND, launches exact."""
    import numpy as np

    rng = np.random.default_rng(12)
    side = res // 8
    lat = torch.from_numpy(rng.normal(size=(2, 4, side, side)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, 49407, (2, 77))).to(device)
    t = torch.tensor([300.0, 300.0], device=device)
    cfg = refiner.unet.config
    with torch.inference_mode():
        ctx, pooled = refiner.text_encoder(ids)
        added = dict(added_text_embeds=pooled,
                     added_time_ids=refiner.text_time_ids(pooled, res, res, 6.0, 2.5))
        before = dict(fa.LAUNCHES)
        eps = refiner.unet(lat, t, ctx, **added)
        torch.cuda.synchronize()
        used = launched(fa, before)
        unet32 = fp32_copy(torch, refiner.unet, device)
        before = dict(fa.LAUNCHES)
        eps32 = unet32(lat, t, ctx, attention_backend="xla", **added)
        torch.cuda.synchronize()
        used32 = launched(fa, before)
        err = rel_l2(eps, eps32)
        del unet32, eps32
    gc.collect()
    torch.cuda.empty_cache()
    want = {"k1": 0, "k2": k1_per_eval(cfg, res), "k3": 0, "k4": 0}
    log(f"refiner parity unguided UNet eval (the ensemble's): card bf16 (K2) vs card fp32 "
        f"(plain versions) relative L2 {err:.4e} <= {REL_BOUND}; launches bf16 {used}, "
        f"fp32 {used32}")
    if used != want or any(used32.values()) or not torch.isfinite(eps).all():
        raise AssertionError(f"refiner unguided eval launches: bf16 {used} (want {want}), "
                             f"fp32 {used32}")
    if not err <= REL_BOUND:
        raise AssertionError(f"refiner unguided eval relative L2 {err} > {REL_BOUND}")


def family_render(torch, fa, pipe, res, label, card, preset="exact"):
    """The family's main path under a serving preset (PRESETS): one guided batch-1
    render of STEPS steps at CFG through the BatchingEngine (after a 2-step warm-up),
    its launches counted from 0 and held to render_launches; then one render under
    torch.profiler, device activity only (as phase_render_profile). Returns the
    launches."""
    import numpy as np

    from controllora_tpu_torch.serving import BatchingEngine

    t_call = time.perf_counter()
    speed = PRESETS[preset]
    label = label if preset == "exact" else f"{label} {preset}"
    guide = np.random.default_rng(6).uniform(-1, 1, (res, res, 3)).astype(np.float32)
    common = dict(guide=guide, num_inference_steps=STEPS, guidance_scale=CFG, height=res,
                  width=res, return_array=True)
    eng = BatchingEngine(pipe, max_wait_ms=5.0, buckets=(1,), pipe_kwargs=speed)
    try:
        eng.submit("warm up", **dict(common, num_inference_steps=2)).result(timeout=900)
        fa.reset_launch_counts()  # this render's main path starts here
        t0 = time.perf_counter()
        img = eng.submit("a red square on a blue field", seed=7, **common).result(timeout=900)
        wall = time.perf_counter() - t0
        used = dict(fa.LAUNCHES)  # and ends here
    finally:
        eng.stop()
    want = render_launches(pipe.unet.config, res, **speed)
    if used != want or eng.stats["errors"]:
        raise AssertionError(f"{label} render: launches {used}, expected {want}; "
                             f"stats {eng.stats}")
    if img.shape != (res, res, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label} render: bad image {img.shape}")
    log(f"{label} render (guided, batch 1, {STEPS} steps, CFG {CFG}, through the "
        f"BatchingEngine): {wall:.3f} s wall ({eng.stats['last_batch_seconds']:.3f} s in the "
        f"pipeline), finite {res}x{res}x3; launches {used}; {card}")
    wall, busy, top = device_profile(torch, lambda: pipe(
        "a red square on a blue field", **dict(common, return_array=False), **speed),
        host=False)
    log(profile_line(f"{label} render profiled, guided batch 1", wall, busy, top)
        + f"; {time.perf_counter() - t_call:.1f} s with the warm-up and the profile")
    return used


def family_http(torch, fa, variant, res, device, card, control_lora=None, warm=False,
                steps=None):
    """`python -m controllora_tpu_torch.serve --model_variant <variant>` (its parse_args,
    build_pipeline and build_server in this process), with `control_lora` saved as an
    artifact and a PNG guide in the request if given, else unguided; with `warm`, its
    --warmup first. One /generate of `steps` (STEPS) steps at res², its launches counted
    from 0 and held to
    render_launches, every one on the route of the server's dtype (FP32_LAUNCHES all
    of them for an fp32 stack, none for a bf16 one). Returns them."""
    import base64
    import threading
    import urllib.request

    import numpy as np

    from controllora_tpu_torch import serve
    from controllora_tpu_torch.serving import BatchingEngine
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    flags = ["--model_variant", variant, "--buckets", "1", "--host", "127.0.0.1", "--port",
             "0", "--device", str(device)] + ["--warmup"] * warm
    steps = steps or STEPS
    request = dict(prompt="a red square", steps=steps, seed=3, width=res, height=res)
    with tempfile.TemporaryDirectory() as control_dir:
        if control_lora is not None:
            save_control_lora(control_dir, control_lora)
            flags += ["--control_lora_dir", control_dir]
            guide = np.random.default_rng(8).integers(0, 256, (res, res, 3), dtype=np.uint8)
            request["guide"] = base64.b64encode(encode_png(guide)).decode()
        args = serve.parse_args(flags)
        t0 = time.perf_counter()
        spipe = serve.build_pipeline(args)
    eng = BatchingEngine(spipe, max_wait_ms=args.max_wait_ms, buckets=(1,))
    server = None
    try:
        if args.warmup:
            serve.warmup(eng)
        build_s = time.perf_counter() - t0
        server = serve.build_server(eng, args.host, args.port, args.result_timeout_s)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        fa.reset_launch_counts()  # the request's main path starts here
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/generate",
                data=json.dumps(request).encode()), timeout=900) as r:
            code, raw = r.status, r.read()
        wall = time.perf_counter() - t0
        used, used32 = dict(fa.LAUNCHES), dict(fa.FP32_LAUNCHES)  # and ends here
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        eng.stop()
    reply = json.loads(raw)
    img = decode_png(base64.b64decode(reply["image"]))
    dtype = spipe.unet.conv_in.weight.dtype
    want = render_launches(spipe.unet.config, res, guided=control_lora is not None,
                           steps=steps)
    want32 = want if dtype == torch.float32 else {n: 0 for n in want}
    if code != 200 or img.shape != (res, res, 3) or used != want or used32 != want32:
        raise AssertionError(f"{variant} server: {code}, image {img.shape}, launches {used} "
                             f"(want {want}), fp32 route {used32} (want {want32})")
    log(f"server (python -m controllora_tpu_torch.serve --model_variant {variant}"
        f"{' --warmup' * warm}): {dtype}, built{' and warmed' * warm} in {build_s:.1f} s; "
        f"one {'guided' if 'guide' in request else 'unguided'} {steps}-step /generate at "
        f"{res}² in "
        f"{wall:.3f} s (server says {reply['seconds']} s), {res}x{res}x3 PNG; launches "
        f"{used}, on the fp32 route {used32}; {card}")
    return used


def phase_family_kernels(torch, fa, device, record):
    """K1 and K2 at the other families' shapes (FAMILY_K1, FAMILY_K2) and K1 at their
    ToMe-merged ones (FAMILY_MERGED_K1, bias batch B) against their plain versions,
    timed with bounds and SDPA as phase_kernels times SD1.5's, into `record`'s
    shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    for (b, h, l, d), label in FAMILY_K1:
        for batch, bc in ((b, 1), (4 * b, 4)):
            k1_case(torch, fa, rnd, record, batch, h, l, d, bc, timed=True,
                    label=f" ({label})")
            gc.collect()
            torch.cuda.empty_cache()
    for (b, h, l, d), label in FAMILY_K2:
        k2_case(torch, fa, device, rnd, record, b, h, l, d, label=f" ({label})")
        torch.cuda.empty_cache()
    for (b, h, l, d), label in FAMILY_MERGED_K1:
        for batch in (b, 4 * b):
            k1_case(torch, fa, rnd, record, batch, h, l, d, batch, timed=True,
                    label=f" ({label})")
            torch.cuda.empty_cache()
    log(f"families kernels {time.perf_counter() - t0:.1f} s")


def phase_families(torch, fa, device, card):
    """SD2.1 and SDXL served at full width on seeded random bf16 weights, and the
    refiner: per family, parity of the card's bf16 stack with an fp32 copy on the
    plain versions, a ToMe 0.5 eval with K1 against its plain version on shared merge
    maps (tome_check), guided renders through the BatchingEngine under exact, tome and
    turbo with exact launches and one profiled render each; SDXL's HTTP server; the
    refiner's folded UNet eval (5 ids) and text tower against their fp32 copies, and
    its unguided eval as the ensemble runs it (the refiner's server, fp32 as
    scripts/serve.py serves it, is driven in phase "fp32"). The stacks are built one
    at a time and freed. Returns the launches of the main paths (renders and
    requests), each counted from 0."""
    from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
    from controllora_tpu_torch.schedulers.common import DiffusionSchedule

    t_phase = time.perf_counter()
    total = {n: 0 for n in fa.LAUNCHES}
    for variant, (res, prediction) in FAMILIES.items():
        t0 = time.perf_counter()
        scheduler = DPMSolverMultistepScheduler(DiffusionSchedule.create(
            prediction_type=prediction))
        pipe = build_stack(torch, device, variant, scheduler)
        log(f"{variant}: stack built in {time.perf_counter() - t0:.1f} s, UNet "
            f"{sum(p.numel() for p in pipe.unet.parameters()) / 1e9:.3f} B parameters; "
            f"K1 {k1_per_eval(pipe.unet.config, res)} a UNet eval at {res}²")
        family_parity(torch, fa, pipe, res, device, variant)
        family_tome_eval(torch, fa, pipe, res, device, variant)
        paths = [family_render(torch, fa, pipe, res, variant, card, preset)
                 for preset in ("exact",) + FAMILY_PRESETS]
        if variant == HTTP_FAMILY:
            paths.append(family_http(torch, fa, variant, res, device, card,
                                     pipe.control_lora))
        for used in paths:
            total = {n: total[n] + used[n] for n in total}
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

    refiner = build_stack(torch, device, REFINER)
    family_parity(torch, fa, refiner, REFINER_RES, device, "refiner", ("unet", "text"))
    refiner_unguided_parity(torch, fa, refiner, REFINER_RES, device)
    del refiner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"families phase {time.perf_counter() - t_phase:.1f} s; main-path launches {total}")
    return total


def family_tome_eval(torch, fa, pipe, res, device, label):
    """tome_check on the family's guided CFG UNet eval at `res` (seeded guide and
    latents)."""
    import numpy as np

    rng = np.random.default_rng(13)
    guide = torch.from_numpy(rng.uniform(-1, 1, (1, 3, res, res)).astype(np.float32))
    lat = torch.from_numpy(rng.normal(size=(2, 4, res // 8, res // 8)).astype(np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        weights, unet = folded_eval(torch, pipe, guide.to(device), lat.to(device), res)
        tome_check(torch, fa, pipe, weights, unet, res, f"{label} {res}²")
        del weights, unet
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label} ToMe eval check {time.perf_counter() - t0:.1f} s")


# the other families' training: SD2.1 768² at batch 4 without remat (v-
# prediction) and SDXL 1024² at batch 2 with remat `dots` (text_time, dual towers)
FAMILY_TRAIN = {"sd21": dict(res=768, batch=4, remat=None, prediction="v_prediction"),
                "sdxl": dict(res=1024, batch=2, remat="dots", prediction="epsilon")}
# K2-K4 at their long self-attentions (B, heads, L, D): K3/K4's D 64 instance on a
# main path; K2 also at the VAE encoder of each batch (D 512); one ragged D 64 shape
FAMILY_TRAIN_ATTN = (((4, 5, 9216, 64), "SD2.1 768² batch 4 level 0"),
                     ((4, 10, 2304, 64), "SD2.1 768² batch 4 level 1"),
                     ((2, 10, 4096, 64), "SDXL 1024² batch 2 level 1"))
FAMILY_TRAIN_VAE = (((4, 1, 9216, 512), "SD2.1 768² batch 4 VAE encoder"),
                    ((2, 1, 16384, 512), "SDXL 1024² batch 2 VAE encoder"))
FAMILY_TRAIN_RAGGED = (2, 5, 4225, 64)
CLI_FAMILY, CLI_RES = "sdxl", 1024  # the family phase "train CLI" trains
DREAMBOOTH_VARIANT = "sd15"
CLI_DEVICE = "cuda"  # the CLIs' --device


def train_launches(unet_config, res, remat):
    """Launches of one ControlLoRA train step at `res`: K2 forward and K3 + K4 backward
    at every long self-attention, K2 once more in the VAE encoder's mid-attention, and
    with remat K2 again where each attention block is recomputed in the backward (the
    checkpoint does not see inside the kernels)."""
    n = k1_per_eval(unet_config, res)
    vae = int((res // 8) ** 2 >= 2048)
    return {"k1": 0, "k2": n * (2 if remat else 1) + vae, "k3": n, "k4": n}


def phase_family_train_kernels(torch, fa, device, record):
    """K2, K3 and K4 at the other families' training shapes against their plain
    versions with times, bounds and SDPA, into `record`'s shapes; the ragged D 64
    shape checked only."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    for (b, h, l, d), label in FAMILY_TRAIN_ATTN:
        k2_case(torch, fa, device, rnd, record, b, h, l, d, label=f" ({label})")
        bwd_case(torch, fa, rnd, record, b, h, l, d, timed=True, label=f" ({label})")
        gc.collect()
        torch.cuda.empty_cache()
    bwd_case(torch, fa, rnd, record, *FAMILY_TRAIN_RAGGED, timed=False,
             label=" (ragged D 64)")
    for (b, h, l, d), label in FAMILY_TRAIN_VAE:
        k2_case(torch, fa, device, rnd, record, b, h, l, d, label=f" ({label})")
        torch.cuda.empty_cache()
    log(f"family train kernels {time.perf_counter() - t0:.1f} s")


def family_train_parity(torch, pipe, res, label):
    """One train step's loss and adapter gradient at batch 1 on the card: the bf16
    stack (kernels) against an fp32 copy of the UNet and text encoder with every
    attention plain (fp32 side rematerialised to fit), same latents, guide, ids,
    noise and t; relative within REL_BOUND."""
    import functools

    import numpy as np

    from controllora_tpu_torch.training.trainer import ControlLoRATrainer

    rng = np.random.default_rng(5)
    device = pipe.unet.conv_in.weight.device
    side = res // 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    batch = {"latents": t(rng.normal(size=(1, 4, side, side))),
             "guide_values": t(rng.uniform(-1, 1, (1, 3, res, res))),
             "input_ids": torch.from_numpy(rng.integers(0, 49407, (1, 77))).to(device)}
    draws = dict(noise=t(rng.normal(size=(1, 4, side, side))),
                 timesteps=torch.tensor([500], device=device))
    t0 = time.perf_counter()

    def run(unet, text, hint_dtype, remat):
        trainer = ControlLoRATrainer(pipe.control_lora, unet, pipe.vae, text,
                                     prediction_type=pipe.scheduler.schedule.prediction_type,
                                     hint_compute_dtype=hint_dtype, remat_unet=remat,
                                     remat_policy="nothing")
        loss = trainer.loss(batch, **draws)
        grad = torch.cat([g.detach().float().flatten() for g in trainer.grads(loss)])
        return loss.item(), grad

    loss, grad = run(pipe.unet, pipe.text_encoder, torch.bfloat16, False)
    unet32 = fp32_copy(torch, pipe.unet, device)
    unet32.forward = functools.partial(unet32.forward, attention_backend="xla")
    text32 = fp32_copy(torch, pipe.text_encoder, device)
    ref_loss, ref_grad = run(unet32, text32, None, True)
    del unet32, text32
    gc.collect()
    torch.cuda.empty_cache()
    errs = {"train loss": abs(loss - ref_loss) / abs(ref_loss),
            "adapter gradient": rel_l2(grad, ref_grad)}
    for name, err in errs.items():
        log(f"{label} train parity {name}: card bf16 (kernels) vs card fp32 (plain "
            f"versions) relative {err:.4e} <= {REL_BOUND}")
    log(f"{label} train parity: loss {loss:.6f} vs {ref_loss:.6f}; |grad| "
        f"{grad.norm():.4e} vs {ref_grad.norm():.4e}; {time.perf_counter() - t0:.1f} s")
    if not (math.isfinite(loss) and bool(grad.isfinite().all()) and ref_grad.norm() > 0):
        raise AssertionError(f"{label} train parity: non-finite or zero result")
    bad = {k: v for k, v in errs.items() if not v <= REL_BOUND}
    if bad:
        raise AssertionError(f"{label} train parity outside {REL_BOUND}: {bad}")


def family_train(torch, fa, pipe, label, res, batch, remat, card):
    """The family's training main path: ControlLoRATrainer.train_step at res² on
    native fill50k batches, bf16 stack, `base` re-derived: 2 warm-up and 3 timed
    steps on the host clock with exact launches per step, finite losses, nonzero
    gradients, params updated, peak memory; then one profiled step. Returns the
    launches of the timed steps, counted from 0."""
    from controllora_tpu_torch.data.fastloader import NativeFill50kBatcher
    from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch

    data = iter(NativeFill50kBatcher(Fill50kSynthetic(HashTokenizer(), resolution=res),
                                     batch, seed=0))
    batches = [to_device_batch(next(data), pipe.unet.conv_in.weight.device)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    trainer = ControlLoRATrainer(pipe.control_lora, pipe.unet, pipe.vae, pipe.text_encoder,
                                 prediction_type=pipe.scheduler.schedule.prediction_type,
                                 hint_compute_dtype=torch.bfloat16,
                                 remat_unet=remat is not None, remat_policy=remat or "dots")
    gen = torch.Generator(device=batches[0]["pixel_values"].device).manual_seed(0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for b in batches[:TRAIN_WARMUP]:
        trainer.train_step(b, gen)
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in trainer.params]
    want = train_launches(pipe.unet.config, res, remat)
    fa.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    metrics, per_step = [], []
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        c0 = dict(fa.LAUNCHES)
        metrics.append(trainer.train_step(b, gen))
        per_step.append(launched(fa, c0))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    total = dict(fa.LAUNCHES)  # the main path ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    changed = sum(not torch.equal(a, p.detach()) for a, p in zip(before, trainer.params))
    log(f"{label} train {res}² batch {batch}, remat {remat or 'off'}: {step_s * 1e3:.1f} "
        f"ms/step, {batch / step_s:.3f} img/s, peak {peak:.2f} GiB allocated ({resident:.2f} "
        "GiB resident before); losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad norms " + ", ".join(f"{x:.4f}" for x in norms)
        + f"; {changed}/{len(before)} params changed; launches per step {per_step[0]}; {card}")
    if any(p != want for p in per_step):
        raise AssertionError(f"{label} train launches per step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"{label} train: losses {losses}, grad norms {norms}")
    if changed == 0:
        raise AssertionError(f"{label} train: no adapter parameter changed")
    wall, busy, top = device_profile(torch, lambda: trainer.train_step(batches[-1], gen))
    log(profile_line(f"{label} train profiled step", wall, busy, top)
        + f"; idle share against the unprofiled step {1 - busy / step_s:.3f}; top kernels: "
        + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top[:8]))
    return total


def phase_family_train(torch, fa, device, card):
    """SD2.1 and SDXL ControlLoRA training at full width on seeded random bf16
    weights: per family the train-step parity on the card and the timed, profiled
    steps. The stacks are built one at a time and freed. Returns the launches of the
    timed steps."""
    from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
    from controllora_tpu_torch.schedulers.common import DiffusionSchedule

    t_phase = time.perf_counter()
    total = {n: 0 for n in fa.LAUNCHES}
    for variant, c in FAMILY_TRAIN.items():
        scheduler = DPMSolverMultistepScheduler(DiffusionSchedule.create(
            prediction_type=c["prediction"]))
        pipe = build_stack(torch, device, variant, scheduler)
        family_train_parity(torch, pipe, c["res"], variant)
        used = family_train(torch, fa, pipe, variant, c["res"], c["batch"], c["remat"], card)
        total = {n: total[n] + used[n] for n in total}
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    log(f"family train phase {time.perf_counter() - t_phase:.1f} s; main-path launches {total}")
    return total


# the other render modes (phase "modes"): SD1.5 at RES with the `base` ControlLoRA,
# STEPS steps at CFG; img2img and inpaint at STRENGTH, the hires fix RES -> 2 * RES at
# HIRES_STRENGTH, a rank-MIX_RANK LoRA chained before the ControlLoRA, and the SDXL
# base -> refiner ensemble split at SPLIT through the sample CLI
STRENGTH, HIRES_STRENGTH, HIRES_SCALE, SPLIT, MIX_RANK = 0.8, 0.55, 2.0, 0.8, 4
ENSEMBLE, ENSEMBLE_REFINER, ENSEMBLE_RES = "sdxl", "sdxl-refiner", 1024
MIX_VARIANT = "sd15"  # the mix_lora CLI's --model_variant
# K1 at the hires pass's self-attentions (SD1.5 at 1024²: level 0 at D 40, level 1 at
# D 80) and K2 at the refiner's unguided level 1, batch-1 renders
MODES_K1 = (((2, 8, 16384, 40), "SD1.5 1024² hires level 0"),
            ((2, 8, 4096, 80), "SD1.5 1024² hires level 1"))
MODES_K2 = (((2, 12, 4096, 64), "refiner 1024² level 1, unguided"),)


def phase_mode_kernels(torch, fa, device, record):
    """K1 and K2 at the render modes' new shapes (MODES_K1, MODES_K2) against their
    plain versions, timed with bounds and SDPA as phase_kernels times SD1.5's, into
    `record`'s shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    for (b, h, l, d), label in MODES_K1:
        k1_case(torch, fa, rnd, record, b, h, l, d, 1, timed=True, label=f" ({label})")
        gc.collect()
        torch.cuda.empty_cache()
    for (b, h, l, d), label in MODES_K2:
        k2_case(torch, fa, device, rnd, record, b, h, l, d, label=f" ({label})")
        torch.cuda.empty_cache()
    log(f"modes kernels {time.perf_counter() - t0:.1f} s")


def vae_launches(res):
    """K2 launches of one VAE encode or decode at `res` (its mid-attention)."""
    from controllora_tpu_torch.ops.attention import FLASH_MIN_LEN

    return int((res // 8) ** 2 >= FLASH_MIN_LEN)


def mode_launches(sd15, xl, refiner):
    """Each mode's launches, from the configs: a long self-attention takes K1 when its
    layer folds (k1_per_eval counts them) and K2 when it runs threaded or without
    adapters; each VAE encode and decode launches K2 once."""
    per = k1_per_eval(sd15, RES)
    hires_res = int(round(RES * HIRES_SCALE / 64)) * 64
    img2img = {"k1": int(STEPS * STRENGTH) * per, "k2": 2 * vae_launches(RES)}
    base_evals = int(round(STEPS * SPLIT))
    return {
        "mix": {"k1": 0, "k2": STEPS * per + vae_launches(RES)},
        "img2img": img2img,
        "inpaint": dict(img2img),
        "hires": {"k1": STEPS * per + int(STEPS * HIRES_STRENGTH) * k1_per_eval(sd15, hires_res),
                  "k2": vae_launches(RES) + 2 * vae_launches(hires_res)},
        "ensemble": {"k1": base_evals * k1_per_eval(xl, ENSEMBLE_RES),
                     "k2": ((STEPS - base_evals) * k1_per_eval(refiner, ENSEMBLE_RES)
                            + vae_launches(ENSEMBLE_RES))},
    }


def profiled_calls(torch, cls, calls):
    """Patch cls.__call__ so that each call runs under device_profile, appending
    (wall s, device busy s, top kernels) to `calls`; returns the undo."""
    original = cls.__call__

    def call(self, *a, **kw):
        out = []
        calls.append(device_profile(torch, lambda: out.append(original(self, *a, **kw)),
                                    host=False))
        return out[0]

    cls.__call__ = call
    return lambda: setattr(cls, "__call__", original)


def threaded_parity(torch, fa, pipe, guide, loras, device):
    """One CFG UNet eval at RES of the ControlLoRA with `loras` chained before it
    (threaded, K2 in the long self-attentions) on the card's bf16 stack against an fp32
    copy on the card with every attention plain; and a zero-up LoRA chained the same
    way (threaded, K2) against the folded eval (K1), both bf16. Returns the two
    relative L2 errors."""
    from controllora_tpu_torch.models.lora import make_plain_lora_adapters
    from controllora_tpu_torch.ops.folding import fold_adapters
    from controllora_tpu_torch.pipelines import merge_extra_loras
    from controllora_tpu_torch.pipelines.text_to_image import _cast_controls
    from torch.func import functional_call

    gen = torch.Generator(device=device).manual_seed(21)
    cfg, side, dtype = pipe.unet.config, RES // 8, pipe.unet.conv_in.weight.dtype
    lat = torch.randn((2, 4, side, side), generator=gen, device=device)
    t = torch.tensor([500.0, 500.0], device=device)
    with torch.inference_mode():
        ctx = pipe.text_encoder(torch.randint(0, 49407, (2, 77), generator=gen,
                                              device=device))
        control = pipe.control_lora.adapters_for(guide, cfg)
        chained = merge_extra_loras(control, loras, "pre")
        before = dict(fa.LAUNCHES)
        # the render's own cast of the control states to the compute dtype
        eps = pipe.unet(lat, t, ctx, adapters=_cast_controls(chained, dtype))
        torch.cuda.synchronize()
        used = launched(fa, before)
        unet32 = fp32_copy(torch, pipe.unet, device)
        before = dict(fa.LAUNCHES)
        eps32 = unet32(lat, t, ctx, adapters=chained, attention_backend="xla")
        torch.cuda.synchronize()
        used32 = launched(fa, before)
        del unet32
        mix_err = rel_l2(eps, eps32)
        del eps32
        fresh = make_plain_lora_adapters(gen, MIX_RANK, cfg, device=device)
        threaded = pipe.unet(lat, t, ctx, adapters=_cast_controls(
            merge_extra_loras(control, fresh, "pre"), dtype))
        weights, biases = fold_adapters(pipe.unet, control)
        folded = functional_call(pipe.unet, weights, (lat, t, ctx), dict(
            biases={k: b.to(torch.bfloat16) for k, b in biases.items()}))
        zero_err = rel_l2(threaded, folded)
        del weights, biases
    gc.collect()
    torch.cuda.empty_cache()
    want = {"k1": 0, "k2": k1_per_eval(cfg, RES), "k3": 0, "k4": 0}
    log(f"mix parity: the threaded eval (ControlLoRA + a pre-chained rank-{MIX_RANK} LoRA) "
        f"card bf16 (kernels) vs card fp32 (plain versions) relative L2 {mix_err:.4e} <= "
        f"{REL_BOUND}, launches bf16 {used}, fp32 {used32}; a zero-up LoRA chained "
        f"(threaded, K2) vs the folded eval (K1), both bf16: {zero_err:.4e} <= {REL_BOUND}")
    if used != want or any(used32.values()):
        raise AssertionError(f"mix parity launches: bf16 {used} (want {want}), fp32 {used32}")
    if not (mix_err <= REL_BOUND and zero_err <= REL_BOUND and torch.isfinite(eps).all()):
        raise AssertionError(f"mix parity: threaded {mix_err}, zero-up chain {zero_err}")
    return mix_err, zero_err


def phase_modes(torch, fa, pipe, device, card):
    """The render modes and sampling entry points at full width on seeded bf16
    weights, each render's launches counted from 0 and held to mode_launches, each
    under torch.profiler (device busy time per mode): SD1.5 at RES with the `base`
    ControlLoRA and a pre-chained rank-4 LoRA (threaded, K2), img2img and inpaint at
    STRENGTH, the hires fix RES -> 2 * RES; threaded_parity; inpaint's unmasked latents
    equal to the init's; the SDXL base -> refiner ensemble through
    `controllora_tpu_torch.sample`'s main in this process; `python -m
    controllora_tpu_torch.mix_lora` from a .safetensors LoRA written by the port's
    writer. Returns the summed launches of the counted renders."""
    import numpy as np

    from controllora_tpu_torch import sample
    from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.models.lora import make_plain_lora_adapters
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline, hires_fix
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.utils.convert import attn_procs_to_torch, save_state_dict
    from controllora_tpu_torch.utils.png import decode_png

    t_phase = time.perf_counter()
    # a fresh pipeline (its own DPM-Solver++) over the SD1.5 stack of the earlier phases
    sd = StableDiffusionControlLoRAPipeline(pipe.unet, pipe.vae, pipe.text_encoder,
                                            pipe.tokenizer, pipe.control_lora, device=device)
    want = mode_launches(sd.unet.config, zoo.VARIANTS[ENSEMBLE][0],
                         zoo.VARIANTS[ENSEMBLE_REFINER][0])
    item = Fill50kSynthetic(HashTokenizer(), resolution=RES)[3]
    guide = item["guide_values"].astype(np.float32)
    init = item["pixel_values"].astype(np.float32)
    mask = np.zeros((RES, RES), np.float32)
    mask[:, :RES // 2] = 1.0  # repaint the left half
    gen = torch.Generator(device=device).manual_seed(17)
    loras = make_plain_lora_adapters(gen, MIX_RANK, sd.unet.config, device=device)
    for a in loras.values():  # fresh up factors are zero: make the LoRA act
        for pair in a.params.values():
            pair["up"].normal_(0.0, 0.01, generator=gen)
    common = dict(guide=guide, num_inference_steps=STEPS, guidance_scale=CFG,
                  return_array=True)
    renders = {
        "mix": lambda: sd("a sks circle", extra_loras=loras, extra_loras_where="pre",
                          **common),
        "img2img": lambda: sd("a red circle", image=init, strength=STRENGTH, **common),
        "inpaint": lambda: sd("a red circle", image=init, mask=mask, strength=STRENGTH,
                              **common),
        "hires": lambda: hires_fix(sd, "a red circle", height=RES, width=RES,
                                   scale=HIRES_SCALE, strength=HIRES_STRENGTH, **common),
    }
    sd("warm up", **dict(common, num_inference_steps=2))
    total, images, busy = {n: 0 for n in fa.LAUNCHES}, {}, {}
    for name, render in renders.items():
        calls, t0 = [], time.perf_counter()
        undo = profiled_calls(torch, StableDiffusionControlLoRAPipeline, calls)
        fa.reset_launch_counts()  # this render's main path starts here
        try:
            images[name] = render()[0]
        finally:
            undo()
        used = dict(fa.LAUNCHES)  # and ends here
        expect = dict(want[name], k3=0, k4=0)
        if used != expect:
            raise AssertionError(f"mode {name}: launches {used}, expected {expect}")
        busy[name] = sum(c[1] for c in calls)
        total = {n: total[n] + used[n] for n in total}
        for i, (wall, dev, top) in enumerate(calls):
            log(profile_line(f"mode {name}" + (f" pass {i + 1}" if len(calls) > 1 else ""),
                             wall, dev, top))
        log(f"mode {name}: launches {used}; device busy {busy[name] * 1e3:.1f} ms; "
            f"{time.perf_counter() - t0:.1f} s with the profiler's gathering; {card}")
    shapes = {k: v.shape for k, v in images.items()}
    hires_side = int(round(RES * HIRES_SCALE / 64)) * 64
    if (any(shapes[k] != (RES, RES, 3) for k in ("mix", "img2img", "inpaint"))
            or shapes["hires"] != (hires_side, hires_side, 3)
            or not all(np.isfinite(v).all() for v in images.values())):
        raise AssertionError(f"modes: images {shapes}")

    # inpaint keeps the known region: its latents outside the mask (past the column
    # the antialiased resize blends) are the init's, exactly
    lat = sd("a red circle", image=init, mask=mask, strength=STRENGTH,
             **dict(common, return_array=False), return_latents=True)[0]
    init_lat = sd.encode_image(init[None]).permute(0, 2, 3, 1).cpu().numpy()[0]
    edge = RES // 16 + 1
    kept = float(np.abs(lat[:, edge:] - init_lat[:, edge:]).max())
    moved = float(np.abs(lat[:, :edge - 1] - init_lat[:, :edge - 1]).mean())
    with torch.inference_mode():
        roundtrip = sd.vae.decode(torch.from_numpy(init_lat).permute(2, 0, 1)[None]
                                  .to(device)).float().permute(0, 2, 3, 1).cpu().numpy()[0]
    gap = np.abs(images["inpaint"] - roundtrip)
    log(f"inpaint: unmasked latents vs the init's max|delta| {kept:.3e} (repainted half "
        f"mean {moved:.3e}); pixels vs the VAE round trip: unmasked half mean "
        f"{gap[:, RES // 2 + 8:].mean():.4f}, repainted half mean {gap[:, :RES // 2].mean():.4f}")
    if not (kept <= 1e-6 and moved > 1e-3):
        raise AssertionError(f"inpaint: unmasked latents moved by {kept}, repainted {moved}")

    threaded_parity(torch, fa, sd, torch.from_numpy(guide[None]).permute(0, 3, 1, 2)
                    .to(device), loras, device)

    with tempfile.TemporaryDirectory() as tmp:
        # the SDXL base -> refiner ensemble through the sample CLI, in this process
        control_dir = os.path.join(tmp, "sdxl-control")
        xl_control = base_control(torch, zoo.VARIANTS[ENSEMBLE][0], device,
                                  torch.Generator(device=device).manual_seed(0))
        save_control_lora(control_dir, xl_control)
        del xl_control
        gc.collect()
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "ensemble")
        calls = []
        undo = profiled_calls(torch, StableDiffusionControlLoRAPipeline, calls)
        fa.reset_launch_counts()  # the CLI's main path starts here
        t0 = time.perf_counter()
        try:
            sample.main(["--model_variant", ENSEMBLE, "--control_lora_dir", control_dir,
                         "--refiner_variant", ENSEMBLE_REFINER, "--denoising_split",
                         str(SPLIT), "--resolution", str(ENSEMBLE_RES),
                         "--num_inference_steps", str(STEPS), "--guidance_scale", str(CFG),
                         "--num_validation_images", "1", "--output_dir", out,
                         "--device", str(device)])
        finally:
            undo()
        wall = time.perf_counter() - t0
        used = dict(fa.LAUNCHES)  # and ends here
        with open(os.path.join(out, "0.png"), "rb") as f:
            montage = decode_png(f.read())
        gc.collect()
        torch.cuda.empty_cache()
        expect = dict(want["ensemble"], k3=0, k4=0)
        if used != expect or montage.shape != (ENSEMBLE_RES, 3 * ENSEMBLE_RES, 3):
            raise AssertionError(f"ensemble: launches {used} (want {expect}), montage "
                                 f"{montage.shape}")
        busy["ensemble"] = sum(c[1] for c in calls)
        total = {n: total[n] + used[n] for n in total}
        for label, (cwall, dev, top) in zip(("base", "refiner"), calls):
            log(profile_line(f"mode ensemble {label}", cwall, dev, top))
        log(f"mode ensemble: python -m controllora_tpu_torch.sample --model_variant "
            f"{ENSEMBLE} --refiner_variant {ENSEMBLE_REFINER} --denoising_split {SPLIT} at "
            f"{ENSEMBLE_RES}² in this process, {wall:.1f} s with both stacks' build; "
            f"montage {montage.shape}; launches {used}; device busy "
            f"{busy['ensemble'] * 1e3:.1f} ms; {card}")

        # python -m controllora_tpu_torch.mix_lora from the port's own .safetensors
        lora_path = os.path.join(tmp, "pytorch_lora_weights.safetensors")
        save_state_dict(attn_procs_to_torch(loras), lora_path)
        sd_dir = os.path.join(tmp, "sd15-control")
        save_control_lora(sd_dir, sd.control_lora)
        t0 = time.perf_counter()
        stdout = run_cli("controllora_tpu_torch.mix_lora", [
            "--model_variant", MIX_VARIANT, "--control_lora_dir", sd_dir, "--lora_weights",
            lora_path, "--prompt", "a sks circle", "--num_inference_steps", str(STEPS),
            "--guidance_scale", str(CFG), "--resolution", str(RES), "--output_dir",
            os.path.join(tmp, "mix"), "--device", str(device)])
        with open(os.path.join(tmp, "mix", "0.png"), "rb") as f:
            mixed = decode_png(f.read())
    if mixed.shape != (RES, RES, 3) or "plain LoRA adapters + ControlLoRA" not in stdout:
        raise AssertionError(f"mix_lora CLI: image {mixed.shape}\n{stdout[-1500:]}")
    log(f"mix_lora CLI: python -m controllora_tpu_torch.mix_lora --model_variant {MIX_VARIANT} at "
        f"{RES}², {STEPS} steps: {time.perf_counter() - t0:.1f} s with its start and stack "
        f"build, {mixed.shape} PNG")
    log(f"modes phase {time.perf_counter() - t_phase:.1f} s; main-path launches {total}; "
        "device busy by mode " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in busy.items()))
    return total


def run_cli(module, args, timeout=900):
    """`python -m <module> <args>` from the repository root; its stdout, or a failure
    with the ends of both streams."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0 or "nan" in proc.stdout:
        raise AssertionError(f"{module} ({proc.returncode}):\n{proc.stdout[-1500:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def phase_train_cli(torch, card):
    """`python -m controllora_tpu_torch.train --model_variant sdxl --resolution 1024`
    for 3 steps at batch 2 (remat dots) with --validation_steps 2 --report_to jsonl:
    metrics.jsonl holds the 3 step lines, the validation montage decodes to a
    1024 x 3072 RGB image, and the CLI used the native data plane."""
    import sysconfig

    from controllora_tpu_torch.utils.png import decode_png

    # the JAX package builds its fastloader as a CPython extension; the port's copy
    # is a plain C library (ctypes), which needs no Python headers: record whether
    # this machine has them
    include = sysconfig.get_paths()["include"]
    python_h = os.path.exists(os.path.join(include, "Python.h"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        stdout = run_cli("controllora_tpu_torch.train", [
            "--model_variant", CLI_FAMILY, "--resolution", str(CLI_RES),
            "--train_batch_size", "2", "--gradient_checkpointing", "--remat_policy", "dots",
            "--max_train_steps", "3", "--log_every", "1", "--validation_steps", "2",
            "--report_to", "jsonl", "--checkpointing_steps", "0", "--output_dir", out,
            "--device", CLI_DEVICE])
        with open(os.path.join(out, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        with open(os.path.join(out, "images", "validation-2.png"), "rb") as f:
            img = decode_png(f.read())
    plane = [ln for ln in stdout.splitlines() if ln.startswith("data plane:")]
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    if [r["step"] for r in lines] != [1, 2, 3] or len(steps) != 3:
        raise AssertionError(f"train CLI sdxl: metrics {lines}\n{stdout[-1500:]}")
    if img.shape != (CLI_RES, 3 * CLI_RES, 3):
        raise AssertionError(f"train CLI sdxl: validation image {img.shape}")
    if not plane or "native" not in plane[0]:
        raise AssertionError(f"train CLI sdxl: data plane {plane}")
    log(f"train CLI: python -m controllora_tpu_torch.train --model_variant {CLI_FAMILY} "
        f"{CLI_RES}² batch 2, 3 steps + validation at step 2 in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{plane[0]}; metrics.jsonl steps {[r['step'] for r in lines]} "
        "(losses " + ", ".join(f"{r['train_loss']:.4f}" for r in lines) + "); "
        f"validation montage {img.shape}; {steps[-1]}; Python.h for a CPython "
        f"extension build {'present' if python_h else 'absent'} ({include}); {card}")


def phase_dreambooth(torch, fa, card):
    """`python -m controllora_tpu_torch.train_dreambooth` (its main in this process,
    so that the launch counters are read here) on SD1.5 at 512²: 2 instance PNGs
    from fill50k, prior preservation with 2 class images sampled by the frozen stack,
    3 steps at batch 1 (+ 1 class row), one validation image after epoch 0 and one
    after training (the LoRA folded into the UNet: K1 without biases); the
    .safetensors and .bin written equal the trained LoRA bit for bit, and each step
    launches exactly {k2 6, k3 5, k4 5}. Returns the launches of the train steps."""
    import contextlib
    import io

    import numpy as np

    from controllora_tpu_torch import train_dreambooth as cli
    from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.training.dreambooth import DreamBoothLoRATrainer
    from controllora_tpu_torch.utils.convert import load_state_dict
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    gc.collect()
    torch.cuda.empty_cache()
    ds = Fill50kSynthetic(HashTokenizer(), resolution=RES)
    seen, per_step = [], []
    train_step = DreamBoothLoRATrainer.train_step

    def counted(self, *a, **kw):  # each train step's launches, and the trainer
        c0 = dict(fa.LAUNCHES)
        out = train_step(self, *a, **kw)
        torch.cuda.synchronize()
        per_step.append(launched(fa, c0))
        seen[:] = [self]
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        inst = os.path.join(tmp, "instance")
        os.makedirs(inst)
        for i in range(2):
            with open(os.path.join(inst, f"instance-{i}.png"), "wb") as f:
                f.write(encode_png(np.clip((ds[i]["pixel_values"] + 1) * 127.5, 0, 255)
                                   .astype(np.uint8)))
        out, buf = os.path.join(tmp, "out"), io.StringIO()
        DreamBoothLoRATrainer.train_step = counted  # shadows AdapterTrainer's
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["--model_variant", DREAMBOOTH_VARIANT, "--resolution", str(RES),
                          "--instance_data_dir", inst, "--instance_prompt", "a sks circle",
                          "--with_prior_preservation", "--class_prompt", "a circle",
                          "--class_data_dir", os.path.join(tmp, "class"),
                          "--sample_class_images", "--num_class_images", "2",
                          "--max_train_steps", "3", "--log_every", "1",
                          "--validation_prompt", "a sks circle", "--num_validation_images",
                          "1", "--checkpointing_steps", "0", "--lr_warmup_steps", "0",
                          "--output_dir", out, "--device", CLI_DEVICE])
        finally:
            del DreamBoothLoRATrainer.train_step
        stdout = buf.getvalue()
        trained = seen[0].state_dict()
        files = {fmt: load_state_dict(os.path.join(out, f"pytorch_lora_weights.{fmt}"))
                 for fmt in ("safetensors", "bin")}
        classes = sorted(os.listdir(os.path.join(tmp, "class")))
        images = sorted(os.listdir(os.path.join(out, "images")))
        val = decode_png(open(os.path.join(out, "images", images[-1]), "rb").read())
    want = dict(TRAIN_LAUNCHES)
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    for fmt, sd in files.items():
        if set(sd) != set(trained) or not all(
                sd[k].dtype == trained[k].dtype and np.array_equal(sd[k], trained[k])
                for k in trained):
            raise AssertionError(f"dreambooth: the .{fmt} LoRA differs from the trained one")
    if len(per_step) != 3 or any(p != want for p in per_step) or len(steps) != 3:
        raise AssertionError(f"dreambooth: launches per step {per_step} (want {want})\n"
                             + stdout[-1500:])
    if len(classes) != 2 or val.shape != (RES, RES, 3):
        raise AssertionError(f"dreambooth: class images {classes}, validation {images}")
    if max(float(np.abs(v).max()) for k, v in trained.items() if ".up." in k) <= 0:
        raise AssertionError("dreambooth: the LoRA's up factors did not move")
    total = {n: sum(p[n] for p in per_step) for n in want}
    log(f"dreambooth: python -m controllora_tpu_torch.train_dreambooth SD1.5 {RES}², prior "
        f"preservation (2 sampled class images), 3 steps at batch 1 + 1 class row, "
        f"validation images {images}: {time.perf_counter() - t0:.1f} s; {steps[-1]}; "
        f".safetensors and .bin equal the trained LoRA bit for bit ({len(trained)} "
        f"tensors); launches per step {per_step[0]}; {card}")
    return total


# phase "weights": the real-weights path at SD1.5's full width. The canned train_canny
# task trains at batch 1 (tasks/_launch.py), which gives K2-K4 this shape
WEIGHTS_VARIANT = "sd15"
CANNY_TRAIN_SHAPE = (1, 8, 4096, 40)
CANNY_SIZES = (512, 1024)
CANNY_PAIRS = ((50, 150), (100, 200), (30, 80))
CLIP_MERGES = ("a </w>", "r e", "re d</w>", "s q", "sq u", "squ a", "squa re</w>", "o n</w>",
               "b l", "bl u", "blu e</w>", "f i", "fi e", "fie l", "fiel d</w>")


def phase_canny_train_kernels(torch, fa, device, record):
    """K2, K3 and K4 at the canned train_canny task's shape, batch 1 at 512²
    (CANNY_TRAIN_SHAPE), against their plain versions with times, bounds and SDPA,
    into `record`'s shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(14)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    label = " (train_canny 512² batch 1)"
    k2_case(torch, fa, device, rnd, record, *CANNY_TRAIN_SHAPE, label=label)
    bwd_case(torch, fa, rnd, record, *CANNY_TRAIN_SHAPE, timed=True, label=label)
    torch.cuda.empty_cache()
    log(f"train_canny kernels {time.perf_counter() - t0:.1f} s")


def write_checkpoint(torch, root, unet, vae, text):
    """A diffusers-layout directory (unet/, vae/, text_encoder/) of the stack's
    weights as F16, the form of SD1.5's published fp16 files; returns the F16 state
    dicts by component."""
    from controllora_tpu_torch.utils.convert import save_state_dict

    sds = {}
    for sub, module, name in (("unet", unet, "diffusion_pytorch_model"),
                              ("vae", vae, "diffusion_pytorch_model"),
                              ("text_encoder", text, "model")):
        sds[sub] = {k: v.detach().to(torch.float16).cpu() for k, v in module.state_dict().items()}
        os.makedirs(os.path.join(root, sub))
        save_state_dict(sds[sub], os.path.join(root, sub, f"{name}.safetensors"))
    return sds


def write_clip_vocab(root):
    """A small CLIP BPE asset directory (merges.txt + the vocab.json openai/CLIP
    builds from it) for the CLIs' require_clip."""
    from controllora_tpu_torch.data.tokenizer import CLIPBPETokenizer

    os.makedirs(root)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(CLIP_MERGES) + "\n")
    tok = CLIPBPETokenizer.from_files(None, os.path.join(root, "merges.txt"))
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(tok.encoder, f)


def weights_render(torch, fa, pipe, guide, label):
    """One guided RES² render of STEPS steps at CFG, its launches counted from 0 and
    held to render_launches; returns (image, launches, wall s)."""
    fa.reset_launch_counts()  # this render's main path starts here
    t0 = time.perf_counter()
    img = pipe("a red square on a blue field", guide=guide, num_inference_steps=STEPS,
               guidance_scale=CFG, generator=torch.Generator().manual_seed(7),
               return_array=True)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = dict(fa.LAUNCHES)  # and ends here
    want = render_launches(pipe.unet.config, RES)
    if used != want:
        raise AssertionError(f"weights {label} render: launches {used}, expected {want}")
    return img, used, wall


def weights_app(torch, fa, ckpt, control_dir, device, card):
    """The canny2image app's web UI on the card: one POST /api with a RES² PNG, 20
    steps, 1 sample; the answer is the inverted edge map and a RES² PNG sample.
    Returns the request's launches."""
    import base64
    import threading
    import urllib.request
    from types import SimpleNamespace

    from controllora_tpu_torch.apps import canny2image
    from controllora_tpu_torch.apps.webui import build_server
    from controllora_tpu_torch.data.process_datasets import _procedural_image
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    t0 = time.perf_counter()
    process = canny2image.build_processor(SimpleNamespace(
        pretrained_model_name_or_path=ckpt, model_variant=WEIGHTS_VARIANT,
        control_lora_dir=control_dir, device=str(device)))
    build_s = time.perf_counter() - t0
    server = build_server("canny2image", process, canny2image.DEFAULTS, host="127.0.0.1",
                          port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = dict(image=base64.b64encode(encode_png(_procedural_image(3, RES))).decode("ascii"),
                prompt="a bird", num_samples=1, image_resolution=RES, ddim_steps=STEPS,
                scale=CFG, seed=42, low_threshold=100, high_threshold=200)
    try:
        fa.reset_launch_counts()  # the request's main path starts here
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/api",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=900).read())
        wall = time.perf_counter() - t0
        used = dict(fa.LAUNCHES)  # and ends here
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.server_close()
    images = [decode_png(base64.b64decode(b)) for b in out["images"]]
    want = render_launches(zoo.VARIANTS[WEIGHTS_VARIANT][0], RES)
    if ([im.shape for im in images] != [(RES, RES, 3)] * 2 or used != want
            or not (255 - images[0]).any()):
        raise AssertionError(f"app: images {[im.shape for im in images]}, launches {used} "
                             f"(want {want})")
    log(f"weights app: POST /api to python -m controllora_tpu_torch.apps.canny2image's web "
        f"UI (stack loaded from the directory in {build_s:.1f} s): {RES}² PNG in, "
        f"{STEPS} steps, 1 sample: {wall:.3f} s wall; answered {len(images)} {RES}² PNGs; "
        f"launches {used}; {card}")
    return used


def phase_weights(torch, fa, card):
    """The real-weights path at full width (WEIGHTS_VARIANT at RES): the seeded bf16
    stack written as a diffusers-layout F16 checkpoint directory (and a small CLIP
    vocab); zoo.load_frozen on the card, each tensor bitwise equal to the F16 source
    cast to bf16, with its seconds and peak GiB; one guided render through the
    loaded stack bitwise equal to the in-memory stack's cast the same way, launches
    exactly render_launches each; the Canny annotator on the card equal to the CPU's
    at CANNY_SIZES and CANNY_PAIRS, with ms per image; the canny2image web UI
    answering one POST /api; then `python -m controllora_tpu_torch.tasks train_canny`
    (3 steps, batch 1, diffusiondb_canny, K2-K4), `tasks test_canny` on its output,
    and the three convert_checkpoint commands, each exiting 0, the exported artifact
    equal to the run's. Returns the summed launches of the in-process main paths."""
    import re

    import numpy as np

    from controllora_tpu_torch.annotators import canny
    from controllora_tpu_torch.data.process_datasets import _procedural_image
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.utils.png import decode_png

    t_phase = time.perf_counter()
    device = torch.device(CLI_DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    old_vocab = os.environ.get("CLIP_VOCAB_DIR")
    total = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. a local checkpoint directory and a CLIP vocab
        pipe = build_stack(torch, device, WEIGHTS_VARIANT)
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "sd")
        sds = write_checkpoint(torch, ckpt, pipe.unet, pipe.vae, pipe.text_encoder)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
        write_s = time.perf_counter() - t0
        os.environ["CLIP_VOCAB_DIR"] = os.path.join(tmp, "vocab")
        write_clip_vocab(os.environ["CLIP_VOCAB_DIR"])
        control_dir = os.path.join(tmp, "control")
        save_control_lora(control_dir, pipe.control_lora)

        # 2. load it on the card
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded = zoo.load_frozen(ckpt, WEIGHTS_VARIANT, torch.bfloat16, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        n = 0
        for sub, module in zip(("unet", "vae", "text_encoder"), loaded):
            for k, v in module.state_dict().items():
                if v.dtype != torch.bfloat16 or not torch.equal(v.cpu(), sds[sub][k].to(torch.bfloat16)):
                    raise AssertionError(f"weights: {sub}.{k} is not the F16 source cast to bf16")
                n += 1
        log(f"weights load: zoo.load_frozen of a {size / 2 ** 30:.2f} GiB F16 {WEIGHTS_VARIANT} "
            f"directory (written in {write_s:.1f} s) onto the card in bf16: {load_s:.2f} s, "
            f"peak {peak:.2f} GiB above the {base_mem / 2 ** 30:.2f} GiB held; {n} tensors "
            f"bitwise equal to the F16 source cast to bf16; {card}")

        # 3. the same render through the loaded and the in-memory stack
        with torch.no_grad():
            for module in (pipe.unet, pipe.vae, pipe.text_encoder):
                for p in module.parameters():
                    p.copy_(p.to(torch.float16).to(torch.bfloat16))
        tokenizer = default_tokenizer(require_clip=True)
        memory = StableDiffusionControlLoRAPipeline(
            pipe.unet, pipe.vae, pipe.text_encoder, tokenizer, pipe.control_lora,
            device=device)
        from_dir = StableDiffusionControlLoRAPipeline(*loaded, tokenizer, pipe.control_lora,
                                                      device=device)
        guide = np.zeros((RES, RES, 3), np.float32) - 1.0
        guide[RES // 4:3 * RES // 4, RES // 4:3 * RES // 4] = 1.0
        img_l, used_l, wall_l = weights_render(torch, fa, from_dir, guide, "loaded")
        img_m, used_m, wall_m = weights_render(torch, fa, memory, guide, "in-memory")
        if not (np.isfinite(img_l).all() and np.array_equal(img_l, img_m)):
            raise AssertionError("weights: the loaded stack's render differs from the "
                                 f"in-memory one (max|d| {np.abs(img_l - img_m).max()})")
        total = {k: total[k] + used_l[k] + used_m[k] for k in total}
        log(f"weights render: guided {RES}², {STEPS} steps, CFG {CFG} through the loaded "
            f"stack {wall_l:.3f} s, the in-memory stack {wall_m:.3f} s: bitwise equal; "
            f"launches {used_l} each; {card}")
        del memory, from_dir, loaded, pipe, sds
        gc.collect()
        torch.cuda.empty_cache()

        # 4. Canny on the card against the CPU
        for size in CANNY_SIZES:
            img = torch.from_numpy(_procedural_image(size, size))
            on_card = img.to(device)
            for lo, hi in CANNY_PAIRS:
                out, ref = canny(on_card, lo, hi), canny(img, lo, hi)
                if out.device != on_card.device or not torch.equal(out.cpu(), ref):
                    raise AssertionError(f"canny {size}² ({lo}, {hi}): card differs from CPU")
            ms = cuda_ms(lambda: canny(on_card, 100, 200))
            log(f"weights canny: {size}² RGB, thresholds {CANNY_PAIRS}: card == CPU exactly "
                f"({int((ref > 0).sum())} edge pixels at {CANNY_PAIRS[-1]}); {ms:.3f} ms an "
                f"image on the card (events, median of 10); {card}")

        # 5. the app over HTTP
        used = weights_app(torch, fa, ckpt, control_dir, device, card)
        total = {k: total[k] + used[k] for k in total}
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the canned launchers and the conversion CLI, as a user runs them
        common = ["--model_variant", WEIGHTS_VARIANT, "--resolution", str(RES),
                  "--device", CLI_DEVICE]
        run = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        stdout = run_cli("controllora_tpu_torch.tasks", [
            "train_canny", "--pretrained_model_name_or_path", ckpt, "--max_train_steps", "3",
            "--output_dir", run, "--checkpointing_steps", "3", "--log_every", "1", *common])
        train_s = time.perf_counter() - t0
        steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
        ms_step = [float(m) for m in re.findall(r"([\d.]+) ms/step", "\n".join(steps))]
        if len(steps) != 3 or "frozen" not in stdout or f"from {ckpt}" not in stdout:
            raise AssertionError(f"train_canny:\n{stdout[-1500:]}")
        samples = os.path.join(tmp, "samples")
        export = os.path.join(tmp, "export")

        def export_and_import():
            return (run_cli("controllora_tpu_torch.convert_checkpoint", [
                        "export-controllora", "--run_dir", run, "--config",
                        os.path.join(run, "config.json"), "--out", export, "--device",
                        CLI_DEVICE]),
                    run_cli("controllora_tpu_torch.convert_checkpoint",
                            ["import-controllora", export, "--device", CLI_DEVICE]))

        # test_canny, import-sd and export -> import-controllora need only the run and
        # the checkpoint: three subprocess chains side by side
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            tested = pool.submit(run_cli, "controllora_tpu_torch.tasks", [
                "test_canny", "--control_lora_dir", run, "--pretrained_model_name_or_path",
                ckpt, "--num_validation_images", "1", "--num_inference_steps", str(STEPS),
                "--output_dir", samples, *common])
            imports = pool.submit(run_cli, "controllora_tpu_torch.convert_checkpoint",
                                  ["import-sd", ckpt, "--device", CLI_DEVICE])
            exports = pool.submit(export_and_import)
            tested.result()
            imported = imports.result().splitlines()
            exported, reimported = exports.result()
        side_s = time.perf_counter() - t0
        with open(os.path.join(samples, "0.png"), "rb") as f:
            montage = decode_png(f.read())
        if montage.shape != (RES, 3 * RES, 3):
            raise AssertionError(f"test_canny: montage {montage.shape}")
        a, b = (torch.load(os.path.join(d, "diffusion_pytorch_model.bin"), weights_only=True)
                for d in (run, export))
        if (list(a) != list(b) or not all(torch.equal(a[k], b[k]) for k in a)
                or [ln.split(":")[0] for ln in imported] != ["unet", "vae", "text"]
                or f"exported step-3 adapter to {export}" not in exported
                or "params ok" not in reimported):
            raise AssertionError(f"convert_checkpoint: {imported} {exported} {reimported}")
    if old_vocab is None:
        os.environ.pop("CLIP_VOCAB_DIR", None)
    else:
        os.environ["CLIP_VOCAB_DIR"] = old_vocab
    log(f"weights tasks: python -m controllora_tpu_torch.tasks train_canny (3 steps, {RES}² "
        f"batch 1, diffusiondb_canny on the card) {train_s:.1f} s with start and load, "
        f"ms/step as logged {ms_step}; then side by side, {side_s:.1f} s: tasks test_canny (1 "
        f"image, {STEPS} steps), montage {montage.shape}; convert_checkpoint import-sd "
        f"({'; '.join(imported)}), export-controllora ({exported.strip()}; {len(a)} tensors "
        f"equal the run's artifact), import-controllora ({reimported.strip()}); {card}")
    log(f"weights phase {time.perf_counter() - t_phase:.1f} s; main-path launches {total}")
    return total



ANNOTATOR_RES = 512  # the reference's detect_resolution and MLSD's, HED's working size
MIDAS_SIZES = (384, 512)
ANNOTATOR_REL = 1e-3  # max|card - CPU| / max|CPU| of each net's raw maps
POSE_STEPS, POSE_CFG = 30, 9.0  # the pose2image app's defaults
POSE_VARIANT = "sd15"


def rel_max(out, ref):
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max())


def held(name, out, ref):
    """The card's raw map against the CPU's: relative max error <= ANNOTATOR_REL."""
    err = rel_max(out, ref)
    if not err <= ANNOTATOR_REL:
        raise AssertionError(f"{name}: card vs CPU relative max error {err:.3g}")
    return err


def truncation_diff(name, card_u8, card_f, cpu_f):
    """Pixels where the card's uint8 map differs from the CPU's float map truncated
    to uint8: allowed only where the CPU float lies within max|card_f - cpu_f| of a
    level boundary, and by one level; returns their count."""
    import numpy as np

    card_f, cpu_f = card_f.double().cpu().numpy(), cpu_f.double().cpu().numpy()
    want = np.clip(cpu_f, 0, 255).astype(np.uint8)
    margin = float(np.abs(card_f - cpu_f).max())
    frac = cpu_f - np.floor(cpu_f)
    differ = card_u8 != want
    near = (frac <= margin) | (frac >= 1 - margin)
    if (differ & ~near).any() or np.abs(card_u8.astype(np.int16) - want).max() > 1:
        raise AssertionError(f"{name}: {int((differ & ~near).sum())} uint8 pixels differ "
                             f"from the CPU's away from a level boundary")
    return int(differ.sum())


def peak_diff(torch, heat, cheat):
    """OpenPose's peak masks from the card's and the CPU's heatmaps: positions that
    differ must be near-ties of the blurred maps (a neighbour or the 0.1 threshold
    within twice the blurs' difference); returns their count."""
    from controllora_tpu_torch.annotators.openpose import _shifted, gaussian_blur, peak_mask

    mask, cmask = peak_mask(heat[:, :, :18]).cpu(), peak_mask(cheat[:, :, :18])
    b = gaussian_blur(cheat[:, :, :18].permute(2, 0, 1), 3.0, 12)
    delta = float((gaussian_blur(heat[:, :, :18].permute(2, 0, 1), 3.0, 12).cpu() - b).abs().max())
    margin = (b - 0.1).abs()
    for axis in (1, 2):
        for step in (1, -1):
            margin = torch.minimum(margin, (b - _shifted(b, axis, step)).abs())
    differ = (mask != cmask).permute(2, 0, 1)
    if (differ & (margin > 2 * delta)).any():
        raise AssertionError("openpose: a peak differs from the CPU's away from a near-tie")
    return int(differ.sum())


def detector_profile(torch, fn):
    """One call of fn under the profiler (device activity only): its device busy ms
    against its wall ms, and the two kernels that took most of the card."""
    wall, busy, top = device_profile(torch, fn, host=False)
    kernels = ", ".join(f"{name[:48]} {ms:.1f} ms" for name, ms in top[:2])
    return f"one profiled call: device busy {busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall ({kernels})"


def phase_annotators(torch, fa, card):
    """The five annotators on the card at the reference's working sizes, each from a
    seeded state dict in its checkpoint's key names (He-scaled fills), against the
    same detector on the CPU, fp32 with TF32 off: OpenPose body at detect_resolution
    512 (scale 0.5 of boxsize 368) and its hand net at the four scales, HED and MLSD
    at 512², MiDaS at 384² and 512², UniFormer at 512²; raw maps within
    ANNOTATOR_REL, the decoded peaks, centres, labels and uint8 maps equal or
    differing only where the text says why; ms per image (events, median of 10).
    Then the pose2image app's web UI answers one POST /api at 512² with the app's
    defaults (30 steps, CFG 9), launches exactly {k1 30 x 5, k2 1}, with its wall
    and device busy time and the PNGs it answers written and read back. Returns the
    request's launches."""
    import base64
    import threading
    import urllib.request
    from types import SimpleNamespace

    import numpy as np

    from controllora_tpu_torch.annotators import hed, midas, mlsd, openpose, uniformer
    from controllora_tpu_torch.annotators.util import seeded_state_dict
    from controllora_tpu_torch.apps import pose2image
    from controllora_tpu_torch.apps.webui import build_server
    from controllora_tpu_torch.data.process_datasets import _procedural_image
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.utils.image import resize_jax
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    device = torch.device(CLI_DEVICE)
    img = _procedural_image(3, ANNOTATOR_RES)

    def seeded(net_cls, seed=0):
        with torch.device("meta"):
            return seeded_state_dict(net_cls(), seed)

    # OpenPose: body maps, peaks, skeleton; the hand net at its four scales
    t0 = time.perf_counter()
    body, hand = seeded(openpose.BodyposeModel), seeded(openpose.HandposeModel, 1)
    det = openpose.OpenposeDetector(body, hand, device=device)
    ref = openpose.OpenposeDetector(body, hand, device="cpu")
    (paf, heat), (cpaf, cheat) = det.infer_maps(img), ref.infer_maps(img)
    errs = (held("openpose paf", paf, cpaf), held("openpose heat", heat, cheat))
    peaks_off = peak_diff(torch, heat, cheat)
    t1 = time.perf_counter()
    canvas, pose = det(img)
    call_s = time.perf_counter() - t1
    cpeaks = openpose.find_peaks(cheat[:, :, :18])
    ccandidate, csubset = openpose.assemble_people(
        cpeaks, openpose.score_limbs(cpaf.numpy(), cpeaks, ANNOTATOR_RES))
    ccanvas = openpose.draw_bodypose(np.zeros_like(img), ccandidate, csubset)
    canvas_off = int((canvas != ccanvas).any(-1).sum())
    if peaks_off == 0 and canvas_off:
        raise AssertionError("openpose: equal peaks, but the skeletons differ")
    ms = cuda_ms(lambda: openpose.peak_mask(det.infer_maps(img)[1][:, :, :18]))
    n_peaks = sum(len(p) for p in openpose.find_peaks(heat[:, :, :18]))
    log(f"annotators openpose: body at detect_resolution {ANNOTATOR_RES} (net at 184² + "
        f"bicubic maps), relative max error paf {errs[0]:.2e}, heat {errs[1]:.2e}; {n_peaks} "
        f"peaks, {peaks_off} peak pixels differ from the CPU's (near-ties of the blurred "
        f"maps); {len(pose['bodies']['subset'])} people, skeleton pixels differing {canvas_off}; "
        f"maps and peak mask {ms:.3f} ms an image on the card (events, median of 10), the "
        f"whole detector call with the host decode (PAF scoring of every peak pair) "
        f"{call_s * 1e3:.1f} ms (host clock, one call); "
        f"{detector_profile(torch, lambda: det.infer_maps(img))}; {card}")
    r = ANNOTATOR_RES
    crop = np.ascontiguousarray(img[r // 4:3 * r // 4, r // 4:3 * r // 4])
    hm, chm = det.infer_hand(crop), ref.infer_hand(crop)
    err = held("openpose hand", hm, chm)
    hand_peaks, chand_peaks = openpose.decode_hand_peaks(hm), openpose.decode_hand_peaks(chm)
    hand_off = int((hand_peaks != chand_peaks).any(-1).sum())
    ms = cuda_ms(lambda: det.infer_hand(crop))
    log(f"annotators openpose hand: {r // 2}² crop at scales 184/368/552/736, relative max error "
        f"{err:.2e}; {hand_off} of 21 keypoints differ from the CPU's; {ms:.3f} ms a crop "
        f"(events, median of 10); {detector_profile(torch, lambda: det.infer_hand(crop))}; "
        f"{card}; {time.perf_counter() - t0:.1f} s")
    del det, ref

    # HED: edges, the uint8 map, the scribble nms
    t0 = time.perf_counter()
    sd = seeded(hed.HEDNetwork)
    det, ref = hed.HEDdetector(sd, device=device), hed.HEDdetector(sd, device="cpu")
    edge, cedge = det.edge(img), ref.edge(img)
    err = held("hed", edge, cedge)
    out = det(img)
    off = truncation_diff("hed", out, (edge * 255).clamp(0, 255), (cedge * 255).clamp(0, 255))
    scribble = torch.from_numpy(out.astype(np.float32))
    if not torch.equal(hed.hed_nms(scribble.to(device), 127, 3.0).cpu(),
                       hed.hed_nms(scribble, 127, 3.0)):
        raise AssertionError("hed nms: the card differs from the CPU on the same map")
    ms = cuda_ms(lambda: det(img))
    log(f"annotators hed: {ANNOTATOR_RES}², relative max error {err:.2e}; uint8 pixels "
        f"differing {off} (each within the floats' difference of a level boundary); nms "
        f"card == CPU exactly; {ms:.3f} ms an image (events, median of 10); "
        f"{detector_profile(torch, lambda: det(img))}; {card}; {time.perf_counter() - t0:.1f} s")
    del det, ref

    # MLSD: the tpMap, the centre decode, the lines and their map
    t0 = time.perf_counter()
    sd = seeded(mlsd.MobileV2MLSDLarge)
    det, ref = mlsd.MLSDdetector(sd, device=device), mlsd.MLSDdetector(sd, device="cpu")
    x = resize_jax(torch.from_numpy(img).float(), 512, 512, "linear")
    x = (torch.cat([x, torch.ones_like(x[:, :, :1])], -1) / 127.5 - 1.0).permute(2, 0, 1)[None]
    with torch.no_grad():
        tp, ctp = det.model(x.to(device)), ref.model(x)
    err = held("mlsd", tp, ctp)
    centres = [torch.stack(c[1:3]).cpu() for c in (mlsd.decode_centers(tp),
                                                  mlsd.decode_centers(ctp))]
    centres_off = int((centres[0] != centres[1]).any(0).sum())
    lines, clines = mlsd.pred_lines(img, det.model), mlsd.pred_lines(img, ref.model)
    line_err = (float(np.abs(lines - clines).max()) if lines.shape == clines.shape
                else f"{len(lines)} vs {len(clines)} lines")
    off = int((det(img) != ref(img)).sum())
    ms = cuda_ms(lambda: det(img))
    log(f"annotators mlsd: {ANNOTATOR_RES}², relative max error {err:.2e}; of the top 200 "
        f"centres {centres_off} differ from the CPU's in place (ties of the sigmoid scores "
        f"reorder); {len(lines)} lines, max coordinate difference {line_err}; line-map "
        f"pixels differing {off}; {ms:.3f} ms an image (events, median of 10); "
        f"{detector_profile(torch, lambda: det(img))}; {card}; {time.perf_counter() - t0:.1f} s")
    del det, ref

    # MiDaS: depth, depth and normal uint8 maps at 384² and 512²
    t0 = time.perf_counter()
    sd = seeded(midas.DPTHybridDepth)
    det, ref = midas.MidasDetector(sd, device=device), midas.MidasDetector(sd, device="cpu")
    for size in MIDAS_SIZES:
        im = _procedural_image(5, size)
        d, cd = det.depth(im), ref.depth(im)
        err = held(f"midas {size}", d, cd)
        (n01, n), (cn01, cn) = midas.depth_to_normal(d), midas.depth_to_normal(cd)
        depth, normal = det(im)
        off = (truncation_diff("midas depth", depth, (n01 * 255).clamp(0, 255),
                               (cn01 * 255).clamp(0, 255)),
               truncation_diff("midas normal", normal, (n * 127.5 + 127.5).clamp(0, 255),
                               (cn * 127.5 + 127.5).clamp(0, 255)))
        ms = cuda_ms(lambda: det(im))
        log(f"annotators midas: {size}², relative max error {err:.2e}; uint8 pixels differing "
            f"depth {off[0]}, normal {off[1]} (each within the floats' difference of a level "
            f"boundary); {ms:.3f} ms an image (events, median of 10); "
            f"{detector_profile(torch, lambda: det(im))}; {card}")
    log(f"annotators midas {time.perf_counter() - t0:.1f} s")
    del det, ref

    # UniFormer: logits, labels, the colour map
    t0 = time.perf_counter()
    sd = seeded(uniformer.UniFormerSeg)
    det, ref = (uniformer.UniformerDetector(sd, device=device),
                uniformer.UniformerDetector(sd, device="cpu"))
    logits, clogits = det.logits(img), ref.logits(img)
    err = held("uniformer", logits, clogits)
    labels, clabels = (resize_jax(lg.argmax(0), *img.shape[:2], "nearest").cpu()
                       for lg in (logits, clogits))
    top2 = clogits.topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > 2 * float((logits.cpu() - clogits).abs().max())
    if not torch.equal(labels[clear], clabels[clear]):
        raise AssertionError("uniformer: a label with a clear margin differs from the CPU's")
    off = int((labels != clabels).sum())
    ms = cuda_ms(lambda: det(img))
    log(f"annotators uniformer: {ANNOTATOR_RES}², relative max error {err:.2e}; "
        f"{len(torch.unique(labels))} classes, labels differing {off} (each a near-tie of "
        f"the top two logits); {ms:.3f} ms an image (events, median of 10); "
        f"{detector_profile(torch, lambda: det(img))}; {card}; {time.perf_counter() - t0:.1f} s")
    del det, ref
    gc.collect()
    torch.cuda.empty_cache()

    # the pose2image app over HTTP at 512² with its defaults
    with tempfile.TemporaryDirectory() as tmp:
        unet_config = zoo.VARIANTS[POSE_VARIANT][0]
        control = base_control(torch, unet_config, device,
                               torch.Generator(device=device).manual_seed(21))
        save_control_lora(os.path.join(tmp, "control"), control)
        torch.save({k: torch.from_numpy(v) for k, v in body.items()},
                   os.path.join(tmp, "body_pose_model.pth"))
        t0 = time.perf_counter()
        process = pose2image.build_processor(SimpleNamespace(
            pretrained_model_name_or_path=None, model_variant=POSE_VARIANT,
            control_lora_dir=os.path.join(tmp, "control"),
            openpose_weights=os.path.join(tmp, "body_pose_model.pth"), device=CLI_DEVICE))
        build_s = time.perf_counter() - t0
        server = build_server("pose2image", process, pose2image.DEFAULTS, host="127.0.0.1",
                              port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        req = dict(image=base64.b64encode(encode_png(img)).decode("ascii"), prompt="a dancer",
                   num_samples=1, image_resolution=ANNOTATOR_RES,
                   detect_resolution=ANNOTATOR_RES, ddim_steps=POSE_STEPS, scale=POSE_CFG,
                   seed=42)
        answer = {}

        def request():
            r = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/api",
                                       data=json.dumps(req).encode(),
                                       headers={"Content-Type": "application/json"})
            answer.update(json.loads(urllib.request.urlopen(r, timeout=900).read()))

        try:
            fa.reset_launch_counts()  # the request's main path starts here
            wall, busy, top = device_profile(torch, request, host=False)
            used = dict(fa.LAUNCHES)  # and ends here
        finally:
            server.shutdown()
            thread.join(timeout=60)
            server.server_close()
        written = []
        for i, b64 in enumerate(answer["images"]):
            path = os.path.join(tmp, f"{i}.png")
            with open(path, "wb") as f:
                f.write(base64.b64decode(b64))
            with open(path, "rb") as f:
                written.append(decode_png(f.read()))
    want = {"k1": POSE_STEPS * k1_per_eval(unet_config, ANNOTATOR_RES),
            "k2": int((ANNOTATOR_RES // 8) ** 2 >= 4096), "k3": 0, "k4": 0}
    if ([w.shape for w in written] != [(ANNOTATOR_RES, ANNOTATOR_RES, 3)] * 2 or used != want
            or not written[0].any()):
        raise AssertionError(f"pose2image: PNGs {[w.shape for w in written]}, launches {used} "
                             f"(want {want})")
    log(f"annotators pose2image: POST /api to python -m controllora_tpu_torch.apps.pose2image's "
        f"web UI (random {POSE_VARIANT} stack and OpenPose built in {build_s:.1f} s): {ANNOTATOR_RES}² PNG "
        f"in, detect_resolution {ANNOTATOR_RES}, {POSE_STEPS} steps, CFG {POSE_CFG}, 1 sample: "
        f"{wall:.3f} s wall, device busy {busy:.3f} s (idle share {1 - busy / wall:.3f}); "
        f"{len(written)} {ANNOTATOR_RES}² PNGs written and read back, skeleton "
        f"{int(written[0].any(-1).sum())} pixels; launches {used}; {card}")
    log(f"annotators phase {time.perf_counter() - t_phase:.1f} s; main-path launches {used}")
    return used


# ---------------------------------------------------------------------------- parallel

PAR_SEED = 21
PAR_WORLD = 4  # rank processes: sharing cuda:0 over gloo, or one a card over nccl
PAR_TRAIN_BATCH = 4  # a dp rank's rows of the global batch of 8
PAR_K1 = (((1, 4, 4096, 40), "cfg,model=2 rank, level 0"),
          ((1, 8, 4096, 40), "data,cfg or cfg rank, level 0"))
PAR_TRAIN_SHAPE = (PAR_TRAIN_BATCH, 8, 4096, 40)
PAR_RENDER_LAUNCHES = {"k1": 5 * STEPS, "k2": 1, "k3": 0, "k4": 0}
# what the rank processes run on and with; a CPU rehearsal sets "cpu", "smoke", 64², 2
# steps and zero launches (the ranks are fresh interpreters: spawn_ranks hands them this)
PAR = dict(device="cuda", backend="gloo", variant="sd15", res=RES, steps=STEPS,
           render_launches=PAR_RENDER_LAUNCHES, train_launches=TRAIN_LAUNCHES)


def phase_parallel_kernels(torch, fa, device, record):
    """K1 at a mesh rank's shapes (heads / 2 under model=2, batch 1 under cfg) and K2,
    K3 and K4 at a dp rank's (batch 4), against their plain versions with times,
    bounds and SDPA, into `record`'s shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(15)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    for (b, h, l, d), label in PAR_K1:
        k1_case(torch, fa, rnd, record, b, h, l, d, 1, timed=True, label=f" ({label})")
    label = " (dp rank, global batch 8 over 2)"
    k2_case(torch, fa, device, rnd, record, *PAR_TRAIN_SHAPE, label=label)
    bwd_case(torch, fa, rnd, record, *PAR_TRAIN_SHAPE, timed=True, label=label)
    torch.cuda.empty_cache()
    log(f"parallel kernels {time.perf_counter() - t0:.1f} s")


def parallel_guide():
    import numpy as np

    res = PAR["res"]
    return np.random.default_rng(PAR_SEED).uniform(-1, 1, (res, res, 3)).astype(np.float32)


def profile_or_time(torch, fn):
    """device_profile's (wall, busy, top) on the card; (wall, 0, []) on the CPU."""
    if PAR["device"] == "cuda":
        return device_profile(torch, fn, host=False)
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0, 0.0, []


def parallel_rank(rank, world, init, job_dir, settings):
    """One rank of phase "parallel" (a spawned process: on cuda:0 over gloo, or on
    cuda:<rank> over nccl with --cards): (a) the guided
    render on a cfg,model=2 mesh, (b) two images on data,cfg, (c) a dp train step on
    ranks 0 and 1; each counted from 0 and profiled; results to rank<r>.pt."""
    import torch

    PAR.update(settings)
    torch.set_num_threads(1 if PAR["device"] == "cpu" else torch.get_num_threads())
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    from controllora_tpu_torch.ops import flash_attention as fa
    from controllora_tpu_torch.parallel import make_mesh, make_serving_mesh, shard_batch
    from controllora_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch

    assert maybe_initialize_distributed(PAR["backend"], init)
    device = torch.device(PAR["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        fa.build_kernels()  # built by the parent: loads the cached library
    shapes = set()
    launch = fa.biased_attention

    def counted(q, k, v, heads, *biases):
        shapes.add((q.shape[0], heads, q.shape[1], q.shape[2] // heads))
        return launch(q, k, v, heads, *biases)

    fa.biased_attention = counted
    base = build_stack(torch, device, PAR["variant"])
    guide = parallel_guide()
    out = {}
    meshes = {"cfg,model=2": make_serving_mesh(range(world), cfg=True, model=2),
              "data,cfg": make_serving_mesh(range(world), cfg=True)}
    for name, n in (("cfg,model=2", 1), ("data,cfg", 2)):
        mesh = meshes[name]
        pipe = StableDiffusionControlLoRAPipeline(base.unet, base.vae, base.text_encoder,
                                                  base.tokenizer, base.control_lora,
                                                  device=device, mesh=mesh)
        kw = dict(guide=guide, num_images=n, guidance_scale=CFG, return_array=True)
        with torch.inference_mode():
            pipe("warm up", num_inference_steps=1, generator=torch.Generator().manual_seed(0),
                 **kw)
            fa.reset_launch_counts()
            shapes.clear()
            images = []
            wall, busy, _ = profile_or_time(torch, lambda: images.extend(pipe(
                "a photo", num_inference_steps=PAR["steps"],
                generator=torch.Generator().manual_seed(PAR_SEED), **kw)))
        out[name] = dict(images=images, launches=dict(fa.LAUNCHES), k1_shapes=sorted(shapes),
                         wall=wall, busy=busy, coords=mesh.coords)
        del pipe

    dp = make_mesh(ranks=range(2))  # every rank builds it; ranks 0 and 1 train
    if dp.member:
        job = torch.load(os.path.join(job_dir, "batch.pt"), weights_only=False)
        trainer = ControlLoRATrainer(base.control_lora, base.unet, base.vae,
                                     base.text_encoder, hint_compute_dtype=torch.bfloat16,
                                     remat_unet=False, mesh=dp)
        batch = to_device_batch(shard_batch(job, dp), device)
        gen = torch.Generator(device=device).manual_seed(PAR_SEED)
        fa.reset_launch_counts()
        metrics = {}
        wall, busy, _ = profile_or_time(torch, lambda: metrics.update(
            trainer.train_step(batch, gen, return_grads=True)))
        out["dp"] = dict(
            loss=float(metrics["loss"]), launches=dict(fa.LAUNCHES), wall=wall, busy=busy,
            grads=torch.cat([g.float().flatten() for g in metrics["grads"]]).cpu(),
            params=torch.cat([p.detach().flatten() for p in trainer.params]).cpu(),
            coords=dp.coords, peak_gb=(torch.cuda.max_memory_allocated() / 2**30
                                       if device.type == "cuda" else 0.0))
    torch.save(out, os.path.join(job_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def spawn_ranks(world, job_dir, timeout=600):
    """Start `world` parallel_rank processes (spawn: a fork after CUDA init fails) and
    wait for all; one that fails or outlasts `timeout` fails the phase, and every
    process still running is terminated."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = f"file://{os.path.join(job_dir, 'store')}"
    procs = [ctx.Process(target=parallel_rank, args=(r, world, init, job_dir, dict(PAR)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"parallel: rank exit codes {codes}")


def phase_parallel(torch, fa, device, card):
    """The serving mesh and data-parallel training on the card: PAR_WORLD ranks share
    cuda:0 over gloo (NCCL takes one card a rank), each building the seeded SD1.5
    stack with the `base` ControlLoRA as build_stack makes it; every rank's result
    against a 1-process run of the same seeded stack here; then the sample CLI under
    torch.distributed.run with --serving_mesh cfg. Returns the ranks' launches."""
    import numpy as np

    from controllora_tpu_torch.data.registry import DatasetBase, batch_iterator
    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.training.checkpoint import save_control_lora
    from controllora_tpu_torch.training.trainer import ControlLoRATrainer, to_device_batch
    from controllora_tpu_torch.utils.png import decode_png

    t0 = time.perf_counter()
    res, steps = PAR["res"], PAR["steps"]
    tmp = tempfile.mkdtemp(prefix="parallel-")
    batch = next(batch_iterator(DatasetBase.from_name("process/fill50k")(
        HashTokenizer(), resolution=res), 2 * PAR_TRAIN_BATCH, seed=1))
    torch.save(batch, os.path.join(tmp, "batch.pt"))
    spawn_ranks(PAR_WORLD, tmp)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_WORLD)]
    t_ranks = time.perf_counter() - t0

    ref = build_stack(torch, device, PAR["variant"])
    guide = parallel_guide()
    report, bad = {"card": card, "backend": PAR["backend"], "ranks_s": round(t_ranks, 1)}, []
    for name, n, heads in (("cfg,model=2", 1, 4), ("data,cfg", 2, 8)):
        kw = dict(guide=guide, num_images=n, guidance_scale=CFG, return_array=True)
        want = []
        with torch.inference_mode():
            ref("warm up", num_inference_steps=1, generator=torch.Generator().manual_seed(0),
                **kw)
            wall, busy, _ = profile_or_time(torch, lambda: want.extend(ref(
                "a photo", num_inference_steps=steps,
                generator=torch.Generator().manual_seed(PAR_SEED), **kw)))
        want = torch.from_numpy(np.stack(want))
        rows = []
        for r, result in enumerate(ranks):
            got = result[name]
            err = rel_l2(torch.from_numpy(np.stack(got["images"])), want)
            shapes = [(1, heads, (res // 8) ** 2, 40)] if PAR["render_launches"]["k1"] else []
            rows.append(dict(rank=r, coords=got["coords"], launches=got["launches"],
                             k1_shapes=got["k1_shapes"], rel_err=err,
                             wall_s=round(got["wall"], 3), busy_s=round(got["busy"], 3)))
            if not (err <= REL_BOUND and np.isfinite(np.stack(got["images"])).all()):
                bad.append(f"{name} rank {r}: relative error {err}")
            if got["launches"] != PAR["render_launches"] or got["k1_shapes"] != shapes:
                bad.append(f"{name} rank {r}: launches {got['launches']}, K1 shapes "
                           f"{got['k1_shapes']}, expected {PAR['render_launches']} at {shapes}")
        report[name] = dict(images=n, bound=REL_BOUND, one_process=dict(
            wall_s=round(wall, 3), busy_s=round(busy, 3)), ranks=rows)

    trainer = ControlLoRATrainer(ref.control_lora, ref.unet, ref.vae, ref.text_encoder,
                                 hint_compute_dtype=torch.bfloat16, remat_unet=False)
    loss = trainer.loss(to_device_batch(batch, device),
                        torch.Generator(device=device).manual_seed(PAR_SEED))
    grad = torch.cat([g.float().flatten() for g in trainer.grads(loss)]).cpu()
    loss = loss.item()
    del trainer
    dps = [result["dp"] for result in ranks[:2]]
    rows = []
    for r, got in enumerate(dps):
        lerr, gerr = abs(got["loss"] - loss) / abs(loss), rel_l2(got["grads"], grad)
        rows.append(dict(rank=r, coords=got["coords"], launches=got["launches"],
                         loss=got["loss"], loss_rel_err=lerr, grad_rel_err=gerr,
                         wall_s=round(got["wall"], 3), busy_s=round(got["busy"], 3),
                         peak_gib=round(got["peak_gb"], 2)))
        if not (lerr <= REL_BOUND and gerr <= REL_BOUND):
            bad.append(f"dp rank {r}: loss {lerr}, gradient {gerr} relative")
        if got["launches"] != PAR["train_launches"]:
            bad.append(f"dp rank {r}: launches {got['launches']}, expected "
                       f"{PAR['train_launches']}")
    same = torch.equal(dps[0]["params"], dps[1]["params"])
    if not same:
        bad.append("dp: parameters differ between the ranks after the step")
    report["dp"] = dict(global_batch=2 * PAR_TRAIN_BATCH, loss_1_process=loss,
                        bound=REL_BOUND, params_equal=same, ranks=rows)

    control_dir = os.path.join(tmp, "control")
    save_control_lora(control_dir, ref.control_lora)
    del ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "samples")
    t1 = time.perf_counter()
    stdout = run_cli("torch.distributed.run", [
        "--standalone", "--nproc_per_node", "2", "-m", "controllora_tpu_torch.sample",
        "--serving_mesh", "cfg", "--dist_backend", PAR["backend"], "--control_lora_dir",
        control_dir, "--model_variant", PAR["variant"], "--device", PAR["device"],
        "--resolution", str(res), "--num_inference_steps", str(steps),
        "--num_validation_images", "1", "--output_dir", out_dir], timeout=600)
    wrote = [line for line in stdout.splitlines() if line.startswith("wrote ")]
    img = decode_png(open(os.path.join(out_dir, "0.png"), "rb").read())
    report["sample_cli"] = dict(seconds=round(time.perf_counter() - t1, 1),
                                wrote=len(wrote), montage=list(img.shape),
                                mesh=[line for line in stdout.splitlines()
                                      if line.startswith("serving mesh")])
    if len(wrote) != 1 or img.shape != (res, 3 * res, 3) or os.listdir(out_dir) != ["0.png"]:
        bad.append(f"sample CLI: {len(wrote)} 'wrote' lines, montage {img.shape}, files "
                   f"{os.listdir(out_dir)}")
    shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = round(time.perf_counter() - t0, 1)
    log("parallel: " + json.dumps(report))
    if bad:
        raise AssertionError("parallel: " + "; ".join(bad))
    total = {}
    for result in ranks:
        for part in ("cfg,model=2", "data,cfg", "dp"):
            for k, v in result.get(part, {}).get("launches", {}).items():
                total[k] = total.get(k, 0) + v
    return total



# the eval presets phase's --train_steps (300 until PR 14; cut to keep the script in its
# time beside phase "fp32": a shorter-trained adapter moves less, see PERF.md)
EVAL_PRESETS_STEPS = 100


def phase_eval_presets(torch, fa, card):
    """`python -m controllora_tpu_torch.eval_presets --train_steps 100` in this process
    on the card (--device CLI_DEVICE): trains the smoke ControlLoRA at 64² through the
    train CLI, renders its evaluation specs under every preset and prints the report.
    The report must have the JAX script's keys (docs/presets_quality_r5.json), every
    figure finite, `exact` 0 error and retrieval 1.0; at 64² no sequence reaches the
    flash kernels, so its launches, counted from 0, must be none. Returns them."""
    from controllora_tpu_torch import eval_presets

    with open(os.path.join(ROOT, "docs", "presets_quality_r5.json")) as f:
        jax_report = json.load(f)
    with tempfile.TemporaryDirectory() as out:
        fa.reset_launch_counts()  # the phase's main path starts here
        t0 = time.perf_counter()
        report = eval_presets.main(["--output_dir", out, "--train_steps",
                                    str(EVAL_PRESETS_STEPS), "--device", CLI_DEVICE])
        wall = time.perf_counter() - t0
        used = dict(fa.LAUNCHES)  # and ends here
    keys = (list(report), {n: list(e) for n, e in report["presets"].items()})
    want = (list(jax_report), {n: list(e) for n, e in jax_report["presets"].items()})
    exact = report["presets"]["exact"]
    figures = [v for e in report["presets"].values() for v in e.values()]
    if (keys != want or any(used.values()) or not all(math.isfinite(v) for v in figures)
            or exact["latent_rel_err_vs_exact_max"] != 0.0
            or exact["exact_retrieval_acc"] != 1.0):
        raise AssertionError(f"eval presets: keys {keys} (want {want}), launches {used}, "
                             f"report {report}")
    log(f"eval presets (python -m controllora_tpu_torch.eval_presets --train_steps "
        f"{EVAL_PRESETS_STEPS} --device {CLI_DEVICE}): {wall:.1f} s with training; report "
        f"keys as the JAX script's; " + ", ".join(
            f"{n} rel err {e['latent_rel_err_vs_exact_mean']} retrieval "
            f"{e['exact_retrieval_acc']} drift {e['drift_vs_exact_u8_mean']}"
            for n, e in report["presets"].items()) + f"; launches {used}; {card}")
    return used


# ---------------------------------------------------------------------------- fp32

# The fp32 route of every kernel (csrc/flash_attn_fp32.cu), which the JAX package's fp32
# stacks reach: training under --mixed_precision no, the smoke stacks (fp32 in every
# CLI) at the CLIs' default 512², and the SDXL refiner served in fp32 as
# scripts/serve.py serves it. Outputs are held to FP32_BOUND * max(1, max|ref|), LSE and
# m to FP32_BOUND, and l (a sum of thousands of terms, whose error grows with it) to
# FP32_BOUND relative, which is FP32_BOUND on log l; the references are the plain
# versions in fp32, TF32 off. A product rounded to TF32 (about three decimal digits)
# would miss these on the peaked cases (q scaled x4).
FP32_BOUND = 1e-4
# fp32-accurate products at the H100's peaks (NVIDIA H100 SXM data sheet): 3xTF32 on the
# tensor cores (495 TF32 / 3), the least time the card can take for them, and fp32 FMA
# on the CUDA cores, the most the fp32 kernels' SIMT design can reach
PEAK_FLOPS_3XTF32, PEAK_FLOPS_FP32 = 165e12, 67e12
# (B, H, L, D), the factor q is scaled by, timed (the main paths' shapes) or checked
# only, and the path
FP32_K1 = (((2, 8, 4096, 40), 1, True, "SD1.5 512² render in fp32"),
           ((2, 12, 4096, 64), 1, True, "refiner 1024² level 1, guided"),
           ((2, 4, 4096, 8), 1, True, "smoke 512² level 0"),
           ((2, 2, 4096, 16), 1, True, "smoke2 512² level 0"),
           ((2, 8, 4225, 40), 4, False, "ragged L, q x4"))
FP32_K2 = (((8, 8, 4096, 40), 1, True, "SD1.5 512² training batch 8"),
           ((8, 8, 4096, 40), 4, False, "SD1.5 training shape, q x4"),
           ((8, 1, 4096, 512), 1, True, "SD1.5 512² VAE encoder batch 8"),
           ((2, 12, 4096, 64), 1, True, "refiner 1024² level 1, unguided"),
           ((1, 1, 16384, 512), 1, True, "refiner 1024² VAE decode"),
           ((1, 1, 4096, 32), 1, True, "smoke 512² VAE"),
           ((2, 8, 4225, 40), 1, False, "ragged L"))
FP32_BWD = (((8, 8, 4096, 40), 1, True, "SD1.5 512² training batch 8"),
            ((8, 8, 4096, 40), 4, False, "SD1.5 training shape, q x4"),
            ((2, 4, 4096, 8), 1, True, "smoke 512² training batch 2"),
            ((2, 2, 4096, 16), 1, True, "smoke2 512² level 0"),
            ((2, 8, 4225, 40), 1, False, "ragged L"))
# K5: (B, H, L, D), the softmax scale (None: D^-1/2), the q factor, the backward too,
# timed, the path
FP32_K5 = (((8, 8, 4096, 40), None, 1, True, True, "stock step batch 8"),
           ((8, 1, 4096, 512), None, 1, False, True, "stock step VAE encoder batch 8"),
           ((2, 8, 1024, 40), -0.3, 4, True, False, "negative scale, q x4"))
FP32_VARIANT = "sd15"  # trained with --mixed_precision no, remat dots
FP32_TRAIN_BATCH, FP32_TRAIN_STEPS = 8, 3
FP32_REFINER_STEPS = 20  # the refiner request's steps: 400 + 1 K2 launches
FP32_FWD = ["flash_fwd_3xtf32_kernel", "flash_fwd_wide_3xtf32_kernel"]  # D <= 80, wider
FP32_ROUTES = {  # each kernel's CUDA kernels on the fp32 route (3xTF32 but dQ's)
    "k1": ["bias_add_f32_kernel"] + FP32_FWD, "k2": FP32_FWD,
    "k3": ["flash_bwd_dkv_3xtf32_kernel"], "k4": ["flash_bwd_dq_f32_kernel"],
    "k5_fwd": FP32_FWD, "k5_dkv": ["flash_bwd_dkv_3xtf32_kernel"],
    "k5_dq": ["flash_bwd_dq_f32_kernel"]}


def fp32_roofline(products, b, h, lq, lk, d, n_q, n_k, rows):
    """The least time the card could take for an fp32 attention kernel: `products`
    L x L x D products a head (2 flops each) at the 3xTF32 rate, or its bytes (n_q /
    n_k fp32 B x L x H*D tensors of the query / key length, `rows` fp32 values per
    query row and head) at the memory rate, whichever is larger; and the time of those
    products at the fp32 FMA rate (fma_bound_ms)."""
    flops = 2 * products * b * h * lq * lk * d
    nbytes = 4 * b * h * d * (n_q * lq + n_k * lk) + 4 * rows * b * h * lq
    t_ops, t_bytes = flops / PEAK_FLOPS_3XTF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
             else {"bound_ms": t_bytes, "bound_by": "bytes"})
    return dict(bound, fma_bound_ms=flops / PEAK_FLOPS_FP32 * 1e3)


def fp32_error(torch, name, out, ref, rows=None):
    """max|out - ref| of an fp32 output, held to FP32_BOUND * max(1, max|ref|); of row
    terms to FP32_BOUND, `rows` "absolute" (LSE, m) or "relative" (l). Returns it or
    raises."""
    diff = (out - ref).abs()
    err = (diff / ref.abs() if rows == "relative" else diff).max().item()
    tol = FP32_BOUND * (1.0 if rows else max(1.0, ref.abs().max().item()))
    if not (out.dtype == torch.float32 and out.shape == ref.shape
            and bool(torch.isfinite(out).all()) and err <= tol):
        raise AssertionError(f"fp32 {name}: {out.dtype} {tuple(out.shape)}, max|d| {err} > "
                             f"{tol}")
    return err


def fp32_timed(record, name, shape, label, kernel, plain, bound, library, timed=True):
    """One fp32 kernel call's times (events and device), its plain version's, with its
    bounds and the fp32 SDPA yardstick (`library`, called here), as an entry of
    record[name]["shapes"]; returns the log text. A shape not `timed` is checked only:
    "" is returned."""
    if not timed:
        return ""
    library = library()
    ms = cuda_ms(kernel)
    dms = device_ms(kernel, floor_ms=bound["bound_ms"])
    pms = cuda_ms(plain)
    entry = shape_entry(shape, ms, dms, pms, bound, library)
    entry["path"] = label
    record[name]["shapes"].append(entry)
    share = "" if dms is None else (
        f"; {100 * bound['bound_ms'] / dms:.1f}% of the bound, "
        f"{100 * bound['fma_bound_ms'] / dms:.1f}% of the fp32 FMA peak")
    return (f"\n  {name} {ms:.4f} ms (device {num(dms)}{share}), plain {pms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (3xTF32), fp32 FMA "
            f"{bound['fma_bound_ms']:.4f} ms; SDPA fp32 {fmt_sdpa(library)}")


def phase_fp32_kernels(torch, fa, fs, device):
    """Each kernel's fp32 route against its plain version at the fp32 stacks' shapes
    (FP32_K1, FP32_K2, FP32_BWD, FP32_K5), each shape timed with its bounds and fp32
    SDPA. Returns {kernel: {"max_abs_err", "shapes", and the first shape's numbers}}."""
    from controllora_tpu_torch.ops.attention import split_heads

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(15)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    record = {n: {"max_abs_err": 0.0, "shapes": []} for n in FP32_ROUTES}

    def worst(name, *errs):
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], *errs)

    for (b, h, l, d), q_mul, timed, label in FP32_K1:
        q, k, v = q_mul * rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        qb, kb, vb = (0.25 * rnd(1, l, h * d) for _ in range(3))
        out = fa.biased_attention(q, k, v, h, qb, kb, vb)
        torch.cuda.synchronize()
        err = fp32_error(torch, f"K1 {label}", out, plain_fp32(fa, q, k, v, h, qb, kb, vb))
        worst("k1", err)
        biased = [split_heads(x + xb, h) for x, xb in ((q, qb), (k, kb), (v, vb))]
        bound = fp32_roofline(2, b, h, l, l, d, 2 + 1 / b, 2 + 2 / b, 0)
        log(f"K1 fp32 ({label}) B={b} H={h} L={l} D={d}: max|dO| {err:.3e}" + fp32_timed(
            record, "k1", (b, h, l, d, 1), label,
            lambda: fa.biased_attention(q, k, v, h, qb, kb, vb),
            lambda: fa.biased_attention_plain(q, k, v, h, qb, kb, vb), bound,
            lambda: sdpa_ms(torch, *biased, floor_ms=bound["bound_ms"]), timed))
        del q, k, v, qb, kb, vb, out, biased
    for (b, h, l, d), q_mul, timed, label in FP32_K2:
        q, k, v = q_mul * rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        o, lse = fa.flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.attention_lse_plain(q, k, v, h)
        err = fp32_error(torch, f"K2 {label}", o, o_ref)
        lerr = fp32_error(torch, f"K2 {label} LSE", lse, lse_ref, rows="absolute")
        worst("k2", err)
        del o_ref, lse_ref
        bound = fp32_roofline(2, b, h, l, l, d, 2, 2, 1)
        log(f"K2 fp32 ({label}) B={b} H={h} L={l} D={d}: max|dO| {err:.3e}, max|dLSE| "
            f"{lerr:.3e}" + fp32_timed(
                record, "k2", (b, h, l, d), label, lambda: fa.flash_attention(q, k, v, h),
                lambda: fa.attention_lse_plain(q, k, v, h), bound,
                lambda: sdpa_ms(torch, *(split_heads(x, h) for x in (q, k, v)),
                                floor_ms=bound["bound_ms"]), timed))
        del q, k, v, o, lse
    for (b, h, l, d), q_mul, timed, label in FP32_BWD:
        q, k, v, do = q_mul * rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d), rnd(b, l, h * d)
        o, lse = fa.flash_attention(q, k, v, h)
        dcap = fa.attention_dcap(o, do, h)
        bwd = (q, k, v, do, lse, dcap, h)
        dk, dv = fa.flash_bwd_dkv(*bwd)
        dq = fa.flash_bwd_dq(*bwd)
        torch.cuda.synchronize()
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*bwd)
        errs = {"dk": fp32_error(torch, f"K3 dK {label}", dk, ref_dk),
                "dv": fp32_error(torch, f"K3 dV {label}", dv, ref_dv)}
        del ref_dk, ref_dv
        errs["dq"] = fp32_error(torch, f"K4 dQ {label}", dq, fa.flash_bwd_dq_plain(*bwd))
        worst("k3", errs["dk"], errs["dv"])
        worst("k4", errs["dq"])
        library = sdpa_ms(torch, *(split_heads(x, h) for x in (q, k, v)),
                          do=split_heads(do, h)) if timed else None  # of K3 + K4
        log(f"K3/K4 fp32 ({label}) B={b} H={h} L={l} D={d}: max|d| dQ {errs['dq']:.3e}, dK "
            f"{errs['dk']:.3e}, dV {errs['dv']:.3e}"
            + fp32_timed(record, "k3", (b, h, l, d), label, lambda: fa.flash_bwd_dkv(*bwd),
                         lambda: fa.flash_bwd_dkv_plain(*bwd),
                         fp32_roofline(4, b, h, l, l, d, 2, 4, 2),
                         lambda: library, timed)
            + fp32_timed(record, "k4", (b, h, l, d), label, lambda: fa.flash_bwd_dq(*bwd),
                         lambda: fa.flash_bwd_dq_plain(*bwd),
                         fp32_roofline(3, b, h, l, l, d, 3, 2, 2),
                         lambda: library, timed))
        del q, k, v, do, o, lse, dcap, dk, dv, dq, bwd
    for (b, h, l, d), scale, q_mul, grads, timed, label in FP32_K5:
        scale = d**-0.5 if scale is None else scale
        q = split_heads(q_mul * rnd(b, l, h * d), h)  # head-split views, as routed
        k, v, do = (split_heads(rnd(b, l, h * d), h) for _ in range(3))
        o, m, lsum = fs.stock_flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, m_ref, l_ref = fs.stock_flash_fwd_plain(q, k, v, scale)
        err = fp32_error(torch, f"K5 fwd {label}", o, o_ref)
        merr = fp32_error(torch, f"K5 m {label}", m, m_ref, rows="absolute")
        lerr = fp32_error(torch, f"K5 l {label}", lsum, l_ref, rows="relative")
        worst("k5_fwd", err)
        del o_ref, m_ref, l_ref
        bound = fp32_roofline(2, b, h, l, l, d, 2, 2, 2)
        line = (f"K5 fp32 ({label}) B={b} H={h} L={l} D={d} scale {scale:.4g}: max|dO| "
                f"{err:.3e}, max|dm| {merr:.3e}, relative l {lerr:.3e}" + fp32_timed(
                    record, "k5_fwd", (b, h, l, d), label,
                    lambda: fs.stock_flash_fwd(q, k, v, scale),
                    lambda: fs.stock_flash_fwd_plain(q, k, v, scale), bound,
                    lambda: sdpa_ms(torch, q, k, v, scale=scale, floor_ms=bound["bound_ms"]),
                    timed))
        if grads:
            di = (o * do).sum(-1)
            bwd = (q, k, v, do, m, lsum, di, scale)
            dk, dv = fs.stock_flash_bwd_dkv(*bwd)
            dq = fs.stock_flash_bwd_dq(*bwd)
            torch.cuda.synchronize()
            ref_dk, ref_dv = fs.stock_flash_bwd_dkv_plain(*bwd)
            errs = {"dk": fp32_error(torch, f"K5 dK {label}", dk, ref_dk),
                    "dv": fp32_error(torch, f"K5 dV {label}", dv, ref_dv)}
            del ref_dk, ref_dv
            errs["dq"] = fp32_error(torch, f"K5 dQ {label}", dq,
                                    fs.stock_flash_bwd_dq_plain(*bwd))
            worst("k5_dkv", errs["dk"], errs["dv"])
            worst("k5_dq", errs["dq"])
            library = sdpa_ms(torch, q, k, v, scale=scale, do=do) if timed else None
            line += (f"\n  max|d| dQ {errs['dq']:.3e}, dK {errs['dk']:.3e}, dV {errs['dv']:.3e}"
                     + fp32_timed(record, "k5_dkv", (b, h, l, d), label,
                                  lambda: fs.stock_flash_bwd_dkv(*bwd),
                                  lambda: fs.stock_flash_bwd_dkv_plain(*bwd),
                                  fp32_roofline(4, b, h, l, l, d, 2, 4, 3),
                                  lambda: library, timed)
                     + fp32_timed(record, "k5_dq", (b, h, l, d), label,
                                  lambda: fs.stock_flash_bwd_dq(*bwd),
                                  lambda: fs.stock_flash_bwd_dq_plain(*bwd),
                                  fp32_roofline(3, b, h, l, l, d, 3, 2, 3),
                                  lambda: library, timed))
            del di, bwd, dk, dv, dq
        log(line)
        del q, k, v, do, o, m, lsum
    for entry in record.values():  # the first shape is the main path's
        entry.update({k: v for k, v in entry["shapes"][0].items() if k not in ("shape", "path")})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fp32 kernels {time.perf_counter() - t0:.1f} s; every output within {FP32_BOUND} * "
        f"max(1, max|ref|), LSE and m within {FP32_BOUND}, l within {FP32_BOUND} relative")
    return record


def fp32_cli(torch, fa, fs, module, args):
    """`python -m <module> <args>` run by its main in this process, its launches counted
    from 0: (stdout, launches of every kernel, those on the fp32 route)."""
    import contextlib
    import importlib
    import io

    cli = importlib.import_module(module)
    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    fa.reset_launch_counts()
    fs.reset_launch_counts()  # the main path starts here
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    used = {**fa.LAUNCHES, **fs.LAUNCHES}
    used32 = {**fa.FP32_LAUNCHES, **fs.FP32_LAUNCHES}  # and ends here
    return buf.getvalue(), used, used32


def fp32_train_parity(torch, fa, device):
    """One SD1.5 ControlLoRA train step in fp32 at 512², batch 1 (latents, guide, ids,
    noise and t from a seed): the loss and adapter gradient with the long
    self-attentions on the fp32 kernels (K2 forward, K3 + K4 backward, launches exact)
    against the same step with every attention plain (attention_backend "xla"), within
    FP32_BOUND relative."""
    import functools

    import numpy as np

    from controllora_tpu_torch.training.trainer import ControlLoRATrainer

    t0 = time.perf_counter()
    pipe = build_stack(torch, device, FP32_VARIANT, dtype=torch.float32)
    rng = np.random.default_rng(16)
    side = RES // 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    batch = {"latents": t(rng.normal(size=(1, 4, side, side))),
             "guide_values": t(rng.uniform(-1, 1, (1, 3, RES, RES))),
             "input_ids": torch.from_numpy(rng.integers(0, 49407, (1, 77))).to(device)}
    draws = dict(noise=t(rng.normal(size=(1, 4, side, side))),
                 timesteps=torch.tensor([500], device=device))
    unet = pipe.unet

    def run(backend):
        if backend:
            unet.forward = functools.partial(type(unet).forward, unet, attention_backend=backend)
        try:
            trainer = ControlLoRATrainer(pipe.control_lora, unet, pipe.vae, pipe.text_encoder,
                                         remat_unet=False)
            before = dict(fa.FP32_LAUNCHES)
            loss = trainer.loss(batch, **draws)
            grad = torch.cat([g.detach().flatten() for g in trainer.grads(loss)])
            torch.cuda.synchronize()
            return loss.item(), grad, {n: fa.FP32_LAUNCHES[n] - before[n] for n in before}
        finally:
            if backend:
                del unet.forward

    loss, grad, used = run(None)
    ref_loss, ref_grad, used_ref = run("xla")
    n = k1_per_eval(unet.config, RES)
    want = {"k1": 0, "k2": n, "k3": n, "k4": n}
    errs = {"loss": abs(loss - ref_loss) / abs(ref_loss), "adapter gradient": rel_l2(grad, ref_grad)}
    del pipe, unet, grad, ref_grad
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fp32 train parity {FP32_VARIANT} {RES}² batch 1: kernels (fp32 route {used}) vs plain "
        f"(attention_backend xla, {used_ref}): loss {loss:.7f} vs {ref_loss:.7f}, relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" <= {FP32_BOUND}; {time.perf_counter() - t0:.1f} s")
    if used != want or any(used_ref.values()):
        raise AssertionError(f"fp32 train parity launches {used} (want {want}), plain {used_ref}")
    bad = {k: v for k, v in errs.items() if not v <= FP32_BOUND}
    if bad or not math.isfinite(loss):
        raise AssertionError(f"fp32 train parity outside {FP32_BOUND}: {bad}, loss {loss}")


def fp32_refiner_parity(torch, fa, device):
    """The SDXL refiner's unguided CFG UNet eval at 1024² in fp32, as the fp32 server
    runs it (K2 on its fp32 route in every long self-attention, launches exact),
    against the same eval with every attention plain: max|d eps| within FP32_BOUND *
    max|ref|."""
    import numpy as np

    t0 = time.perf_counter()
    refiner = build_stack(torch, device, REFINER, dtype=torch.float32)
    rng = np.random.default_rng(17)
    side = REFINER_RES // 8
    lat = torch.from_numpy(rng.normal(size=(2, 4, side, side)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, 49407, (2, 77))).to(device)
    steps = torch.tensor([300.0, 300.0], device=device)
    with torch.inference_mode():
        ctx, pooled = refiner.text_encoder(ids)
        added = dict(added_text_embeds=pooled, added_time_ids=refiner.text_time_ids(
            pooled, REFINER_RES, REFINER_RES, 6.0, 2.5))
        before = dict(fa.FP32_LAUNCHES)
        eps = refiner.unet(lat, steps, ctx, **added)
        torch.cuda.synchronize()
        used = {n: fa.FP32_LAUNCHES[n] - before[n] for n in before}
        ref = refiner.unet(lat, steps, ctx, attention_backend="xla", **added)
        err = (eps - ref).abs().max().item()
        tol = FP32_BOUND * ref.abs().max().item()
    want = {"k1": 0, "k2": k1_per_eval(refiner.unet.config, REFINER_RES), "k3": 0, "k4": 0}
    del refiner, eps, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fp32 refiner parity unguided UNet eval {REFINER_RES}²: kernels (fp32 route "
        f"{used}) vs plain max|d eps| {err:.3e} <= {tol:.3e} (FP32_BOUND * max|ref|); "
        f"{time.perf_counter() - t0:.1f} s")
    if used != want or not err <= tol:
        raise AssertionError(f"fp32 refiner parity: launches {used} (want {want}), max|d| "
                             f"{err} > {tol}")


def phase_fp32(torch, fa, fs, device, card):
    """The fp32 stacks end to end on the kernels' fp32 route: `python -m
    controllora_tpu_torch.train --model_variant sd15 --mixed_precision no` at 512²,
    batch 8, remat dots for FP32_TRAIN_STEPS steps, then one step under
    CONTROLLORA_FLASH_IMPL=stock (K5), each with exact launches (train_launches,
    STOCK_LAUNCHES), all on the fp32 route; one step's gradient on the kernels against
    plain attention (fp32_train_parity); the smoke stack's train step and sample CLI at
    512² (K2-K4 at D 8 and 32, K1 at D 8); the refiner's eval parity in fp32 and `serve
    --model_variant sdxl-refiner --warmup` (fp32) answering one unguided 20-step 1024²
    request, {k1 0, k2 401}. Returns the main paths' launches, each counted from 0:
    ({kernel: launches}, {kernel: fp32-route launches})."""
    from controllora_tpu_torch import sample as sample_cli
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.utils.png import decode_png

    t_phase = time.perf_counter()
    total, total32 = {}, {}

    def add(name, out, used, used32, want):
        """Hold a main path's launches to `want` (k5 counters 0 unless given), every
        one on the fp32 route; add them to the totals."""
        want = {n: want.get(n, 0) for n in used}
        if used != want or used32 != used:
            raise AssertionError(f"fp32 {name}: launches {used} (want {want}), fp32 route "
                                 f"{used32}\n" + out[-2000:])
        for n in used:
            total[n] = total.get(n, 0) + used[n]
            total32[n] = total32.get(n, 0) + used32[n]

    def steps_of(out):
        lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
        return ([float(ln.split()[-2]) for ln in lines],
                [float(ln.split("loss=")[1].split()[0]) for ln in lines])

    sd15 = zoo.VARIANTS[FP32_VARIANT][0]
    smoke = zoo.VARIANTS["smoke"][0]
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--resolution", str(RES), "--log_every", "1", "--checkpointing_steps", "0",
                  "--mixed_precision", "no", "--device", CLI_DEVICE]
        train = common + ["--model_variant", FP32_VARIANT, "--train_batch_size",
                          str(FP32_TRAIN_BATCH), "--gradient_checkpointing", "--remat_policy",
                          "dots", "--output_dir", os.path.join(tmp, "sd15")]
        t0 = time.perf_counter()
        out, used, used32 = fp32_cli(torch, fa, fs, "controllora_tpu_torch.train",
                                     train + ["--max_train_steps", str(FP32_TRAIN_STEPS)])
        per_step = train_launches(sd15, RES, "dots")
        add("train", out, used, used32, {n: c * FP32_TRAIN_STEPS for n, c in per_step.items()})
        ms, losses = steps_of(out)
        if len(ms) != FP32_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"fp32 train: steps {ms}, losses {losses}\n{out[-2000:]}")
        log(f"fp32 train (python -m controllora_tpu_torch.train --mixed_precision no) "
            f"{FP32_VARIANT} {RES}² batch {FP32_TRAIN_BATCH}, remat dots: steps " + ", ".join(
                f"{x:.1f}" for x in ms) + " ms, losses " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; launches per step {per_step}, all on the fp32 route; "
            f"{time.perf_counter() - t0:.1f} s with the stack's build; {card}")
        os.environ["CONTROLLORA_FLASH_IMPL"] = "stock"
        try:
            t0 = time.perf_counter()
            out, used, used32 = fp32_cli(torch, fa, fs, "controllora_tpu_torch.train",
                                         train + ["--max_train_steps", "1"])
        finally:
            del os.environ["CONTROLLORA_FLASH_IMPL"]
        add("stock train", out, used, used32, STOCK_LAUNCHES["dots"])
        ms, losses = steps_of(out)
        if len(ms) != 1 or not math.isfinite(losses[0]):
            raise AssertionError(f"fp32 stock train: {ms}, {losses}\n{out[-2000:]}")
        log(f"fp32 stock train (K5, CONTROLLORA_FLASH_IMPL=stock) {FP32_VARIANT} {RES}² batch "
            f"{FP32_TRAIN_BATCH}: 1 step {ms[0]:.1f} ms, loss {losses[0]:.4f}; launches "
            f"{used}, all on the fp32 route; {time.perf_counter() - t0:.1f} s")
        fp32_train_parity(torch, fa, device)

        t0 = time.perf_counter()
        smoke_dir = os.path.join(tmp, "smoke")
        out, used, used32 = fp32_cli(torch, fa, fs, "controllora_tpu_torch.train",
                                     common + ["--model_variant", "smoke", "--train_batch_size",
                                               "2", "--max_train_steps", "1",
                                               "--output_dir", smoke_dir])
        add("smoke train", out, used, used32, train_launches(smoke, RES, None))
        log(f"fp32 smoke train (--model_variant smoke --mixed_precision no) {RES}² batch 2, "
            f"1 step: launches {used}, all on the fp32 route; {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sample_dir = os.path.join(tmp, "sample")
        out, used, used32 = fp32_cli(torch, fa, fs, "controllora_tpu_torch.sample",
                                     ["--model_variant", "smoke", "--control_lora_dir",
                                      smoke_dir, "--resolution", str(RES),
                                      "--num_validation_images", "1",
                                      "--output_dir", sample_dir, "--device", CLI_DEVICE])
        steps = sample_cli.parse_args(["--control_lora_dir", smoke_dir]).num_inference_steps
        with open(os.path.join(sample_dir, "0.png"), "rb") as f:
            montage = decode_png(f.read())
        add("smoke sample", out, used, used32,
            {"k1": steps * k1_per_eval(smoke, RES), "k2": vae_launches(RES)})
        if montage.shape != (RES, 3 * RES, 3):
            raise AssertionError(f"fp32 smoke sample: montage {montage.shape}")
        log(f"fp32 smoke sample (python -m controllora_tpu_torch.sample --model_variant smoke "
            f"at {RES}², its default, and its default {steps} steps): montage {montage.shape}; launches {used}, "
            f"all on the fp32 route; {time.perf_counter() - t0:.1f} s")

    fp32_refiner_parity(torch, fa, device)
    fs.reset_launch_counts()  # family_http resets the K1-K4 counts itself
    used = family_http(torch, fa, REFINER, REFINER_RES, device, card, warm=True,
                       steps=FP32_REFINER_STEPS)
    # read just after the request, as family_http read its own: nothing launched since
    add("refiner server", "", {**used, **fs.LAUNCHES}, {**fa.FP32_LAUNCHES, **fs.FP32_LAUNCHES},
        used)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fp32 phase {time.perf_counter() - t_phase:.1f} s; main-path launches {total}, on "
        f"the fp32 route {total32}")
    return total, total32


def main_cards(torch, fa, device, card):
    """``python3 chip_smoke.py --cards`` on a host with PAR_WORLD cards: phase
    "parallel" with one rank a card over nccl (the collectives across NVLink), and
    nothing else; the same last lines."""
    if torch.cuda.device_count() < PAR_WORLD:
        raise SystemExit(f"--cards needs {PAR_WORLD} CUDA devices, found "
                         f"{torch.cuda.device_count()}")
    PAR["backend"] = "nccl"
    phase_parallel(torch, fa, device, card)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
    from controllora_tpu_torch.ops import flash_stock as fs

    t0 = time.perf_counter()
    fa.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s ({fa.library_path().name})")
    report = ptxas_report(fa)
    for e in report:
        log(f"  ptxas {ptxas_line(e)}")
    bad = [ptxas_line(e) for e in report
           if e["spill_stores"] or e["spill_loads"] or e["serialised"]]
    if bad:
        raise AssertionError("ptxas spilled or serialised wgmma: " + "; ".join(bad))
    if "--cards" in sys.argv[1:]:
        return main_cards(torch, fa, device, card)

    marks = [("build", time.perf_counter())]

    def mark(name):  # the seconds since the last mark, summed up by the last log line
        marks.append((name, time.perf_counter()))

    record = phase_kernels(torch, fa, device)
    phase_family_kernels(torch, fa, device, record)
    fp32_record = phase_fp32_kernels(torch, fa, fs, device)
    phase_mode_kernels(torch, fa, device, record)
    record.update(phase_backward_kernels(torch, fa, device))
    phase_family_train_kernels(torch, fa, device, record)
    phase_canny_train_kernels(torch, fa, device, record)
    phase_parallel_kernels(torch, fa, device, record)
    phase_flash_grad(torch, fa, device)
    record.update(phase_stock_kernels(torch, fs, device))
    phase_stock_grad(torch, fs, device)
    mark("kernels")
    pipe = build_stack(torch, device)
    phase_parity(torch, pipe, device)
    phase_breakdown(torch, pipe, device)
    serve = phase_serve(torch, fa, pipe)
    mark("parity, layers, serve")
    phase_merged_kernels(torch, fa, device, record)
    presets = phase_presets(torch, fa, pipe, device, card)
    mark("presets")
    phase_render_profile(torch, pipe)
    phase_decode(torch, pipe, device)
    mark("decode")
    phase_train_parity(torch, pipe, device)
    phase_adam8bit(torch, pipe, device)
    train = phase_train(torch, fa, pipe, device)
    mark("train parity, 8-bit AdamW, train")
    modes = phase_modes(torch, fa, pipe, device, card)
    mark("modes")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    parallel = phase_parallel(torch, fa, device, card)
    mark("parallel")
    phase_entry_point(torch, beside=lambda: phase_cli_resume(torch))
    stock = phase_stock_train(torch, fa, fs)
    mark("entry, CLI smoke, stock train")
    fp32_paths, fp32_paths32 = phase_fp32(torch, fa, fs, device, card)
    mark("fp32")
    families = phase_families(torch, fa, device, card)
    mark("families")
    family_train = phase_family_train(torch, fa, device, card)
    phase_train_cli(torch, card)
    dreambooth = phase_dreambooth(torch, fa, card)
    mark("family train, train CLI, dreambooth")
    weights = phase_weights(torch, fa, card)
    mark("weights")
    annotators = phase_annotators(torch, fa, card)
    mark("annotators")
    eval_presets = phase_eval_presets(torch, fa, card)
    mark("eval presets")
    log("phase seconds: " + ", ".join(f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t)
                                      in zip(marks, marks[1:])))
    # launches on the main paths, each counted from 0: serving, the serving presets,
    # training (K1-K4), the render modes, the other families' renders (exact, tome,
    # turbo) and requests (SDXL, the refiner), their training and DreamBooth's steps,
    # the loaded stack's renders and the canny2image request, the pose2image request,
    # every rank's mesh renders and dp step, the presets' quality check, then training
    # under CONTROLLORA_FLASH_IMPL=stock (K5), then the fp32 stacks' paths (K1-K5 on
    # their fp32 route)
    paths = (serve, presets, train, modes, families, family_train, dreambooth, weights,
             annotators, parallel, eval_presets)
    launches = {n: sum(p.get(n, 0) for p in paths) for n in serve}
    launches.update({n: stock[n] for n in fs.LAUNCHES})
    launches = {n: c + fp32_paths[n] for n, c in launches.items()}

    fwd = "controllora_tpu_torch/csrc/flash_attn_fwd.cu"
    bwd = "controllora_tpu_torch/csrc/flash_attn_bwd.cu"
    vjp = "controllora_tpu/ops/pallas_attention_vjp.py"
    stock_tpu = "jax/experimental/pallas/ops/tpu/flash_attention.py"  # via attention.py:73

    def route(name, source, replaces, counter, cuda_kernels):
        """One kernel's record: the CUDA kernels its route launches, with the ptxas
        report of their instances, its launches on the main paths (both routes) and
        its fp32 route's own record under "fp32" (the CUDA kernels, ptxas, launches,
        errors and times)."""
        def lines(kernels):
            return [ptxas_line(e) for e in report if e["kernel"].split("<")[0] in kernels]

        fp32 = dict(route="cuda", source="controllora_tpu_torch/csrc/flash_attn_fp32.cu",
                    cuda_kernels=FP32_ROUTES[counter], ptxas=lines(FP32_ROUTES[counter]),
                    launches=fp32_paths32[counter], **fp32_record[counter])
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[counter], cuda_kernels=cuda_kernels,
                    ptxas=lines(cuda_kernels), **record[counter], fp32=fp32)

    kernels = [
        route("k1_biased_flash_fwd", fwd, "controllora_tpu/ops/pallas_attention.py:56", "k1",
              ["bias_add_kernel", "flash_fwd_kernel", "combine_splits_kernel"]),
        route("k2_flash_fwd_lse", fwd, f"{vjp}:46", "k2",
              ["flash_fwd_kernel", "combine_splits_kernel"]),
        route("k3_flash_bwd_dkv", bwd, f"{vjp}:126", "k3", ["flash_bwd_dkv_kernel"]),
        route("k4_flash_bwd_dq", bwd, f"{vjp}:165", "k4", ["flash_bwd_dq_kernel"]),
        route("k5_stock_flash_fwd", fwd, f"{stock_tpu}:331", "k5_fwd", ["flash_fwd_kernel"]),
        route("k5_stock_flash_bwd_dkv", bwd, f"{stock_tpu}:796", "k5_dkv",
              ["flash_bwd_dkv_kernel"]),
        route("k5_stock_flash_bwd_dq", bwd, f"{stock_tpu}:1146", "k5_dq",
              ["flash_bwd_dq_kernel"]),
    ]
    for k in kernels:
        if k["launches"] < 1 or k["fp32"]["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main path (launches "
                                 f"{k['launches']}, on the fp32 route {k['fp32']['launches']})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
