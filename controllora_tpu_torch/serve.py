"""HTTP serving front end over the BatchingEngine (counterpart of ``scripts/serve.py``,
with its flags, defaults, preset table and JSON contract for the flags it takes).

    python -m controllora_tpu_torch.serve --port 8000 --preset turbo --warmup
    python -m controllora_tpu_torch.serve --model_variant sdxl --port 8000
    python -m controllora_tpu_torch.serve --device cpu --model_variant smoke --port 8000

A stdlib ThreadingHTTPServer takes concurrent JSON requests; each request is one
image rendered through ``serving.BatchingEngine``, which coalesces concurrent
traffic into bucketed batches. ``--pretrained_model_name_or_path`` loads the frozen
stack from a local diffusers-layout directory (``zoo.load_frozen``; the real CLIP
BPE vocab is then required, ``$CLIP_VOCAB_DIR``); without it the stack gets seeded
random weights (there are none in the repository) and a warning says so.
``--control_lora_dir`` loads a ControlLoRA artifact (``training/checkpoint.py``);
without one the guide is not used.

Model families (``--model_variant``): sd15, sd21 (768², v-prediction is the
scheduler's) and sdxl (1024²) run in bf16, the smoke stacks smoke, smoke2 and
smokexl in fp32, as ``scripts/serve.py`` runs them. The render size comes with each
request (``"width": 1024, "height": 1024``). The SDXL refiner serves too
(``--model_variant sdxl-refiner``; its smoke stack ``smokeref``): a request is
unguided unless ``--control_lora_dir`` is given, and the refiner's text tower alone
(``text_encoder_2/``) encodes the prompt. ``sdxl-refiner`` runs in bf16, with the base
family. This deviates from ``scripts/serve.py``, whose dtype rule makes only sd15,
sd21 and sdxl bf16 and so serves the refiner in fp32: the flash kernels K1 and K2
take bf16 only (``ops/flash_attention.py``), and a plain attention on the card would
hide them. It is the rule the sampling CLI's base -> refiner ensemble already follows
(``python -m controllora_tpu_torch.sample --refiner_variant``). ``smokeref`` stays
fp32, as ``scripts/serve.py`` has it.

Speed presets (deployment-wide, applied to every batch): ``exact`` (the exact
sampler), ``tome`` (token merging 0.5) and ``turbo`` (token merging 0.5 + DeepCache
interval 2); an explicit ``--tome_ratio`` or ``--deepcache_interval`` wins over the
preset's value.

API:
    GET  /healthz  -> 200 "ok"
    GET  /stats    -> the engine's statistics, JSON
    POST /generate -> JSON request:
        {"prompt": str, "negative_prompt": str, "steps": int, "seed": int,
         "guidance_scale": float, "width": int, "height": int,
         "guide": <base64 PNG, optional: the annotator-space condition image>}
      response: {"image": <base64 PNG>, "seconds": float}; 504 when the render
      outlasts --result_timeout_s, 500 with the error text when it fails.

``--serving_mesh`` (as ``sample.py``'s, one rank a process under torchrun): rank 0
runs the HTTP server and the engine; for each batch the engine's call is broadcast
to the other ranks, which make the same pipeline call, and a stop message ends them
at shutdown. ``/stats`` shows the mesh's shape.
"""

from __future__ import annotations

import argparse
import base64
import json
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from controllora_tpu_torch.models.zoo import BASE_VARIANTS, model_dtype
from controllora_tpu_torch.parallel import distributed
from controllora_tpu_torch.parallel.distributed import add_dist_args
from controllora_tpu_torch.sample import start_mesh
from controllora_tpu_torch.schedulers import (
    DDIMScheduler,
    DPMSolverMultistepScheduler,
    EulerDiscreteScheduler,
    PNDMScheduler,
    UniPCMultistepScheduler,
)

PRESETS = {"exact": (0.0, 1), "tome": (0.5, 1), "turbo": (0.5, 2)}
# the base models and the refiner stacks
MODEL_VARIANTS = BASE_VARIANTS + ("sdxl-refiner", "smokeref")
SCHEDULERS = {"dpm++": DPMSolverMultistepScheduler, "ddim": DDIMScheduler,
              "pndm": PNDMScheduler, "euler": EulerDiscreteScheduler,
              "unipc": UniPCMultistepScheduler}


def serve_dtype(variant: str) -> torch.dtype:
    """The dtype the server builds ``variant`` in: ``model_dtype``'s, except the SDXL
    refiner, which runs in bf16 with its base family (see the module docstring)."""
    return torch.bfloat16 if variant == "sdxl-refiner" else model_dtype(variant)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="local diffusers-layout checkpoint directory (unet/, vae/, "
                        "text_encoder[_2]/); omit for seeded random weights")
    p.add_argument("--model_variant", type=str, default="sd15", choices=MODEL_VARIANTS)
    p.add_argument("--control_lora_dir", type=str, default=None)
    p.add_argument("--serving_mesh", type=str, default=None,
                   help="'data' | 'cfg' | 'cfg,model=K' | 'data,cfg' …")
    p.add_argument("--scheduler", type=str, default="dpm++", choices=tuple(SCHEDULERS))
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--buckets", type=str, default="1,2,4",
                   help="allowed batch sizes; a batch pads up to the next one")
    p.add_argument("--warmup", action="store_true",
                   help="render one batch of every bucket at 512², 20 steps before "
                        "listening (guided and unguided when a ControlLoRA is loaded): "
                        "the kernels build and the card warms up outside a request")
    p.add_argument("--result_timeout_s", type=float, default=600.0,
                   help="per-request cap on waiting for the engine; 504 past it")
    p.add_argument("--preset", type=str, default="exact", choices=tuple(PRESETS),
                   help="speed/quality preset: exact = the exact sampler; tome = token "
                        "merging 0.5; turbo = token merging 0.5 + DeepCache interval 2. "
                        "Explicit --tome_ratio/--deepcache_interval override the "
                        "preset's value. On an H100, tome alone is not faster than "
                        "exact yet: its merge bookkeeping costs more device time "
                        "than the merged attention saves (PERF.md)")
    p.add_argument("--tome_ratio", type=float, default=None,
                   help="deployment-wide token merging (0 = exact; 0.5 = the "
                        "published sweet spot) applied to every batch")
    p.add_argument("--deepcache_interval", type=int, default=None,
                   help="deployment-wide DeepCache interval (1 = exact; 2-3 = the "
                        "published speed/quality range) applied to every batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the flash kernels run on cuda")
    add_dist_args(p)
    args = p.parse_args(argv)
    tome_ratio, interval = PRESETS[args.preset]
    if args.tome_ratio is None:
        args.tome_ratio = tome_ratio
    if args.deepcache_interval is None:
        args.deepcache_interval = interval
    return args


def build_pipeline(args, mesh=None):
    """The pipeline the server renders with: the frozen stack of ``--model_variant``
    (``serve_dtype``) loaded from ``--pretrained_model_name_or_path`` or with seeded
    random weights, the ControlLoRA of ``--control_lora_dir`` if given,
    ``--scheduler``, over ``mesh``."""
    from controllora_tpu_torch.data.tokenizer import default_tokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline

    device = torch.device(args.device)
    dtype = serve_dtype(args.model_variant)
    unet, vae, text_encoder = zoo.frozen_stack(args.pretrained_model_name_or_path,
                                               args.model_variant, dtype, device,
                                               torch.Generator(device).manual_seed(0))
    if not args.pretrained_model_name_or_path:
        print("WARNING: random frozen stack (no pretrained weights)", flush=True)
    control_lora = None
    if args.control_lora_dir:
        from controllora_tpu_torch.training.checkpoint import load_control_lora

        control_lora, _ = load_control_lora(args.control_lora_dir, device)
    tokenizer = default_tokenizer(require_clip=bool(args.pretrained_model_name_or_path))
    return StableDiffusionControlLoRAPipeline(unet, vae, text_encoder, tokenizer,
                                              control_lora,
                                              scheduler=SCHEDULERS[args.scheduler](),
                                              device=device, mesh=mesh)


def speed_kwargs(args):
    """The preset's pipeline arguments, passed with every batch."""
    kw = {}
    if args.tome_ratio:
        kw["tome_ratio"] = args.tome_ratio
    if args.deepcache_interval > 1:
        kw["deepcache_interval"] = args.deepcache_interval
    return kw


def warmup(engine) -> None:
    """One full batch of every bucket at 512², 20 steps, unguided and (with a
    ControlLoRA) guided."""
    variants = [dict()]
    if engine.pipe.control_lora is not None:
        variants.append(dict(guide=np.zeros((512, 512, 3), np.float32)))
    for kw in variants:
        for b in engine.buckets:
            futs = [engine.submit(f"warmup {i}", num_inference_steps=20, **kw)
                    for i in range(b)]
            for f in futs:
                f.result()


def build_server(engine, host: str, port: int,
                 result_timeout_s: float = 600.0) -> ThreadingHTTPServer:
    from controllora_tpu_torch.utils.png import decode_png, encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            pass

        def _send(self, code, ctype, payload: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _json(self, code, obj):
            self._send(code, "application/json", json.dumps(obj).encode("utf-8"))

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "text/plain", b"ok")
            elif self.path == "/stats":
                self._json(200, engine.stats)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, "text/plain", b"not found")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            try:
                req = json.loads(body)
                kw = dict(
                    negative_prompt=str(req.get("negative_prompt", "")),
                    num_inference_steps=int(req.get("steps", 20)),
                    guidance_scale=float(req.get("guidance_scale", 9.0)),
                    height=int(req.get("height", 512)),
                    width=int(req.get("width", 512)),
                    seed=int(req.get("seed", 0)),
                )
                if req.get("guide"):
                    g = decode_png(base64.b64decode(req["guide"]))
                    kw["guide"] = g.astype(np.float32) / 127.5 - 1.0
                t0 = time.monotonic()
                # bounded wait: a wedged or stopped engine must not pin this thread
                img = engine.submit(str(req.get("prompt", "")), **kw).result(
                    timeout=result_timeout_s)
                self._json(200, {"image": base64.b64encode(encode_png(img)).decode("ascii"),
                                 "seconds": round(time.monotonic() - t0, 3)})
            except FutureTimeout:
                self._json(504, {"error": f"render exceeded {result_timeout_s:.0f}s "
                                          "engine budget"})
            except Exception as e:  # the server keeps serving; the client gets the text
                self._json(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


class MeshLeader:
    """Rank 0's pipeline on a multi-rank mesh: each call is first broadcast to the
    other ranks (``follow``), which make the same call; other attributes are the
    pipeline's."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, *args, **kw):
        _broadcast(("call", args, kw))
        return self.pipe(*args, **kw)

    def stop(self) -> None:
        _broadcast(("stop", (), {}))


def _broadcast(message=None):
    import torch.distributed as dist

    box = [message]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(pipe) -> int:
    """A rank other than 0: make every call rank 0's engine makes, until the stop
    message; returns the number of calls. A failed call fails on rank 0 too, whose
    engine fails the batch and keeps serving, so this rank keeps following."""
    calls = 0
    while True:
        kind, args, kw = _broadcast()
        if kind == "stop":
            return calls
        calls += 1
        if pipe.mesh.member:
            try:
                pipe(*args, **kw)
            except Exception as e:
                print(f"rank {pipe.mesh.rank}: call {calls} failed: {e}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    mesh, started = start_mesh(args)
    try:
        _serve(args, mesh)
    finally:
        distributed.stop(started)


def _serve(args, mesh):
    from controllora_tpu_torch.serving import BatchingEngine

    pipe = build_pipeline(args, mesh)
    if mesh is not None and mesh.rank != 0:
        calls = follow(pipe)
        print(f"rank {mesh.rank}: followed {calls} calls", flush=True)
        return
    leader = MeshLeader(pipe) if mesh is not None and mesh.devices > 1 else None
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = BatchingEngine(leader or pipe, max_wait_ms=args.max_wait_ms, buckets=buckets,
                            pipe_kwargs=speed_kwargs(args))
    server = None
    try:
        if args.warmup:
            warmup(engine)
            print(f"warmup done: buckets {engine.buckets} "
                  f"({'guided+unguided' if pipe.control_lora is not None else 'unguided'})",
                  flush=True)
        server = build_server(engine, args.host, args.port,
                              result_timeout_s=args.result_timeout_s)
        print(f"serving at http://{args.host}:{server.server_address[1]}/ (buckets "
              f"{buckets}, max_wait {args.max_wait_ms} ms, preset {args.preset}: "
              f"{speed_kwargs(args) or 'exact'})", flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.server_close()
        engine.stop()
        if leader is not None:
            leader.stop()


if __name__ == "__main__":
    main()
