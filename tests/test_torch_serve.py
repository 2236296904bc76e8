"""The port's HTTP server (``python -m controllora_tpu_torch.serve``) and its PNG codec.

* The flags the port takes parse as ``scripts/serve.py`` parses them: every preset,
  every explicit override of a preset's knob, every served model variant, and the
  defaults. Each variant's dtype is the one ``scripts/serve.py`` builds it in (bf16
  for sd15, sd21 and sdxl, fp32 for the smoke stacks and ``smokeref``), but for the
  recorded deviation: ``sdxl-refiner`` is bf16, as the base family (``scripts/serve.py``
  builds it in fp32, which the flash kernels refuse).
* The refiner served: an in-process server on ``smokeref`` (weights filled as
  ``tests/test_torch_families.py`` fills them, loaded into ``serve.build_pipeline``'s
  stack) answers an unguided 64² /generate whose PNG is the JAX pipeline's render of the
  same request (the same latents, from the request's seed) within atol 2e-3 on the
  [-1, 1] image, read through the PNG's uint8 quantisation.
* An in-process server on 127.0.0.1:0 over a CPU smoke pipeline (seeded random
  weights, a small ControlLoRA artifact loaded through ``--control_lora_dir``):
  /healthz, /stats, /generate with a base64 PNG guide (the response decodes to an
  H x W x 3 image), two concurrent requests coalescing into one batch, 404, the 500
  with the error text, and the 504 when the engine outlasts the request's budget.
* ``utils/png.py`` round-trips and agrees with PIL (which this test may use; the
  port may not) on RGB, RGBA and grayscale, and on rows of each of the five filter
  types; it refuses what it does not decode.
"""

import base64
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from controllora_tpu_torch import serve
from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import derive_cross_attention_dims
from controllora_tpu_torch.serving import BatchingEngine
from controllora_tpu_torch.serving.engine import request_latents
from controllora_tpu_torch.training.checkpoint import save_control_lora
from controllora_tpu_torch.utils import convert
from controllora_tpu_torch.utils.png import decode_png, encode_png
from scripts.serve import parse_args as jax_parse_args
from test_torch_families import filled

ARGVS = [[], ["--preset", "exact"], ["--preset", "tome"], ["--preset", "turbo"],
         ["--preset", "turbo", "--deepcache_interval", "3"],
         ["--preset", "exact", "--tome_ratio", "0.3"],
         ["--preset", "tome", "--tome_ratio", "0"],
         ["--preset", "turbo", "--tome_ratio", "0.25", "--deepcache_interval", "1"],
         ["--scheduler", "unipc", "--buckets", "1,4", "--warmup", "--port", "0",
          "--max_wait_ms", "5", "--result_timeout_s", "30", "--host", "127.0.0.1"],
         ["--model_variant", "sd21"], ["--model_variant", "sdxl", "--buckets", "1,2"],
         ["--model_variant", "smoke2"], ["--model_variant", "smokexl", "--preset", "tome"],
         ["--serving_mesh", "data,cfg"], ["--serving_mesh", "cfg,model=2", "--preset", "turbo"]]
JAX_ONLY = set()  # --serving_mesh is taken since the port has parallelism
PORT_ONLY = {"device": "cuda", "dist_backend": None}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_flags_parse_as_scripts_serve(argv):
    ours, ref = vars(serve.parse_args(argv)), vars(jax_parse_args(argv))
    assert {k: ours.pop(k) for k in PORT_ONLY} == PORT_ONLY
    assert set(ref) - set(ours) == JAX_ONLY
    assert ours == {k: v for k, v in ref.items() if k not in JAX_ONLY}


def jax_serve_dtype(variant, monkeypatch):
    """The dtype scripts/serve.py's build_pipeline builds ``variant`` in, read off its
    call of the JAX zoo's build_models, as a torch dtype."""
    import jax.numpy as jnp

    from controllora_tpu.models import zoo as jzoo
    from scripts.serve import build_pipeline as jax_build_pipeline

    class Built(Exception):
        pass

    def build_models(name, dtype):
        raise Built(name, dtype)

    monkeypatch.setattr(jzoo, "build_models", build_models)
    with pytest.raises(Built) as built:
        jax_build_pipeline(jax_parse_args(["--model_variant", variant]))
    assert built.value.args[0] == variant
    return {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[built.value.args[1]]


@pytest.mark.parametrize("variant", zoo.BASE_VARIANTS)
def test_model_dtype_as_scripts_serve(variant, monkeypatch):
    """The dtype scripts/serve.py builds each base variant in is the port's."""
    assert zoo.model_dtype(variant) == jax_serve_dtype(variant, monkeypatch)
    assert serve.serve_dtype(variant) == zoo.model_dtype(variant)


@pytest.mark.parametrize("argv", [
    ["--model_variant", "sdxl-refiner", "--pretrained_model_name_or_path", "/ckpt/refiner",
     "--buckets", "1", "--warmup"],
    ["--model_variant", "smokeref", "--control_lora_dir", "/runs/x", "--preset", "turbo"]],
    ids=lambda a: " ".join(a))
def test_refiner_flags_parse_as_scripts_serve(argv):
    ours, ref = vars(serve.parse_args(argv)), vars(jax_parse_args(argv))
    assert {k: ours.pop(k) for k in PORT_ONLY} == PORT_ONLY
    assert ours == ref
    assert "sdxl-refiner" not in zoo.BASE_VARIANTS  # the sample CLI's base choices


@pytest.mark.parametrize("variant", ["smokeref", "sdxl-refiner"])
def test_refiner_dtype_rule(variant, monkeypatch):
    """smokeref is fp32, as scripts/serve.py builds it. sdxl-refiner is bf16 with its
    base family, where scripts/serve.py builds it in fp32: the recorded deviation (K1
    and K2 take bf16 only)."""
    jax_dtype = jax_serve_dtype(variant, monkeypatch)
    assert jax_dtype == torch.float32
    want = torch.bfloat16 if variant == "sdxl-refiner" else jax_dtype
    assert serve.serve_dtype(variant) == want


@pytest.fixture(scope="module")
def smokeref_jax():
    """(JAX pipeline on filled smokeref weights, those weights)."""
    import jax
    import jax.numpy as jnp

    from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
    from controllora_tpu.models import zoo as jzoo
    from controllora_tpu.pipelines import StableDiffusionControlLoRAPipeline as JPipeline

    unet, vae, text = jzoo.build_models("smokeref", dtype=jnp.float32)
    frozen = filled(jax.eval_shape(lambda: jzoo.random_frozen(
        jax.random.PRNGKey(0), unet, vae, text, latent_size=8,
        param_dtype=jnp.float32)), 4)
    return JPipeline(unet, vae, text, JHashTokenizer(), frozen), frozen


def test_refiner_server_matches_jax_render(smokeref_jax):
    jpipe, frozen = smokeref_jax
    args = serve.parse_args(["--device", "cpu", "--model_variant", "smokeref"])
    pipe = serve.build_pipeline(args)
    assert pipe.control_lora is None and pipe.unet.conv_in.weight.dtype == torch.float32
    convert.load_unet(pipe.unet, frozen["unet"])
    convert.load_vae(pipe.vae, frozen["vae"])
    convert.load_clip(pipe.text_encoder, frozen["text"])
    engine, server, base = serving(pipe, args, buckets=(1,))
    try:
        code, raw = request(base, "/generate", dict(prompt="a red square", steps=2,
                                                    width=64, height=64, seed=3))
    finally:
        stop(engine, server)
    assert code == 200, raw
    img = decode_png(base64.b64decode(json.loads(raw)["image"])).astype(np.int64)
    ref = jpipe("a red square", latents=request_latents(3, 64, 64), num_inference_steps=2,
                guidance_scale=9.0, height=64, width=64, return_array=True)[0]

    def u8(x):  # the server's quantisation of a [-1, 1] image
        return np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255).astype(np.int64)

    assert img.shape == (64, 64, 3)
    # within atol 2e-3 on [-1, 1]: each level lies between those of ref -+ 2e-3
    assert ((u8(ref - 2e-3) <= img) & (img <= u8(ref + 2e-3))).all()
    assert len(np.unique(img)) > 16  # a picture, not a flat field


def test_speed_kwargs_of_presets():
    assert serve.speed_kwargs(serve.parse_args([])) == {}
    assert serve.speed_kwargs(serve.parse_args(["--preset", "tome"])) == {"tome_ratio": 0.5}
    assert serve.speed_kwargs(serve.parse_args(["--preset", "turbo"])) == {
        "tome_ratio": 0.5, "deepcache_interval": 2}


@pytest.fixture(scope="module")
def smoke_pipe(tmp_path_factory):
    """serve.build_pipeline on the CPU: the smoke stack, turbo, and a small
    ControlLoRA artifact (every parameter +0.01, so the guide reaches the image)."""
    cfg = ControlLoRAConfig(
        block_out_channels=(8, 16, 16, 32), lora_block_in_channels=(32, 32, 32, 32),
        lora_block_out_channels=(32, 64, 96, 96),
        lora_cross_attention_dims=derive_cross_attention_dims(zoo.SMOKE_UNET))
    control = zoo.build_control_lora(cfg, "cpu", torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in control.parameters():
            p.add_(0.01)
    out = str(tmp_path_factory.mktemp("control"))
    save_control_lora(out, control)
    args = serve.parse_args(["--device", "cpu", "--model_variant", "smoke", "--preset",
                             "turbo", "--control_lora_dir", out])
    return serve.build_pipeline(args), args


def request(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                    timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serving(pipe, args, timeout_s=300.0, **engine_kw):
    """(engine, server, base URL) with the server answering in a thread."""
    engine = BatchingEngine(pipe, pipe_kwargs=serve.speed_kwargs(args), **engine_kw)
    server = serve.build_server(engine, "127.0.0.1", 0, result_timeout_s=timeout_s)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return engine, server, f"http://127.0.0.1:{server.server_address[1]}"


def stop(engine, server):
    """Stop both; the engine's worker finishes the render in hand first (under the
    504 test, the one whose result nobody waits for), which a loaded CPU may take
    many seconds over."""
    server.shutdown()
    server.server_close()
    engine.stop(timeout=300.0)
    assert not engine._worker.is_alive()


def guide_png():
    g = np.zeros((64, 64, 3), np.uint8)
    g[20:40, 20:40] = 255
    return base64.b64encode(encode_png(g)).decode()


def test_server_endpoints(smoke_pipe):
    pipe, args = smoke_pipe
    assert pipe.device == torch.device("cpu") and pipe.control_lora is not None
    assert type(pipe.scheduler).__name__ == "DPMSolverMultistepScheduler"
    engine, server, base = serving(pipe, args, max_wait_ms=2000.0, buckets=(1, 2))
    try:
        assert request(base, "/healthz") == (200, b"ok")
        assert request(base, "/nope")[0] == 404
        body = dict(prompt="a red square", steps=2, width=64, height=64, seed=3,
                    guide=guide_png())
        with ThreadPoolExecutor(2) as pool:
            replies = list(pool.map(lambda s: request(base, "/generate", dict(body, seed=s)),
                                    (3, 4)))
        images = []
        for code, raw in replies:
            assert code == 200, raw
            reply = json.loads(raw)
            assert reply["seconds"] >= 0
            images.append(decode_png(base64.b64decode(reply["image"])))
        assert all(img.shape == (64, 64, 3) and img.dtype == np.uint8 for img in images)
        assert not np.array_equal(images[0], images[1])  # seeds 3 and 4
        code, raw = request(base, "/stats")
        stats = json.loads(raw)
        assert code == 200 and stats["batch_sizes"] == {"2": 1} and stats["requests"] == 2
        code, raw = request(base, "/generate", dict(body, guide="bm90IGEgcG5n"))
        assert code == 500 and "not a PNG" in json.loads(raw)["error"]
    finally:
        stop(engine, server)


def test_server_times_out_with_504(smoke_pipe):
    pipe, args = smoke_pipe
    engine, server, base = serving(pipe, args, timeout_s=0.0, buckets=(1,))
    try:
        code, raw = request(base, "/generate", dict(prompt="x", steps=2, width=64,
                                                    height=64))
        assert code == 504 and "engine budget" in json.loads(raw)["error"]
    finally:
        stop(engine, server)


# ---------------------------------------------------------------------------- PNG


def pil_png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def picture(rng, h, w, c):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[h // 3:h // 2] = 17  # flat rows, which encoders filter otherwise
    img[:, w // 2] = np.arange(h, dtype=np.uint8)[:, None]
    return img


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4), ("L", 1)])
def test_png_decode_agrees_with_pil(mode, channels):
    arr = picture(np.random.default_rng(channels), 37, 53, channels)
    if channels == 1:
        arr = arr[..., 0]
    data = pil_png(arr, mode)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), ref)


def test_png_encode_round_trips_and_pil_reads_it():
    img = picture(np.random.default_rng(0), 40, 31, 3)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


def filtered_png(img, kinds):
    """An RGBA PNG whose row y is filtered with kinds[y % len(kinds)] (PNG spec 9.2)."""
    h, w, c = img.shape
    raw, prev = bytearray(), np.zeros(w * c, np.int32)
    for y in range(h):
        kind, cur = kinds[y % len(kinds)], img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][kind]
        raw += bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_every_filter_type():
    img = picture(np.random.default_rng(5), 24, 19, 4)
    data = filtered_png(img, kinds=(0, 1, 2, 3, 4, 4, 3, 1))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(decode_png(data), img[..., :3])


def test_png_refuses_what_it_does_not_decode():
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    for arr, mode in ((rng.integers(0, 4, (8, 8), dtype=np.uint8), "P"),
                      (rng.integers(0, 65535, (8, 8), dtype=np.uint16), None)):
        with pytest.raises(ValueError, match="unsupported PNG"):
            decode_png(pil_png(arr, mode))
    buf = io.BytesIO()
    Image.fromarray(picture(rng, 8, 8, 3)).save(buf, "PNG")
    data = bytearray(buf.getvalue())
    data[30] ^= 0xFF  # inside IHDR's body
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4, 4), np.uint8))
