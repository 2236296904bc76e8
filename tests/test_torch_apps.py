"""The port's canny2image app and its stdlib web UI against the JAX package's.

Both apps' ``build_processor`` load one smoke checkpoint directory (diffusers layout,
``tests/test_torch_zoo_load.py``) with a small CLIP vocab and one ControlLoRA
artifact, on the CPU. For the same 64² input, ``process()``'s first output (the
inverted Canny map of the resized input, whose BGR flip feeds the hint encoder) is
equal to the JAX ``process()``'s, and its samples, with the JAX draws of the initial
latents, are within one uint8 level of the JAX samples (the [-1, 1] bound of
``tests/test_torch_pipeline.py``, 2e-3, is 0.26 of a level before rounding). One
HTTP round trip through the port's web UI (``POST /api`` with a base64 PNG, and
``POST /generate`` multipart) answers with PNGs that decode, by PIL as by the port's
codec, to the ``process()`` outputs.
"""

import base64
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controllora_tpu_torch.apps import canny2image
from controllora_tpu_torch.apps.webui import build_server
from controllora_tpu_torch.pipelines import text_to_image
from controllora_tpu_torch.utils.png import decode_png, encode_png
from test_torch_cli_weights import MERGES
from test_torch_zoo_load import component_dicts, write_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELDS = dict(canny2image.DEFAULTS, num_samples=1, image_resolution=64, ddim_steps=2,
              scale=5.0, seed=3, low_threshold=100, high_threshold=200)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(JAX process, port process) on one checkpoint directory and artifact."""
    from apps.gradio_canny2image import build_processor as jax_build_processor
    from controllora_tpu_torch.config import ControlLoRAConfig
    from controllora_tpu_torch.data.tokenizer import CLIPBPETokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.models.unet import derive_cross_attention_dims
    from controllora_tpu_torch.training.checkpoint import save_control_lora

    base = tmp_path_factory.mktemp("app")
    write_dir(base / "sd", component_dicts("smoke", zoo.build_models(
        "smoke", torch.float32, "cpu", torch.Generator().manual_seed(4))))
    (base / "vocab").mkdir()
    (base / "vocab" / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    tok = CLIPBPETokenizer.from_files(None, str(base / "vocab" / "merges.txt"))
    (base / "vocab" / "vocab.json").write_text(json.dumps(tok.encoder))
    cfg = ControlLoRAConfig(block_out_channels=(8, 16, 16, 32),
                            lora_block_in_channels=(32, 32, 32, 32),
                            lora_block_out_channels=zoo.SMOKE_UNET.block_out_channels,
                            lora_cross_attention_dims=derive_cross_attention_dims(zoo.SMOKE_UNET))
    control = zoo.build_control_lora(cfg, "cpu", torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in control.parameters():
            p.add_(0.01)
    save_control_lora(str(base / "control"), control)
    args = SimpleNamespace(pretrained_model_name_or_path=str(base / "sd"),
                           model_variant="smoke", control_lora_dir=str(base / "control"),
                           device="cpu")
    old = os.environ.get("CLIP_VOCAB_DIR")
    os.environ["CLIP_VOCAB_DIR"] = str(base / "vocab")
    try:
        yield jax_build_processor(args), canny2image.build_processor(args)
    finally:
        if old is None:
            os.environ.pop("CLIP_VOCAB_DIR")
        else:
            os.environ["CLIP_VOCAB_DIR"] = old


def make_input():
    img = np.zeros((64, 64, 3), np.uint8)
    img[16:48, 16:48] = (255, 120, 30)  # a square: strong canny edges
    img[24:40, 30:34] = (10, 200, 90)
    return img


def jax_draws(monkeypatch, seed):
    """The port's draw_noise returns the draw the JAX pipeline makes from
    PRNGKey(seed): normal(split(key)[1], shape)."""
    def draw(generator, shape):
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    monkeypatch.setattr(text_to_image, "draw_noise", draw)


def test_process_matches_jax(apps, monkeypatch):
    jax_process, process = apps
    jax_draws(monkeypatch, FIELDS["seed"])
    img = make_input()
    ours = process(img, "a red square", **FIELDS)
    ref = jax_process(img, "a red square", **FIELDS)
    assert len(ours) == len(ref) == 2
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    assert (255 - ours[0] > 0).sum() > 50  # the square's outline fired
    sample, want = ours[1], np.asarray(ref[1])
    assert sample.shape == want.shape == (64, 64, 3) and sample.dtype == np.uint8
    assert np.abs(sample.astype(np.int16) - want).max() <= 1


def post(url, data, ctype):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=600).read()


def test_web_ui_round_trip(apps):
    _, process = apps
    server = build_server("canny2image test", process, canny2image.DEFAULTS,
                          host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
        assert "canny2image test" in page and 'name="low_threshold"' in page
        img = make_input()
        fields = {k: v for k, v in FIELDS.items() if k not in ("a_prompt", "n_prompt")}
        body = dict(fields, image=base64.b64encode(encode_png(img)).decode("ascii"),
                    prompt="a red square")
        out = json.loads(post(f"{url}/api", json.dumps(body).encode(), "application/json"))
        want = process(img, "a red square", **dict(canny2image.DEFAULTS, **fields))
        assert len(out["images"]) == 2
        for b64, ref in zip(out["images"], want):
            png = base64.b64decode(b64)
            np.testing.assert_array_equal(decode_png(png), ref)
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), ref)
        boundary = "port-boundary-7"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                 .encode() for k, v in dict(fields, prompt="a red square").items()]
        parts.append((f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
                      'filename="in.png"\r\nContent-Type: image/png\r\n\r\n').encode()
                     + encode_png(img) + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        html = post(f"{url}/generate", b"".join(parts),
                    f"multipart/form-data; boundary={boundary}").decode()
        assert "<h3>Results</h3>" in html and html.count("data:image/png;base64,") == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            post(f"{url}/api", json.dumps(dict(body, image="bm90IGEgcG5n")).encode(),
                 "application/json")
        assert err.value.code == 500
    finally:
        server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_one_shot_cli(apps, tmp_path, monkeypatch, capsys):
    """``--input x.png --prompt``: the inverted edge map and one sample as PNGs."""
    _, process = apps
    monkeypatch.setattr(canny2image, "build_processor", lambda args: process)
    (tmp_path / "in.png").write_bytes(encode_png(make_input()))
    canny2image.main(["--control_lora_dir", "unused", "--input", str(tmp_path / "in.png"),
                      "--prompt", "a red square", "--image_resolution", "64",
                      "--ddim_steps", "2", "--output_dir", str(tmp_path / "out"),
                      "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png"]
    assert decode_png((tmp_path / "out" / "1.png").read_bytes()).shape == (64, 64, 3)
    assert "wrote" in capsys.readouterr().out
