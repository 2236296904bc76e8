"""The port's pose2image app against the JAX package's ``apps/gradio_pose2image.py``.

Both apps' ``build_processor`` load one smoke checkpoint directory (diffusers layout)
with a small CLIP vocab, one ControlLoRA artifact and one OpenPose body file (the
seeded CMU-named state dict of ``tests/test_torch_openpose.py``, as a ``.pth``), on
the CPU. For the same 64² input at detect_resolution 64, ``process()``'s first output,
the skeleton map (OpenPose on the resized input, the integer-index NEAREST resize,
whose BGR flip feeds the hint encoder), is equal to the JAX ``process()``'s, and its
samples, with the JAX draws of the initial latents, are within one uint8 level of the
JAX samples (the bound of ``tests/test_torch_apps.py``). The port's web UI answers
``POST /api`` and ``POST /generate`` with the ``process()`` outputs as PNGs, and the
one-shot CLI writes them.
"""

import base64
import json
import os
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from controllora_tpu_torch.annotators.openpose import BodyposeModel
from controllora_tpu_torch.apps import pose2image
from controllora_tpu_torch.apps.webui import build_server
from controllora_tpu_torch.utils.png import decode_png, encode_png
from test_torch_apps import jax_draws, post
from test_torch_cli_weights import MERGES
from test_torch_openpose import numpy_state_dict
from test_torch_zoo_load import component_dicts, write_dir

FIELDS = dict(pose2image.DEFAULTS, num_samples=1, image_resolution=64, detect_resolution=64,
              ddim_steps=2, scale=5.0, seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(JAX process, port process) on one checkpoint directory, artifact and
    OpenPose body file."""
    from apps.gradio_pose2image import build_processor as jax_build_processor
    from controllora_tpu_torch.config import ControlLoRAConfig
    from controllora_tpu_torch.data.tokenizer import CLIPBPETokenizer
    from controllora_tpu_torch.models import zoo
    from controllora_tpu_torch.models.unet import derive_cross_attention_dims
    from controllora_tpu_torch.training.checkpoint import save_control_lora

    base = tmp_path_factory.mktemp("pose_app")
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
    torch.save({k: torch.from_numpy(v) for k, v in numpy_state_dict(BodyposeModel).items()},
               base / "body_pose_model.pth")
    args = SimpleNamespace(pretrained_model_name_or_path=str(base / "sd"),
                           model_variant="smoke", control_lora_dir=str(base / "control"),
                           openpose_weights=str(base / "body_pose_model.pth"), device="cpu")
    old = os.environ.get("CLIP_VOCAB_DIR")
    os.environ["CLIP_VOCAB_DIR"] = str(base / "vocab")
    try:
        yield jax_build_processor(args), pose2image.build_processor(args)
    finally:
        if old is None:
            os.environ.pop("CLIP_VOCAB_DIR")
        else:
            os.environ["CLIP_VOCAB_DIR"] = old


def make_input():
    return np.random.default_rng(5).integers(0, 256, (64, 64, 3), dtype=np.uint8)


def test_flags_match_jax_app():
    import apps.gradio_pose2image as japp

    assert pose2image.DEFAULTS == japp.DEFAULTS
    args = pose2image.parse_args(["--control_lora_dir", "c"])
    assert (args.device, args.model_variant, args.output_dir, args.port) == (
        "cuda", "sd15", "samples/pose2image", 7860)
    assert (args.ddim_steps, args.scale, args.seed, args.detect_resolution) == (30, 9.0, 42, 512)


def test_process_matches_jax(apps, monkeypatch):
    jax_process, process = apps
    jax_draws(monkeypatch, FIELDS["seed"])
    img = make_input()
    ours = process(img, "a dancer", **FIELDS)
    ref = jax_process(img, "a dancer", **FIELDS)
    assert len(ours) == len(ref) == 2
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    assert ours[0].shape == (64, 64, 3) and ours[0].any()  # a skeleton was drawn
    sample, want = ours[1], np.asarray(ref[1])
    assert sample.shape == want.shape == (64, 64, 3) and sample.dtype == np.uint8
    assert np.abs(sample.astype(np.int16) - want).max() <= 1


def test_web_ui_round_trip(apps):
    _, process = apps
    server = build_server("pose2image test", process, pose2image.DEFAULTS,
                          host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
        assert "pose2image test" in page and 'name="detect_resolution"' in page
        img = make_input()
        fields = {k: v for k, v in FIELDS.items() if k not in ("a_prompt", "n_prompt")}
        body = dict(fields, image=base64.b64encode(encode_png(img)).decode("ascii"),
                    prompt="a dancer")
        out = json.loads(post(f"{url}/api", json.dumps(body).encode(), "application/json"))
        want = process(img, "a dancer", **dict(pose2image.DEFAULTS, **fields))
        assert len(out["images"]) == 2
        for b64, ref in zip(out["images"], want):
            np.testing.assert_array_equal(decode_png(base64.b64decode(b64)), ref)
        boundary = "pose-boundary-3"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                 .encode() for k, v in dict(fields, prompt="a dancer").items()]
        parts.append((f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
                      'filename="in.png"\r\nContent-Type: image/png\r\n\r\n').encode()
                     + encode_png(img) + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        html = post(f"{url}/generate", b"".join(parts),
                    f"multipart/form-data; boundary={boundary}").decode()
        assert "<h3>Results</h3>" in html and html.count("data:image/png;base64,") == 2
    finally:
        server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_one_shot_cli(apps, tmp_path, monkeypatch, capsys):
    """``--input x.png --prompt``: the skeleton map and one sample as PNGs."""
    _, process = apps
    monkeypatch.setattr(pose2image, "build_processor", lambda args: process)
    (tmp_path / "in.png").write_bytes(encode_png(make_input()))
    pose2image.main(["--control_lora_dir", "unused", "--input", str(tmp_path / "in.png"),
                     "--prompt", "a dancer", "--image_resolution", "64",
                     "--detect_resolution", "64", "--ddim_steps", "2",
                     "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png"]
    skeleton = decode_png((tmp_path / "out" / "0.png").read_bytes())
    assert skeleton.shape == (64, 64, 3) and skeleton.any()
    assert "wrote" in capsys.readouterr().out
