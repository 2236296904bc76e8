"""The port's five CLIs and the conversion CLI on a local checkpoint directory.

Each of ``sample``, ``mix_lora``, ``serve``, ``train`` and ``train_dreambooth``, given
``--pretrained_model_name_or_path`` (a smoke stack written in the diffusers layout,
``tests/test_torch_zoo_load.py``) and ``CLIP_VOCAB_DIR`` (a small merges.txt +
vocab.json written here), renders or trains bit for bit as it does with the same
weights handed over in memory (``zoo.frozen_stack`` replaced by the seeded build
that wrote the directory), on the CPU at 64² with 2 steps. ``sample`` also takes the
SDXL-refiner layout through ``--refiner_model_path``. Without vocab assets,
``require_clip`` raises FileNotFoundError, as ``tests/test_tokenizer.py`` shows the
JAX package doing. The three ``convert_checkpoint`` commands print the lines
``scripts/convert_checkpoint.py`` prints on the same inputs (the JAX script reads
an orbax train state and the port its own, so ``export-controllora``'s line is held
to the JAX format string, and its artifact to the run's own).
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from controllora_tpu_torch import convert_checkpoint, mix_lora, sample, serve, train
from controllora_tpu_torch import train_dreambooth
from controllora_tpu_torch.config import ControlLoRAConfig
from controllora_tpu_torch.data.tokenizer import CLIPBPETokenizer, default_tokenizer
from controllora_tpu_torch.models import lora as tlora
from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import derive_cross_attention_dims
from controllora_tpu_torch.training.checkpoint import save_control_lora
from controllora_tpu_torch.utils import convert
from controllora_tpu_torch.utils.png import encode_png
from test_torch_zoo_load import component_dicts, write_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
MERGES = ["a </w>", "r e", "re d</w>", "s q", "sq u", "squ a", "squa re</w>", "t o",
          "to y</w>", "s k", "sk s</w>"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file, and autograd on, whatever an earlier file in this
    worker left (tests/test_parity_fixtures.py switches it off process-wide): the train
    CLIs run in process here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.enable_grad():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Checkpoint directories of the seeded smoke, smokexl and smokeref stacks, a
    CLIP vocab, a smoke ControlLoRA artifact and a smokexl plain LoRA."""
    base = tmp_path_factory.mktemp("weights")
    for variant in ("smoke", "smokexl", "smokeref"):
        write_dir(base / variant, component_dicts(variant, seeded(variant)))
    vocab = base / "vocab"
    vocab.mkdir()
    (vocab / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    tok = CLIPBPETokenizer.from_files(None, str(vocab / "merges.txt"))
    (vocab / "vocab.json").write_text(json.dumps(tok.encoder))
    cfg = ControlLoRAConfig(block_out_channels=(8, 16, 16, 32),
                            lora_block_in_channels=(32, 32, 32, 32),
                            lora_block_out_channels=zoo.SMOKE_UNET.block_out_channels,
                            lora_cross_attention_dims=derive_cross_attention_dims(zoo.SMOKE_UNET))
    control = zoo.build_control_lora(cfg, "cpu", torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in control.parameters():
            p.add_(0.01)
    save_control_lora(str(base / "control"), control)
    for name, ucfg in (("lora", zoo.SMOKE_UNET), ("loraxl", zoo.SMOKEXL_UNET)):
        lora = tlora.make_plain_lora_adapters(torch.Generator().manual_seed(2), 4, ucfg)
        convert.save_state_dict(convert.attn_procs_to_torch(lora),
                                str(base / f"{name}.safetensors"))
    return base


def seeded(variant, dtype=torch.float32):
    return zoo.build_models(variant, dtype, "cpu", torch.Generator().manual_seed(SEED))


@pytest.fixture
def vocab_env(root, monkeypatch):
    monkeypatch.setenv("CLIP_VOCAB_DIR", str(root / "vocab"))


def in_memory(monkeypatch):
    """zoo.frozen_stack hands over the seeded stack that wrote the directories (it
    draws nothing from the CLI's generator, as a load does not)."""
    monkeypatch.setattr(zoo, "frozen_stack",
                        lambda path, variant, dtype, device, gen: seeded(variant, dtype))


def files_of(out):
    return {name: (out / name).read_bytes() for name in sorted(os.listdir(out))
            if name.endswith(".png")}


def test_clip_vocab_tokenizes(root, vocab_env):
    tok = default_tokenizer(require_clip=True)
    assert isinstance(tok, CLIPBPETokenizer)
    ids = tok(["a red square"])[0]
    assert ids[0] == tok.bos and tok.encoder["red</w>"] in ids and ids.max() < 49408


def test_sample_renders_as_in_memory(root, vocab_env, tmp_path, monkeypatch, capsys):
    args = ["--model_variant", "smoke", "--control_lora_dir", str(root / "control"),
            "--resolution", "64", "--num_inference_steps", "2",
            "--num_validation_images", "1", "--device", "cpu"]
    sample.main(args + ["--pretrained_model_name_or_path", str(root / "smoke"),
                        "--output_dir", str(tmp_path / "a")])
    assert "random frozen" not in capsys.readouterr().out
    in_memory(monkeypatch)
    sample.main(args + ["--output_dir", str(tmp_path / "b")])
    a, b = files_of(tmp_path / "a"), files_of(tmp_path / "b")
    assert list(a) == ["0.png"] and a == b


def test_sample_refiner_model_path(root, vocab_env, tmp_path, monkeypatch, capsys):
    """The SDXL ensemble with both stacks from directories: the base's dual-tower
    layout and the refiner's text_encoder_2/ alone."""
    args = ["--model_variant", "smokexl", "--lora_weights", str(root / "loraxl.safetensors"),
            "--prompt", "a toy", "--resolution", "64", "--num_inference_steps", "3",
            "--num_validation_images", "1", "--refiner_variant", "smokeref",
            "--denoising_split", "0.6", "--device", "cpu"]
    sample.main(args + ["--pretrained_model_name_or_path", str(root / "smokexl"),
                        "--refiner_model_path", str(root / "smokeref"),
                        "--output_dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "random frozen" not in out and "two-stage render" in out
    in_memory(monkeypatch)
    sample.main(args + ["--output_dir", str(tmp_path / "b")])
    assert files_of(tmp_path / "a") == files_of(tmp_path / "b")


def test_mix_lora_renders_as_in_memory(root, vocab_env, tmp_path, monkeypatch):
    args = ["--model_variant", "smoke", "--control_lora_dir", str(root / "control"),
            "--lora_weights", str(root / "lora.safetensors"), "--prompt", "a red square",
            "--resolution", "64", "--num_inference_steps", "2", "--device", "cpu"]
    mix_lora.main(args + ["--pretrained_model_name_or_path", str(root / "smoke"),
                          "--output_dir", str(tmp_path / "a")])
    in_memory(monkeypatch)
    mix_lora.main(args + ["--output_dir", str(tmp_path / "b")])
    a, b = files_of(tmp_path / "a"), files_of(tmp_path / "b")
    assert list(a) == ["0.png"] and a == b


def test_serve_pipeline_renders_as_in_memory(root, vocab_env, monkeypatch):
    argv = ["--model_variant", "smoke", "--control_lora_dir", str(root / "control"),
            "--device", "cpu"]
    loaded = serve.build_pipeline(serve.parse_args(
        argv + ["--pretrained_model_name_or_path", str(root / "smoke")]))
    assert isinstance(loaded.tokenizer, CLIPBPETokenizer)
    in_memory(monkeypatch)
    memory = serve.build_pipeline(serve.parse_args(argv))
    guide = np.zeros((64, 64, 3), np.float32) - 1.0
    guide[16:48, 16:48] = 1.0
    a, b = (p("a red square", guide=guide, num_inference_steps=2,
              generator=torch.Generator().manual_seed(0))[0] for p in (loaded, memory))
    assert a.shape == (64, 64, 3) and np.array_equal(a, b)


def test_serve_refiner_directory_renders_as_in_memory(root, vocab_env, monkeypatch):
    """serve --model_variant smokeref loads the refiner's layout (text_encoder_2/
    alone) and renders unguided as the stack that wrote it."""
    argv = ["--model_variant", "smokeref", "--device", "cpu"]
    loaded = serve.build_pipeline(serve.parse_args(
        argv + ["--pretrained_model_name_or_path", str(root / "smokeref")]))
    assert loaded.control_lora is None and isinstance(loaded.tokenizer, CLIPBPETokenizer)
    in_memory(monkeypatch)
    memory = serve.build_pipeline(serve.parse_args(argv))
    a, b = (p("a red square", num_inference_steps=2, height=64, width=64,
              generator=torch.Generator().manual_seed(0))[0] for p in (loaded, memory))
    assert a.shape == (64, 64, 3) and np.array_equal(a, b)


def test_train_as_in_memory(root, vocab_env, tmp_path, monkeypatch):
    """Two steps at 64²: the same artifact bit for bit; the model card names the
    directory as base_model."""
    args = ["--model_variant", "smoke", "--resolution", "64", "--train_batch_size", "1",
            "--max_train_steps", "2", "--checkpointing_steps", "0", "--device", "cpu"]
    train.main(args + ["--pretrained_model_name_or_path", str(root / "smoke"),
                       "--output_dir", str(tmp_path / "a")])
    card = (tmp_path / "a" / "README.md").read_text()
    assert f"base_model: {root / 'smoke'}\n" in card
    in_memory(monkeypatch)
    train.main(args + ["--output_dir", str(tmp_path / "b")])
    assert "base_model: runwayml/stable-diffusion-v1-5" in (tmp_path / "b" / "README.md").read_text()
    a, b = (torch.load(tmp_path / d / "diffusion_pytorch_model.bin", weights_only=True)
            for d in ("a", "b"))
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_train_dreambooth_as_in_memory(root, vocab_env, tmp_path, monkeypatch):
    inst = tmp_path / "instance"
    inst.mkdir()
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    (inst / "0.png").write_bytes(encode_png(img))
    args = ["--model_variant", "smoke", "--resolution", "64", "--instance_data_dir",
            str(inst), "--instance_prompt", "a sks toy", "--max_train_steps", "2",
            "--checkpointing_steps", "0", "--lr_warmup_steps", "0", "--device", "cpu"]
    train_dreambooth.main(args + ["--pretrained_model_name_or_path", str(root / "smoke"),
                                  "--output_dir", str(tmp_path / "a")])
    in_memory(monkeypatch)
    train_dreambooth.main(args + ["--output_dir", str(tmp_path / "b")])
    a, b = ((tmp_path / d / "pytorch_lora_weights.safetensors").read_bytes() for d in "ab")
    assert a == b


@pytest.mark.parametrize("cli", ["sample", "mix_lora", "serve", "train", "train_dreambooth"])
def test_weights_without_vocab_raise(root, tmp_path, monkeypatch, cli):
    """Pretrained weights with no CLIP vocab: the hash tokenizer is refused."""
    monkeypatch.delenv("CLIP_VOCAB_DIR", raising=False)
    weights = ["--pretrained_model_name_or_path", str(root / "smoke"), "--model_variant",
               "smoke", "--device", "cpu"]
    control = ["--control_lora_dir", str(root / "control")]
    out = ["--output_dir", str(tmp_path / "out")]
    run = {
        "sample": lambda: sample.main(weights + control + out),
        "mix_lora": lambda: mix_lora.main(weights + control + out + [
            "--lora_weights", str(root / "lora.safetensors"), "--prompt", "p"]),
        "serve": lambda: serve.build_pipeline(serve.parse_args(weights + control)),
        "train": lambda: train.main(weights + out + ["--resolution", "64"]),
        "train_dreambooth": lambda: train_dreambooth.main(weights + out + [
            "--instance_data_dir", str(tmp_path), "--instance_prompt", "p"]),
    }[cli]
    with pytest.raises(FileNotFoundError, match="CLIP"):
        run()


def run_jax_script(argv, capsys):
    """scripts/convert_checkpoint.py's main with ``argv``; its stdout lines."""
    old = sys.argv
    sys.argv = ["convert_checkpoint.py", *argv]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", "convert_checkpoint.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("variant", ["smoke", "smokexl", "smokeref"])
def test_convert_import_sd_prints_as_jax(root, variant, capsys):
    convert_checkpoint.main(["import-sd", str(root / variant), "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    assert ours == run_jax_script(["import-sd", str(root / variant)], capsys)
    assert [ln.split(":")[0] for ln in ours] == ["unet", "vae", "text"]


def test_convert_controllora_round_trip(root, tmp_path, capsys):
    """import-controllora prints as the JAX script on the same artifact; a 2-step
    training run exports (export-controllora) to the run's own artifact, tensor for
    tensor, and the export imports again."""
    convert_checkpoint.main(["import-controllora", str(root / "control"), "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    assert ours == run_jax_script(["import-controllora", str(root / "control")], capsys)
    run, out = tmp_path / "run", tmp_path / "export"
    train.main(["--model_variant", "smoke", "--resolution", "64", "--train_batch_size", "1",
                "--max_train_steps", "2", "--checkpointing_steps", "2",
                "--no_async_checkpointing", "--output_dir", str(run), "--device", "cpu"])
    capsys.readouterr()
    cfg = run / "checkpoint-2" / "control_lora" / "config.json"
    convert_checkpoint.main(["export-controllora", "--run_dir", str(run), "--config",
                             str(cfg), "--out", str(out), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [f"exported step-2 adapter to {out}"]
    a, b = (torch.load(d / "diffusion_pytorch_model.bin", weights_only=True)
            for d in (run, out))
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    convert_checkpoint.main(["import-controllora", str(out), "--device", "cpu"])
    line = capsys.readouterr().out.splitlines()
    assert line == run_jax_script(["import-controllora", str(out)], capsys)
    with pytest.raises(SystemExit, match="no checkpoint"):
        convert_checkpoint.main(["export-controllora", "--run_dir", str(tmp_path / "none"),
                                 "--config", str(cfg), "--out", str(out), "--device", "cpu"])
