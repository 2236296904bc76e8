"""CPU tests of the benchmark harness: the files BENCHMARK.json names, finding new
cells, configurations, mixes and metrics by name, the work arithmetic, the window
statistics, what the harness and the reference import, and the refusal without a card.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import spec, work
from benchmark.drivers import serve_closed
from benchmark.reference import models as ref
from benchmark.stack import layouts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
DATA = os.path.join(BENCH, "tests", "data")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in load_bench()["workloads"]])
def test_every_named_file_loads(workload):
    cell = spec.load_cell(workload, root=ROOT)
    assert spec.driver(cell.traffic["kind"]).Session
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_benchmark_json_keeps_the_contract():
    bench = load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            reported = e2e[m["moves"]].get("workloads")
            assert reported is None or w in reported


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric that only exist as new
    files (and BENCHMARK.json entries) are found without any code edited."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(DATA, "configs", "smoke.json"), bench / "configs" / "new.json")
    mix = json.load(open(os.path.join(DATA, "traffic", "tiny-serve.json")))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(dict(mix, clients=3)))
    (bench / "metrics" / "new_metric.serve.py").write_text(
        "def read(run):\n    return 42.0\n")
    doc = load_bench()
    doc["configs"].append({"name": "new", "source": "test", "file": "bench/configs/new.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "new-cell", "config": "new", "traffic": "new-mix",
                             "chips": 1, "why": "test"})
    doc["per_layer"].append({"name": "new_metric.serve", "unit": "%", "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "serve_img_per_s", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load_cell("new-cell", root=str(tmp_path), bench_dir=str(bench))
    assert cell.traffic["clients"] == 3 and cell.config["variant"] == "smoke"
    assert "new_metric.serve" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("new_metric.serve", str(bench)).read(None) == 42.0
    assert spec.driver(cell.traffic["kind"], str(bench)).KIND == "serve"


def _smoke():
    with open(os.path.join(DATA, "configs", "smoke.json")) as f:
        return json.load(f)


def test_flop_count_by_hand():
    """FlopCounterMode over the reference's modules on the meta device against a hand
    count: one convolution, one linear layer, one attention."""
    cfg = _smoke()
    unet = ref.UNet(cfg["unet"]).to("meta")
    x = torch.empty((2, 4, 8, 8), device="meta")
    conv = work.count_flops(lambda: unet.conv_in(x))
    assert conv == 2 * 2 * 8 * 8 * 32 * 4 * 9  # 2 * B * H * W * Cout * Cin * k^2
    h = torch.empty((2, 64, 32), device="meta")
    lin = work.count_flops(lambda: unet.time_embedding.linear_1(h))
    assert lin == 2 * 2 * 64 * 32 * 128
    q = torch.empty((2, 64, 32), device="meta")
    att = work.count_flops(lambda: ref.attention(q, q, q, 4))
    assert att == 2 * (2 * 2 * 4 * 64 * 64 * 8)  # QK^T and PV


def test_train_step_flops_take_no_frozen_weight_gradients():
    """The smoke train step's count is its forward plus the backward that the
    ControlLoRA's gradients need (autograd asked for those alone): no weight gradient
    of the frozen UNet, VAE or text encoder. Asked for the UNet's weights' gradients
    too, the same step counts more."""
    cfg, batch, res = _smoke(), 2, 64
    lat = res // 8
    mods = layouts(cfg)  # every parameter requires a gradient here
    ids = torch.zeros((batch, 77), dtype=torch.long, device="meta")

    def step(wrt):
        with torch.no_grad():
            px = torch.empty((batch, 3, res, res), device="meta")
            latents = mods["vae"].encode(px, torch.empty((batch, 4, lat, lat), device="meta"))
            ctx, _ = ref.encode_text(mods["text"], ids, ids)
        adapters = mods["control"].adapters(mods["control"].controls(px), cfg["unet"])
        pred = mods["unet"](latents, torch.zeros((batch,), device="meta"), ctx, adapters, 1.0)
        torch.autograd.grad(pred.float().pow(2).mean(), wrt, allow_unused=True)

    control = list(mods["control"].parameters())
    want = work.count_flops(lambda: step(control))
    assert work.train_step_flops(cfg, batch, res) == want
    assert work.count_flops(lambda: step(control + list(mods["unet"].parameters()))) > want


def test_roofline_of_a_known_shape():
    """PERF.md's kernel table: K1/K2 at (8, 8, 4096, 40) is bound at 0.1737 ms."""
    site = work.Site("fwd", 8, 8, 4096, 40, 1)
    assert site.least_s * 1e3 == pytest.approx(0.1737, abs=5e-5)
    assert site.least_s == site.flops / work.PEAK_BF16_FLOPS
    bwd = work.Site("bwd", 8, 8, 4096, 40, 1)
    assert bwd.flops == 2.5 * site.flops


def test_flash_sites_follow_the_architecture():
    with open(os.path.join(BENCH, "configs", "sd15.json")) as f:
        sd15 = json.load(f)
    with open(os.path.join(BENCH, "configs", "sdxl.json")) as f:
        sdxl = json.load(f)
    assert work.unet_sites(sd15["unet"], 16, 64, "fwd", 20) == [
        work.Site("fwd", 16, 8, 4096, 40, 100)]
    assert work.unet_sites(sdxl["unet"], 4, 128, "fwd", 1) == [
        work.Site("fwd", 4, 10, 4096, 64, 10)]
    assert work.vae_sites(sdxl["vae"], 2, 128) == [work.Site("fwd", 2, 1, 16384, 512, 1)]


def _records(done_times, per_batch=8, submit_lag=2.0):
    recs = []
    for b, t in enumerate(done_times):
        for i in range(per_batch):
            recs.append(dict(batch=b, done=t + 1e-4 * i, submit=t - submit_lag, ok=True,
                             k=b * per_batch + i))
    return recs


def test_window_rate_and_p90():
    steady = serve_closed.window_of(_records([2.0, 4.0, 6.0, 8.0, 10.0, 12.0]), 2.0 + 9.0)
    assert steady["seconds"] == pytest.approx(8.0, abs=1e-3)  # opens at 2, closes at 10
    assert steady["images"] == 32 and steady["batches"] == 4
    e2e = serve_closed.end_to_end(steady)
    assert e2e["serve_img_per_s"] == pytest.approx(4.0, rel=1e-3)
    assert e2e["serve_latency_p90_s"] == pytest.approx(2.0, abs=1e-3)
    stalled = serve_closed.window_of(_records([2.0, 4.0, 9.0, 11.0, 13.0]), 2.0 + 9.0)
    assert serve_closed.end_to_end(stalled)["serve_img_per_s"] < e2e["serve_img_per_s"]
    lat = [0.1 * i for i in range(1, 101)]
    w = dict(steady, latencies=lat)
    assert serve_closed.end_to_end(w)["serve_latency_p90_s"] == pytest.approx(9.01, abs=1e-6)


def _python(code: str, cwd: str = ROOT):
    """A fresh interpreter, isolated from the environment's site hooks, with the
    repository on its path."""
    prog = f"import sys; sys.path.insert(0, {ROOT!r})\n" + textwrap.dedent(code)
    return subprocess.run([sys.executable, "-I", "-c", prog], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_imports_hold_no_jax_and_the_reference_none_of_the_program():
    out = _python("""
        import benchmark.run, benchmark.spec, benchmark.work, benchmark.readers
        import benchmark.trace, benchmark.weights, benchmark.control
        import benchmark.reference.models, benchmark.reference.schedule
        import benchmark.reference.text, benchmark.reference.fill50k
        import benchmark.reference.numerics
        from benchmark import spec
        cell = spec.load_cell("sd15-serve-c8")
        spec.driver(cell.traffic["kind"])
        for m in cell.per_layer:
            spec.metric_reader(m["name"])
        tops = {m.split(".")[0] for m in sys.modules}
        print(sorted(tops & {"jax", "jaxlib", "flax", "controllora_tpu",
                             "controllora_tpu_torch"}))
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    reference_only = _python("""
        import benchmark.reference.models, benchmark.reference.schedule
        import benchmark.reference.text, benchmark.reference.fill50k
        import benchmark.reference.numerics
        print(sorted(m for m in sys.modules if m.split(".")[0] == "controllora_tpu_torch"))
    """)
    assert reference_only.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compare_whole_top_level_names():
    from benchmark import run

    assert "controllora_tpu_torch" not in run.FORBIDDEN
    before = set(sys.modules)
    sys.modules["controllora_tpu_torch_fake"] = object()
    try:
        assert "controllora_tpu_torch_fake" not in run.forbidden_modules()
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a host without one")
    out = _python("""
        from benchmark import run
        sys.exit(run.main(["--workload", "sd15-serve-c8", "--seed", "3000000001",
                           "--seconds", "10", "--trace", "0"]))
    """)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
