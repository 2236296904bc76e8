"""The port's training data plane and bookkeeping against the JAX package on the CPU:
the native fastloader (its own C library, loaded with ctypes) against the JAX
package's CPython extension and the Python batchers, the prefetch thread, the column
dataset over an in-memory ``datasets.Dataset``, the DDPM ancestral step, the metrics
logger's JSONL, and the train CLI's choice of data plane. Batches and items are held
equal bit for bit; the DDPM step to 1e-6 * max(1, max|ref|) (fp32 on both sides).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu.data import fastloader as jfast
from controllora_tpu.data.fill50k import Fill50kSynthetic as JFill50k
from controllora_tpu.data.hf_dataset import HFImageGuideDataset as JHFDataset
from controllora_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from controllora_tpu.schedulers import DDPMScheduler as JDDPM
from controllora_tpu.schedulers.common import DiffusionSchedule as JSchedule
from controllora_tpu.utils.logging import MetricsLogger as JMetricsLogger
from controllora_tpu_torch import train as cli
from controllora_tpu_torch.data import fastloader
from controllora_tpu_torch.data.fill50k import Fill50kSynthetic
from controllora_tpu_torch.data.hf_dataset import HFImageGuideDataset
from controllora_tpu_torch.data.registry import batch_iterator
from controllora_tpu_torch.data.tokenizer import HashTokenizer
from controllora_tpu_torch.schedulers import DDPMScheduler
from controllora_tpu_torch.schedulers.common import DiffusionSchedule
from controllora_tpu_torch.utils.logging import MetricsLogger
from controllora_tpu_torch.utils.png import decode_png

datasets = pytest.importorskip("datasets")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this file: the suite runs several workers on the host's
    cores, and this file's many small CPU ops, spread over every core, contend with
    the other workers' and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_batches_equal(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------- fastloader


def test_native_library_builds_and_loads():
    assert fastloader.native_available(), fastloader.native_error()
    assert fastloader.native_error() is None
    assert fastloader.LIBRARY.exists()


@pytest.mark.parametrize("start_step", [0, 3])
def test_native_fill50k_equals_jax_native(start_step):
    """The port's C fill50k batches equal the JAX package's native batches bit for bit
    (pixels, guides, ids), resumed streams too."""
    if not jfast.native_available():
        pytest.skip("the JAX package's CPython extension does not build here")
    ours = iter(fastloader.NativeFill50kBatcher(
        Fill50kSynthetic(HashTokenizer(), resolution=96, size=40), 3, seed=4, nthreads=3,
        start_step=start_step))
    ref = iter(jfast.NativeFill50kBatcher(
        JFill50k(JHashTokenizer(), resolution=96, size=40), 3, seed=4, nthreads=3,
        start_step=start_step))
    for i in range(3):
        assert_batches_equal(next(ours), next(ref), f"batch {i}")


def test_native_routines_equal_jax_and_python():
    """normalize_u8: the C conversion equals the JAX extension's and numpy's float32
    u8 / 127.5 - 1 exactly; fill50k_batch equals the JAX extension's on one spec
    table, with threads splitting the batch."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (5, 17, 19, 3)).astype(np.uint8)
    out = fastloader.normalize_u8_native(u8, nthreads=3)
    np.testing.assert_array_equal(out, u8.astype(np.float32) / 127.5 - 1.0)
    specs = np.concatenate([rng.uniform(10, 50, (6, 3)), rng.uniform(0, 255, (6, 6))],
                           axis=1).astype(np.float32)
    px, gd = fastloader.fill50k_batch_native(specs, 64, nthreads=4)
    if jfast.native_available():
        np.testing.assert_array_equal(out, jfast.normalize_u8_native(u8, nthreads=2))
        rpx, rgd = jfast.fill50k_batch_native(specs, 64, nthreads=1)
        np.testing.assert_array_equal(px, rpx)
        np.testing.assert_array_equal(gd, rgd)


def test_prefetcher_keeps_order_and_raises():
    items = list(fastloader.Prefetcher(iter(range(50)), depth=3))
    assert items == list(range(50))

    def broken():
        yield 1
        raise RuntimeError("producer failed")

    pf = fastloader.Prefetcher(broken(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)


# ---------------------------------------------------------------------------- column data


def make_hf_ds(n=5, multi_caption=False):
    from PIL import Image

    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (80, 100, 3)).astype(np.uint8))
            for _ in range(n)]
    guides = [Image.fromarray(255 - np.asarray(im)).convert("L") for im in imgs]
    caps = [["a cat", "a dog", "a fox"] if multi_caption else f"caption {i}"
            for i in range(n)]
    return datasets.Dataset.from_dict({"img": imgs, "hint": guides, "text": caps})


@pytest.mark.parametrize("multi_caption", [False, True])
def test_hf_dataset_items_equal_jax(multi_caption):
    """Items (resize, synchronised crop, grayscale guide to RGB, random caption) equal
    the JAX adapter's bit for bit, uint8 and float; the columns resolve the same."""
    hf = make_hf_ds(multi_caption=multi_caption)
    kw = dict(dataset=hf, resolution=64, seed=3, max_train_samples=4)
    ours = HFImageGuideDataset(HashTokenizer(), **kw)
    ref = JHFDataset(JHashTokenizer(), **kw)
    assert len(ours) == len(ref) == 4
    assert (ours.image_column, ours.guide_column, ours.caption_column) == ("img", "hint", "text")
    for i in range(4):
        assert_batches_equal(ours.getitem_u8(i), ref.getitem_u8(i), f"u8 {i}")
        assert_batches_equal(ours[i], ref[i], f"item {i}")
    with pytest.raises(ValueError, match="column"):
        HFImageGuideDataset(HashTokenizer(), dataset=hf, caption_column="nope")


def test_native_normalize_batches_equal_jax_and_python():
    """The C batch-normalize stream equals the port's Python batch_iterator and the
    JAX package's native stream bit for bit, with the start_step fast-forward; the
    train CLI picks it for a column dataset and fill50k's C batcher for fill50k."""
    ds = HFImageGuideDataset(HashTokenizer(), dataset=make_hf_ds(), resolution=64, seed=1)
    nat = iter(fastloader.NativeNormalizeBatcher(ds, 2, seed=5))
    py = batch_iterator(ds, 2, seed=5)
    jnat = None
    if jfast.native_available():
        jds = JHFDataset(JHashTokenizer(), dataset=make_hf_ds(), resolution=64, seed=1)
        jnat = iter(jfast.NativeNormalizeBatcher(jds, 2, seed=5))
    for i in range(4):
        got = next(nat)
        assert_batches_equal(got, next(py), f"python {i}")
        if jnat is not None:
            assert_batches_equal(got, next(jnat), f"jax native {i}")
    resumed = next(iter(fastloader.NativeNormalizeBatcher(ds, 2, seed=5, start_step=3)))
    py = batch_iterator(ds, 2, seed=5)
    for _ in range(3):
        next(py)
    assert_batches_equal(resumed, next(py), "resumed")

    args = cli.parse_args(["--dataset_name", "local_dir", "--train_batch_size", "2"])
    batches, plane = cli.make_batches(args, ds, 5, 0)
    assert plane.startswith("native batch-normalize")
    assert_batches_equal(next(batches), next(batch_iterator(ds, 2, seed=5)), "CLI plane")
    args = cli.parse_args(["--train_batch_size", "2"])
    fill = Fill50kSynthetic(HashTokenizer(), resolution=32)
    _, plane = cli.make_batches(args, fill, 5, 0)
    assert plane.startswith("native fastloader")
    args = cli.parse_args(["--train_batch_size", "2", "--cache_latents"])
    _, plane = cli.make_batches(args, fill, 5, 0)
    assert plane == "python batch_iterator (latent cache)"


# ---------------------------------------------------------------------------- DDPM step


@pytest.mark.parametrize("prediction_type,clip", [("epsilon", False), ("v_prediction", True)])
def test_ddpm_step_equals_jax(prediction_type, clip):
    """The ancestral step x_t -> x_{t-1} with the JAX step's own posterior noise (its
    key's normal draw), at t 999, 500, 1 and 0 (no noise)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    js = JDDPM(JSchedule.create(prediction_type=prediction_type), clip_sample=clip)
    ts = DDPMScheduler(DiffusionSchedule.create(prediction_type=prediction_type),
                       clip_sample=clip)
    for t in (999, 500, 1, 0):
        key = jax.random.PRNGKey(t)
        ref = np.asarray(js.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), key))
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, x.shape)))
        out = ts.step(torch.from_numpy(eps), t, torch.from_numpy(x), noise=noise).numpy()
        err = float(np.abs(out - ref).max())
        assert err <= 1e-6 * max(1.0, float(np.abs(ref).max())), (t, err)
    drawn = ts.step(torch.from_numpy(eps), 500, torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(0))
    again = ts.step(torch.from_numpy(eps), 500, torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again) and bool(torch.isfinite(drawn).all())


# ---------------------------------------------------------------------------- logger


def test_metrics_logger_schema_equals_jax(tmp_path):
    """The JSONL lines have the JAX logger's keys, order and types; images are PNGs
    that decode to what was logged; a sink whose package is missing raises."""
    lines = {}
    for name, cls in (("ours", MetricsLogger), ("jax", JMetricsLogger)):
        logger = cls(str(tmp_path / name), "jsonl")
        logger.log(3, {"train_loss": np.float32(0.25), "grad_norm": 1, "steps_per_sec": 2.5})
        logger.log(4, {"train_loss": 0.5})
        logger.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines[name] = [json.loads(ln) for ln in f]
    for a, b in zip(lines["ours"], lines["jax"], strict=True):
        assert list(a) == list(b)
        assert {k: type(v) for k, v in a.items()} == {k: type(v) for k, v in b.items()}
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    img = np.random.default_rng(0).integers(0, 256, (6, 9, 3), dtype=np.uint8)
    logger = MetricsLogger(str(tmp_path / "img"))
    logger.log_image(7, "validation", img)
    logger.close()
    with open(tmp_path / "img" / "images" / "validation-7.png", "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img)
    with pytest.raises(ImportError, match="comet_ml"):
        MetricsLogger(str(tmp_path / "x"), "comet_ml")
    with pytest.raises(ValueError, match="report_to"):
        MetricsLogger(str(tmp_path / "x"), "stdout")
