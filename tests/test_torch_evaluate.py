"""The port's `LutEvaluator` against `mulut_tpu`'s, on the same LUTs.

`mulut_tpu_torch.pipelines.evaluate.LutEvaluator(device="cpu")` runs the
packed cascade with the kernels' plain torch versions; the JAX evaluator
runs its own engine on the CPU.  Both are bit-exact LUT retrieval, so the
uint8 images must be equal: tolerance is exact equality (integer-valued
float32 accumulators below 2**24, integer stage mixes).  Uses the 17**4
small-LUT fixture of tests/test_bucketed_eval.py.
"""

import numpy as np
import pytest
import torch

from mulut_tpu.pipelines.evaluate import LutEvaluator as JaxEvaluator
from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

CFG = dict(stages=2, modes="sdy", scale=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_luts():
    rng = np.random.default_rng(3)
    luts = {}
    for s, v in ((1, 1), (2, 16)):
        for m in "sdy":
            luts[f"s{s}_{m}"] = rng.integers(-127, 128, (17 ** 4, v)).astype(
                np.int8
            )
    return luts


@pytest.fixture(scope="module")
def evaluators(small_luts):
    return (JaxEvaluator(small_luts, **CFG),
            JaxEvaluator(small_luts, **CFG, bucket=16),
            LutEvaluator(small_luts, **CFG, device="cpu"),
            LutEvaluator(small_luts, **CFG, bucket=16, device="cpu"))


@pytest.mark.parametrize("shape", [(13, 18, 3), (9, 25)])
def test_upscale_equals_jax(evaluators, shape):
    jax_exact, _, port_exact, port_bucketed = evaluators
    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    want = jax_exact.upscale(img)
    for ev in (port_exact, port_bucketed):
        got = ev.upscale(img)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_upscale_batch_equals_jax(evaluators):
    jax_exact, _, port_exact, _ = evaluators
    imgs = np.random.default_rng(7).integers(0, 256, (2, 11, 20, 3)).astype(
        np.uint8)
    want = jax_exact.upscale_batch(imgs)
    got = port_exact.upscale_batch(imgs)
    assert got.shape == (2, 44, 80, 3)
    np.testing.assert_array_equal(got, want)


def test_upscale_many_equals_jax(evaluators):
    """Mixed sizes, per-image valid extents, one dispatch per bucket."""
    _, jax_bucketed, _, port_bucketed = evaluators
    rng = np.random.default_rng(9)
    sizes = [(13, 18), (16, 32), (9, 25), (5, 7)]
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8) for hw in sizes]
    want = jax_bucketed.upscale_many(imgs)
    got = port_bucketed.upscale_many(imgs)
    for g, w_, hw in zip(got, want, sizes):
        np.testing.assert_array_equal(g, w_, err_msg=str(hw))


def test_upscale_many_chunks_by_pixel_cap(small_luts, evaluators):
    """A bucket group above max_batch_pixels splits into several
    dispatches with the same result."""
    _, _, _, port_bucketed = evaluators
    ev = LutEvaluator(small_luts, **CFG, bucket=16, device="cpu",
                      max_batch_pixels=2 * 3 * 16 * 16)
    rng = np.random.default_rng(31)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((13, 11), (16, 16), (9, 12))]
    for got, want in zip(ev.upscale_many(imgs), port_bucketed.upscale_many(
            imgs)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        ev.upscale(rng.integers(0, 256, (20, 20, 3)).astype(np.uint8))


def test_no_cpu_fallback(small_luts, monkeypatch):
    """Without a device argument the evaluator runs on the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LutEvaluator(small_luts, **CFG)


@pytest.mark.parametrize("kw,what", [
    (dict(band=8), "band"),
    (dict(n_devices=2), "n_devices"),
    (dict(scale=2), "scale"),
])
def test_later_slices_raise(small_luts, kw, what):
    """The options that raised until their slice of the port was done now
    give the JAX evaluator's bytes: scale=2 (`lut_cascade_int`), band > 0
    (the banded packed cascade) and n_devices > 1 (bucketed dispatches
    sharded over CPU shards; tests/test_torch_banded.py and
    test_torch_parallel.py hold both further)."""
    cfg = dict(CFG, **kw)
    if what in ("band", "n_devices"):
        rng = np.random.default_rng(6)     # interval 6: 5**4-row tables
        luts = {k: rng.integers(-127, 128, (5 ** 4, t.shape[1])).astype(
            np.int8) for k, t in small_luts.items()}
        imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                for hw in ((21, 9), (13, 18), (16, 18))]
        port = LutEvaluator(luts, **cfg, interval=6, bucket=16,
                            device="cpu")
        assert getattr(port, what) == kw[what]
        want = JaxEvaluator(luts, **CFG, interval=6,
                            bucket=16).upscale_many(imgs)
        for g, w_ in zip(port.upscale_many(imgs), want):
            np.testing.assert_array_equal(g, w_)
        return
    if what == "scale":
        rng = np.random.default_rng(4)
        luts = {k: (t if k.startswith("s1") else rng.integers(
            -127, 128, (17 ** 4, 4)).astype(np.int8))
            for k, t in small_luts.items()}
        port = LutEvaluator(luts, **cfg, device="cpu")
        assert not port.kernel
        img = rng.integers(0, 256, (11, 14, 3)).astype(np.uint8)
        np.testing.assert_array_equal(port.upscale(img),
                                      JaxEvaluator(luts, **cfg).upscale(img))


def test_yuv_raises(evaluators):
    """The device YUV pipeline, refused before this slice of the port, now
    gives the JAX evaluator's bytes (`upscale_yuv` and
    `upscale_yuv_batch`)."""
    jax_exact, _, port, _ = evaluators
    imgs = np.random.default_rng(21).integers(0, 256, (2, 10, 15, 3)).astype(
        np.uint8)
    want = jax_exact.upscale_yuv_batch(imgs)
    got = port.upscale_yuv_batch(imgs)
    assert got.dtype == np.uint8 and got.shape == (2, 40, 60, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.upscale_yuv(imgs[1]), want[1])
