"""The port's `LutEvaluator` at x2, x3 and x4 "sdyeho" against JAX's.

At x2 and x3 (and below interval 4) the port runs `lut_cascade_int` over
the JAX package's default table formats; at x4 "sdyeho" it runs the packed
cascade over the kernel path's formats, with rank tables for e/h/o.  The
JAX evaluator on the CPU runs its own `lut_cascade_int`.  `upscale`,
`upscale_batch`, `upscale_many` with a bucket and the device YUV pipeline,
on seeded random int8 LUTs at interval 6 (625 rows); and `upscale` at x2
"s", interval 3, as in tests/test_interval3.py (L = 33: 16-corner
formats).  Tolerance: exact equality of the uint8
images.
"""

import numpy as np
import pytest
import torch

from mulut_tpu.pipelines.evaluate import LutEvaluator as JaxEvaluator
from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

# (stages, modes, scale, interval, the port's packed path)
CONFIGS = {
    "x2-sdy": (2, "sdy", 2, 6, False),
    "x3-sdy": (2, "sdy", 3, 6, False),
    "x2-eho": (2, "eho", 2, 6, False),
    "x4-sdyeho": (2, "sdyeho", 4, 6, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def evaluators(request):
    stages, modes, scale, interval, packed = CONFIGS[request.param]
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(scale * 7 + len(modes))
    luts = {f"s{s + 1}_{m}": rng.integers(
        -127, 128, (L ** 4, scale ** 2 if s + 1 == stages else 1)).astype(
            np.int8) for s in range(stages) for m in modes}
    cfg = dict(stages=stages, modes=modes, scale=scale, interval=interval)
    port = LutEvaluator(luts, **cfg, device="cpu")
    bucketed = LutEvaluator(luts, **cfg, bucket=16, device="cpu")
    assert port.kernel == packed
    return (JaxEvaluator(luts, **cfg), JaxEvaluator(luts, **cfg, bucket=16),
            port, bucketed)


def test_upscale_equals_jax(evaluators):
    jax_ev, _, port, bucketed = evaluators
    img = np.random.default_rng(1).integers(0, 256, (11, 14, 3)).astype(
        np.uint8)
    want = jax_ev.upscale(img)
    for ev in (port, bucketed):
        got = ev.upscale(img)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_upscale_batch_equals_jax(evaluators):
    jax_ev, _, port, _ = evaluators
    imgs = np.random.default_rng(2).integers(0, 256, (2, 9, 13, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(port.upscale_batch(imgs),
                                  jax_ev.upscale_batch(imgs))


def test_upscale_many_equals_jax(evaluators):
    _, jax_bucketed, _, bucketed = evaluators
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((13, 18), (9, 7), (16, 16))]
    for got, want in zip(bucketed.upscale_many(imgs),
                         jax_bucketed.upscale_many(imgs)):
        np.testing.assert_array_equal(got, want)


def test_upscale_yuv_equals_jax(evaluators):
    jax_ev, _, port, _ = evaluators
    imgs = np.random.default_rng(4).integers(0, 256, (2, 10, 12, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(port.upscale_yuv_batch(imgs),
                                  jax_ev.upscale_yuv_batch(imgs))


def test_interval3_upscale_equals_jax():
    rng = np.random.default_rng(33)
    luts = {"s1_s": rng.integers(-127, 128, (33 ** 4, 4)).astype(np.int8)}
    cfg = dict(stages=1, modes="s", scale=2, interval=3)
    img = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    port = LutEvaluator(luts, **cfg, device="cpu")
    assert not port.kernel
    np.testing.assert_array_equal(port.upscale(img),
                                  JaxEvaluator(luts, **cfg).upscale(img))
