"""The port's `LutEvaluator` at intervals other than 4 against JAX's.

JAX's `supports_tail_kernel` refuses `interval != 4`, so there (and on the
CPU at any interval) JAX's `LutEvaluator` runs the pure-XLA cascade
`lut_cascade_int` over its own table formats; the port runs its packed
cascade (`lut_cascade_packed`, here the kernels' plain versions) at every
interval.  Both are exact LUT retrieval, so the uint8 images must be equal
byte for byte, on seeded random int8 LUTs of L**4 = 6,561 (interval 5) and
625 (interval 6) rows.
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


@pytest.fixture(scope="module", params=[5, 6])
def evaluators(request):
    interval = request.param
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(interval)
    luts = {f"s{s}_{m}": rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
            for s, v in ((1, 1), (2, 16)) for m in "sdy"}
    jax_ev = JaxEvaluator(luts, **CFG, interval=interval)
    assert not jax_ev.kernel                 # JAX runs lut_cascade_int
    return jax_ev, LutEvaluator(luts, **CFG, interval=interval, device="cpu")


@pytest.mark.parametrize("shape", [(13, 18, 3), (9, 25)])
def test_upscale_equals_jax(evaluators, shape):
    jax_ev, port_ev = evaluators
    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(
        np.uint8)
    want = jax_ev.upscale(img)
    got = port_ev.upscale(img)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_upscale_batch_equals_jax(evaluators):
    jax_ev, port_ev = evaluators
    imgs = np.random.default_rng(11).integers(0, 256, (2, 11, 20, 3)).astype(
        np.uint8)
    want = jax_ev.upscale_batch(imgs)
    got = port_ev.upscale_batch(imgs)
    assert got.shape == (2, 44, 80, 3)
    np.testing.assert_array_equal(got, want)
