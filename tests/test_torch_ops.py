"""The port's simplex weights, stage mix, padding and ensemble glue against
their JAX twins.

Inputs come from numpy with a seed and go through both functions.
Tolerance: exact equality throughout — the weights are integers held in
float32 (<= 2**interval), the accumulators integer-valued float32 below
2**24, and the mixing is integer arithmetic.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mulut_tpu.ops import ensemble as jens
from mulut_tpu.ops import simplex as jsx
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import simplex as tsx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_fracs(interval):
    q = 2 ** interval
    grid = np.array(list(itertools.product(range(q), repeat=4)), np.int32)
    return [grid[:, i] for i in range(4)]


@pytest.mark.parametrize("interval", [2, 4])
def test_corner_lams_exhaustive(interval):
    """Every fraction quadruple, ties included."""
    fr = _all_fracs(interval)
    tf = [torch.as_tensor(f) for f in fr]
    jf = [jnp.asarray(f) for f in fr]
    np.testing.assert_array_equal(
        tsx.corner_lams_t(*tf, interval=interval).numpy(),
        np.asarray(jsx.corner_lams_t(*jf, interval=interval)))
    np.testing.assert_array_equal(
        tsx.corner_lams(*tf, interval=interval).numpy(),
        np.asarray(jsx.corner_lams(*jf, interval=interval)))
    for got, want in zip(tsx._fraction_ranks(*tf), jsx._fraction_ranks(*jf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tsx._sorted_fractions(*tf),
                         jsx._sorted_fractions(*jf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interval", [4, 6])
def test_base_and_fracs(interval):
    rng = np.random.default_rng(interval)
    planes = [rng.integers(0, 256, (2, 7, 9)).astype(np.int32)
              for _ in range(4)]
    tb, tfr = tsx._base_and_fracs([torch.as_tensor(p) for p in planes],
                                  interval=interval)
    jb, jfr = jsx._base_and_fracs([jnp.asarray(p) for p in planes],
                                  interval=interval)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for a, b in zip(tfr, jfr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_interleave():
    x = np.arange(2 * 3 * 5 * 16).reshape(2, 3, 5, 16)
    np.testing.assert_array_equal(
        tsx._interleave(torch.as_tensor(x), 4).numpy(),
        np.asarray(jsx._interleave(jnp.asarray(x), 4)))


@pytest.mark.parametrize("avg,bias", [(12, 127), (3, 0), (1, 0)])
def test_stage_mix(avg, bias):
    q = 16
    d = q * avg
    # every accumulator value around the clip range, halves included
    acc = np.arange(-bias * d - 3 * d, (255 - bias) * d + 3 * d,
                    dtype=np.int32)
    np.testing.assert_array_equal(
        tens.stage_mix(torch.as_tensor(acc), q=q, avg_factor=avg,
                       bias=bias).numpy(),
        np.asarray(jens.stage_mix(jnp.asarray(acc), q=q, avg_factor=avg,
                                  bias=bias)))


@pytest.mark.parametrize("pad", [1, 2, 3])
def test_pad_all(pad):
    rng = np.random.default_rng(pad)
    x = rng.integers(0, 256, (2, 5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tens._pad_all(torch.as_tensor(x), pad).numpy(),
        np.asarray(jens._pad_all(jnp.asarray(x), pad)))


def test_clamp_pad_region_scalar_and_vector():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (3, 2, 9, 11)).astype(np.int32)
    for hw in ((np.int32(5), np.int32(7)),
               (np.array([9, 4, 1], np.int32), np.array([3, 11, 6], np.int32))):
        np.testing.assert_array_equal(
            tens.clamp_pad_region(torch.as_tensor(x), hw).numpy(),
            np.asarray(jens.clamp_pad_region(jnp.asarray(x), hw)))


@pytest.mark.parametrize("mode", ["y", "h", "o"])
def test_quad_ensemble_inner_stage(mode):
    """The v == 1 rotation ensemble of a non-symmetric mode over the int8
    (L**4, 16) stage-1 table."""
    interval = 6
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(ord(mode))
    lut = rng.integers(-127, 128, (L ** 4, 1)).astype(np.int8)
    table = jens.prepare_expanded_luts(
        {f"s1_{mode}": lut}, interval=interval, shared_quad=True,
        int8_stage1=mode)[f"s1_{mode}"]
    img = rng.integers(0, 256, (2, 9, 13)).astype(np.int32)
    got = tens.rotation_ensemble_lanes_quad_int(
        torch.as_tensor(table), torch.as_tensor(img), mode=mode, upscale=1,
        interval=interval)
    want = jens.rotation_ensemble_lanes_quad_int(
        jnp.asarray(table), jnp.asarray(img), mode=mode, upscale=1,
        interval=interval)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
