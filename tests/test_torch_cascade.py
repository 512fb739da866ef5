"""The port's packed LUT cascade against `mulut_tpu`'s, byte for byte.

`mulut_tpu_torch.ops.tail_kernel.lut_cascade_packed` (CPU tensors: the
kernels' plain torch versions) against `mulut_tpu.ops.tail_kernel.
lut_cascade_packed(..., interpret=True)` on the same seeded inputs, with the
JAX evaluator's kernel-path table formats, compared as packed 32-bit words
(junk columns included).  Tolerance: exact equality — every accumulator is
integer-valued float32 below 2**24 and the stage mixes are integer
arithmetic.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mulut_tpu.ops import tail_kernel as jtk
from mulut_tpu.ops.ensemble import prepare_expanded_luts as jax_prepare
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import tail_kernel as ttk

SCALE, MODES, STAGES = 4, "sdy", 2
KERNEL_FORMATS = dict(shared_quad=True, corner16_modes="y",
                      fold16_modes="sd", k128_stage1="sd", int8_stage1="y")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _luts(interval, seed):
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(seed)
    return {
        f"s{s}_{m}": rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
        for s, v in ((1, 1), (2, 16)) for m in MODES
    }


@functools.lru_cache(maxsize=None)
def _jax_cascade(interval, bucketed):
    def run(tabs, img, hw):
        return jtk.lut_cascade_packed(
            tabs, img, stages=STAGES, modes=MODES, scale=SCALE,
            interval=interval, valid_hw=hw if bucketed else None,
            interpret=True)
    return jax.jit(run)


def _compare(luts_np, jtabs, img, interval, valid_hw=None, ttabs=None):
    if ttabs is None:
        ttabs = tens.prepare_expanded_luts(luts_np, interval=interval,
                                           device="cpu", **KERNEL_FORMATS)
    want = np.asarray(_jax_cascade(interval, valid_hw is not None)(
        jtabs, jnp.asarray(img, jnp.int32),
        None if valid_hw is None else tuple(jnp.asarray(a)
                                            for a in valid_hw)))
    got = ttk.lut_cascade_packed(
        ttabs, torch.as_tensor(img), stages=STAGES, modes=MODES,
        scale=SCALE, interval=interval, valid_hw=valid_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    return got


@pytest.fixture(scope="module")
def interval6():
    luts = _luts(6, 7)
    return luts, jax_prepare(luts, interval=6, **KERNEL_FORMATS)


@pytest.mark.parametrize(
    "lead,h,w",
    [
        ((1,), 20, 40),     # tiny
        ((2,), 13, 57),     # odd h, small odd w (woman.png is 57x86)
        ((1,), 9, 130),     # h with no divisor in 2..8, w > 128
        ((2, 3), 16, 48),   # 4-D batch x channel lead (upscale_many shape)
    ],
)
def test_packed_cascade_equals_jax(interval6, lead, h, w):
    luts, jtabs = interval6
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, lead + (h, w)).astype(np.uint8)
    packed = _compare(luts, jtabs, img, 6)
    out = ttk.unpack_u32(packed, lead, h, w, SCALE)
    assert out.shape == lead + (h * SCALE, w * SCALE)


def test_packed_cascade_interval4():
    """The shipped 17**4 tables on one small RGB image."""
    luts = _luts(4, 1)
    jtabs = jax_prepare(luts, interval=4, **KERNEL_FORMATS)
    img = np.random.default_rng(2).integers(0, 256, (3, 11, 17)).astype(
        np.uint8)
    _compare(luts, jtabs, img, 4)


def test_packed_cascade_valid_hw(interval6):
    """Bucketed semantics with per-image (B,) extents: each image's pad
    region is re-synced from its valid extent before every stage."""
    luts, jtabs = interval6
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (2, 1, 13, 48)).astype(np.uint8)
    hw = (np.array([11, 7], np.int32), np.array([37, 20], np.int32))
    _compare(luts, jtabs, img, 6, valid_hw=hw)


@pytest.mark.parametrize("mode", ["y", "s"])
def test_stage1_k128(interval6, mode):
    """The k128 inner-stage forms, with JAX-built k128 tables for every
    mode (`stage1_quad_k128` for y, `stage1_fold_k128` for s) carried over
    with `tables_from_numpy`."""
    luts, _ = interval6
    key = f"s1_{mode}"
    jtab = jax_prepare({key: luts[key]}, interval=6, shared_quad=True,
                       k128_stage1=mode)[key]
    ttab = tens.tables_from_numpy({key: jtab}, "cpu")[key]
    img = np.random.default_rng(5).integers(0, 256, (2, 12, 44)).astype(
        np.int32)
    fn = "stage1_fold_k128" if mode == "s" else "stage1_quad_k128"
    want = getattr(jtk, fn)(jnp.asarray(jtab), jnp.asarray(img), mode=mode,
                            interval=6)
    got = getattr(ttk, fn)(ttab, torch.as_tensor(img), mode=mode,
                           interval=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_stage1_format_raises(interval6):
    """The (L**4, 64) folded stage-1 s/d tables and the all-rank final
    stage (`shared_quad=True` alone), refused before the rank formats were
    ported, now give JAX's bytes."""
    luts, _ = interval6
    jtabs = jax_prepare(luts, interval=6, shared_quad=True,
                        corner16_modes="y", fold16_modes="sd")
    ttabs = tens.tables_from_numpy(jtabs, "cpu")   # (L**4, 64) stage-1 s/d
    img = np.random.default_rng(17).integers(0, 256, (2, 9, 30)).astype(
        np.uint8)
    _compare(luts, jtabs, img, 6, ttabs=ttabs)
