"""The port's row-banded LUT cascade against the JAX package's.

`mulut_tpu_torch.ops.ensemble.lut_cascade_banded` and the packed banded
form `ops.tail_kernel.lut_cascade_packed_banded` (the kernels' plain
versions on the CPU) against `mulut_tpu.ops.ensemble.lut_cascade_banded`
and against the untiled cascade, at x2 and x4, with `band` dividing H and
not, without `valid_hw` and with scalar and per-image extents; and
`LutEvaluator(band=...)` against the JAX evaluator (the port twins of
tests/test_bucketed_eval.py's banded tests).  LUT retrieval is exact on
both sides, so the tolerance is byte equality.  Tables: random int8 LUTs
at interval 6 (5**4 rows, as JAX's dry run takes them); images of 12-40
rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.ops import ensemble as jens
from mulut_tpu.pipelines.evaluate import LutEvaluator as JaxEvaluator
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import tail_kernel as ttk
from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

MODES, STAGES, INTERVAL = "sdy", 2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _luts(scale: int) -> dict:
    rng = np.random.default_rng(3)
    return {f"s{s}_{m}": rng.integers(-127, 128, (5 ** 4, v)).astype(np.int8)
            for s, v in ((1, 1), (2, scale * scale)) for m in MODES}


@functools.cache
def _tables(scale: int, kernel: bool):
    """(JAX default-format tables, port tables on the CPU): the defaults,
    or with `kernel` the packed path's formats on the port side."""
    jtabs = jens.prepare_expanded_luts(_luts(scale), interval=INTERVAL)
    flags = tens.KERNEL_FORMATS if kernel else {}
    return jtabs, tens.prepare_expanded_luts(
        _luts(scale), interval=INTERVAL, device="cpu", **flags)


@functools.cache
def _jax_banded(scale: int, band: int, valid: str):
    cfg = dict(stages=STAGES, modes=MODES, scale=scale, interval=INTERVAL,
               expanded=True, band=band)
    if valid == "none":
        return jax.jit(lambda t, x: jens.lut_cascade_banded(t, x, **cfg))
    return jax.jit(lambda t, x, h, w: jens.lut_cascade_banded(
        t, x, valid_hw=(h, w), **cfg))


def _case(valid: str, shape, rng):
    """Image and valid extents: none, scalars, or per-image vectors."""
    img = rng.integers(0, 256, shape).astype(np.int32)
    if valid == "none":
        return img, None
    H, W = shape[-2:]
    if valid == "scalar":
        return img, (np.int32(H - 5), np.int32(W - 2))
    return img, (np.asarray([H - 7, H], np.int32),
                 np.asarray([W, W - 3], np.int32))


CASES = [  # (scale, band, (B, H, W), valid)
    (4, 8, (2, 32, 10), "none"),        # band divides H
    (4, 8, (2, 33, 7), "scalar"),       # last band overlaps
    (4, 8, (2, 37, 9), "vector"),
    (2, 8, (2, 32, 10), "none"),
    (2, 16, (2, 40, 9), "scalar"),      # one slab short of the image
    (2, 8, (2, 29, 11), "vector"),
]


@pytest.mark.parametrize("scale,band,shape,valid", CASES)
def test_banded_equals_jax_and_untiled(scale, band, shape, valid):
    rng = np.random.default_rng(sum(shape) + band)
    img, vhw = _case(valid, shape, rng)
    jtabs, ttabs = _tables(scale, False)
    args = () if vhw is None else tuple(jnp.asarray(a) for a in vhw)
    want = np.asarray(_jax_banded(scale, band, valid)(
        jtabs, jnp.asarray(img), *args))
    cfg = dict(stages=STAGES, modes=MODES, scale=scale, interval=INTERVAL)
    got = tens.lut_cascade_banded(ttabs, torch.as_tensor(img), expanded=True,
                                  band=band, valid_hw=vhw, **cfg)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    untiled = tens.lut_cascade_int(ttabs, torch.as_tensor(img), expanded=True,
                                   valid_hw=vhw, **cfg)
    np.testing.assert_array_equal(got.numpy(), untiled.numpy())


@pytest.mark.parametrize("scale,band,shape,valid",
                         [c for c in CASES if c[0] == 4])
def test_packed_banded_equals_jax(scale, band, shape, valid):
    """The packed banded form (K1 and K2 per slab) over the kernel path's
    tables gives JAX's `lut_cascade_banded` bytes."""
    rng = np.random.default_rng(sum(shape) + band)
    img, vhw = _case(valid, shape, rng)
    jtabs, _ = _tables(scale, False)
    _, ktabs = _tables(scale, True)
    args = () if vhw is None else tuple(jnp.asarray(a) for a in vhw)
    want = np.asarray(_jax_banded(scale, band, valid)(
        jtabs, jnp.asarray(img), *args))
    cfg = dict(stages=STAGES, modes=MODES, scale=scale, interval=INTERVAL)
    got = ttk.lut_cascade_packed_banded(ktabs, torch.as_tensor(img),
                                        band=band, valid_hw=vhw, **cfg)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_short_image_runs_untiled():
    """An image no taller than one slab (band + 2 * halo rows) runs the
    untiled cascade, with `valid_hw` as given."""
    _, ttabs = _tables(4, False)
    img = torch.as_tensor(np.random.default_rng(8).integers(
        0, 256, (3, 16, 9)), dtype=torch.int32)
    cfg = dict(stages=STAGES, modes=MODES, scale=4, interval=INTERVAL,
               expanded=True)
    for vhw in (None, (12, 7)):
        np.testing.assert_array_equal(
            tens.lut_cascade_banded(ttabs, img, band=8, valid_hw=vhw,
                                    **cfg).numpy(),
            tens.lut_cascade_int(ttabs, img, valid_hw=vhw, **cfg).numpy())


def test_slab_bounds():
    """Clamped slabs cover every row once, the last band overlapping."""
    slab_h, bounds = tens.slab_bounds(30, 8, 4)
    assert slab_h == 16
    assert bounds == [(0, 0), (8, 4), (16, 12), (22, 14)]
    assert tens.cascade_halo(2, "sdy") == 4


@pytest.fixture(scope="module")
def evaluators():
    luts = _luts(4)
    cfg = dict(stages=STAGES, modes=MODES, scale=4, interval=INTERVAL)
    return dict(
        jax=JaxEvaluator(luts, **cfg),
        jax_both=JaxEvaluator(luts, **cfg, bucket=16, band=8),
        exact=LutEvaluator(luts, **cfg, device="cpu"),
        banded=LutEvaluator(luts, **cfg, band=8, device="cpu"),
        both=LutEvaluator(luts, **cfg, bucket=16, band=8, device="cpu"))


def test_banded_evaluator_bit_exact(evaluators):
    """`LutEvaluator(band=8)` (the packed banded path): `upscale` and
    `upscale_batch` give the untiled evaluator's bytes, equal to JAX's."""
    rng = np.random.default_rng(17)
    ev = evaluators["banded"]
    assert ev.kernel and ev.band == 8
    for hw in ((30, 12), (16, 9), (33, 7)):
        img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        want = evaluators["jax"].upscale(img)
        np.testing.assert_array_equal(ev.upscale(img), want, err_msg=str(hw))
    imgs = rng.integers(0, 256, (2, 26, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ev.upscale_batch(imgs),
                                  evaluators["exact"].upscale_batch(imgs))


def test_band_composes_with_bucket(evaluators):
    """band + bucket: each slab re-syncs the pad region with its local
    extents; a mixed batch with one image over several bands gives JAX's
    banded-and-bucketed bytes and the exact evaluator's."""
    rng = np.random.default_rng(23)
    sizes = [(13, 18), (37, 9), (16, 32)]
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8) for hw in sizes]
    got = evaluators["both"].upscale_many(imgs)
    want = evaluators["jax_both"].upscale_many(imgs)
    for img, g, w, hw in zip(imgs, got, want, sizes):
        np.testing.assert_array_equal(g, w, err_msg=str(hw))
        np.testing.assert_array_equal(g, evaluators["exact"].upscale(img),
                                      err_msg=str(hw))
    np.testing.assert_array_equal(evaluators["both"].upscale(imgs[1]),
                                  want[1])


def test_oversized_image_raises_without_band():
    """Above the untiled pixel cap the evaluator raises unless a band is
    set; with one the same image streams, exact.  The YUV pipeline stays
    untiled and keeps its cap, as in the JAX package."""
    luts = _luts(4)
    cfg = dict(stages=STAGES, modes=MODES, scale=4, interval=INTERVAL,
               bucket=16, max_batch_pixels=3 * 16 * 16, device="cpu")
    rng = np.random.default_rng(29)
    small = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    big = rng.integers(0, 256, (20, 20, 3)).astype(np.uint8)
    ev = LutEvaluator(luts, **cfg)
    with pytest.raises(ValueError, match="band"):
        ev.upscale_many([small, big])
    with pytest.raises(ValueError, match="band"):
        ev.upscale(big)
    banded = LutEvaluator(luts, band=8, **cfg)
    exact = LutEvaluator(luts, stages=STAGES, modes=MODES, scale=4,
                         interval=INTERVAL, device="cpu")
    np.testing.assert_array_equal(banded.upscale(big), exact.upscale(big))
    with pytest.raises(ValueError, match="YUV batch"):
        banded.upscale_yuv_batch(np.zeros((1, 30, 30, 3), np.uint8))


def test_banded_int_path_from_folder(tmp_path):
    """At x2 (the integer cascade's path) `from_folder` passes `band`
    through, and the banded evaluator gives JAX's bytes."""
    from mulut_tpu_torch.utils.lut_io import parse_stage_key, save_lut

    for key, arr in _luts(2).items():
        stage, mode = parse_stage_key(key)
        save_lut(str(tmp_path), arr, name="LUT_ft", scale=2,
                 interval=INTERVAL, stage=stage, mode=mode)
    ev = LutEvaluator.from_folder(str(tmp_path), scale=2, interval=INTERVAL,
                                  band=8, device="cpu")
    assert not ev.kernel and ev.band == 8
    img = np.random.default_rng(31).integers(0, 256, (27, 10, 3)).astype(
        np.uint8)
    want = JaxEvaluator(_luts(2), stages=STAGES, modes=MODES, scale=2,
                        interval=INTERVAL).upscale(img)
    np.testing.assert_array_equal(ev.upscale(img), want)
