"""The port's rank-expanded tables and full table build against
`mulut_tpu`'s.

`simplex_tables.rank_fold_lut`, `rank_expand_rotations` and
`rank_expand_shared` (NumPy, on the host) and their torch twins
(`*_device`, here on the CPU), at intervals 6 and 5, v in {1, 4, 9, 16}
and modes s/d/e (folded) and y/h/o (per rotation and shared); then
`ensemble.prepare_expanded_luts` for every flag set the JAX package's tests
build (tests/test_device_tables.py, test_tail_kernel.py), the defaults
included, on the host and with the torch twins.  Tolerance: exact byte
equality (dtype and shape too): every format is a gather or permutation of
the int8 source tables.
"""

import numpy as np
import pytest
import torch

from mulut_tpu.ops import simplex_tables as jst
from mulut_tpu.ops.ensemble import prepare_expanded_luts as jax_prepare
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import simplex_tables as tst
from mulut_tpu_torch.ops.taps import fold_geometry, lane_rotation_perm

#: the flag sets of JAX's tests/test_device_tables.py CONFIGS
CONFIGS = {
    "xla-rank": dict(),
    "xla-16corner": dict(rank=False),
    "kernel-stock": dict(shared_quad=True),
    "kernel-winner": dict(shared_quad=True, corner16_modes="y",
                          fold16_modes="sd", k128_stage1="sd",
                          int8_stage1="y"),
    "kernel-c16-only": dict(shared_quad=True, corner16_modes="y",
                            fold16_modes="sd"),
    "k128-all": dict(shared_quad=True, k128_stage1="sdyeho"),
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


def _lut(interval, v, seed):
    L = 2 ** (8 - interval) + 1
    return np.random.default_rng(seed).integers(
        -127, 128, (L ** 4, v)).astype(np.int8)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _equal(got, want, what=""):
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.shape, w.shape)
    assert np.array_equal(g, w), what


#: (interval, v): every v at interval 6 (625 rows), the small ones at 5
SIZES = [(6, 1), (6, 4), (6, 9), (6, 16), (5, 1), (5, 4)]


@pytest.mark.parametrize("interval,v", SIZES)
def test_rank_fold_lut_equal(interval, v):
    """Host builder and torch twin at every folded mode, with and without
    the lane un-rotations; the 128-byte row padding of 4v = 16 and 64."""
    lut = _lut(interval, v, interval * 100 + v)
    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    for mode in "sde":
        geo = fold_geometry(mode)
        for p in (None, perms):
            want = jst.rank_fold_lut(lut, geo, p, interval)
            _equal(tst.rank_fold_lut(lut, geo, p, interval), want, mode)
            _equal(tst.rank_fold_lut_device(torch.as_tensor(lut), geo, p,
                                            interval), want, mode)
    padded = {1: 128, 4: 128, 9: 180, 16: 384}[v]
    assert want.shape[1] == padded


@pytest.mark.parametrize("interval,v", SIZES)
def test_rank_expand_equal(interval, v):
    """Per-rotation (with and without lane un-rotations) and shared rank
    tables of the non-symmetric modes."""
    lut = _lut(interval, v, interval * 10 + v)
    t = torch.as_tensor(lut)
    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    for p in (None, perms):
        want = jst.rank_expand_rotations(lut, p, interval)
        _equal(tst.rank_expand_rotations(lut, p, interval), want)
        _equal(tst.rank_expand_rotations_device(t, p, interval), want)
    want = jst.rank_expand_shared(lut, interval)
    _equal(tst.rank_expand_shared(lut, interval), want)
    _equal(tst.rank_expand_shared_device(t, interval), want)


def test_expand_indices_equal():
    for interval in (4, 6):
        _equal(tst.expand_indices(interval), jst.expand_indices(interval))
        lut = _lut(interval, 4, 3)
        _equal(lut[tst.expand_indices(interval)].reshape(lut.shape[0], -1),
               tst.expand_lut(lut, interval).reshape(lut.shape[0], -1))


def test_kernel_formats_are_the_evaluator_flags():
    """The flags `LutEvaluator` passes for its packed cascade are those of
    the JAX evaluator's kernel path (mulut_tpu/pipelines/evaluate.py)."""
    assert tens.KERNEL_FORMATS == CONFIGS["kernel-winner"]


@pytest.mark.parametrize("label", list(CONFIGS))
@pytest.mark.parametrize("device", [None, "cpu"])
def test_prepare_expanded_luts_equal(label, device):
    """Every format of every mode at both stages (x4), host and torch
    twins, interval 6."""
    rng = np.random.default_rng(len(label))
    luts = {f"s{s}_{m}": rng.integers(-127, 128, (625, v)).astype(np.int8)
            for s, v in ((1, 1), (2, 16)) for m in "sdyeho"}
    want = jax_prepare(luts, interval=6, **CONFIGS[label])
    got = tens.prepare_expanded_luts(luts, interval=6, device=device,
                                     **CONFIGS[label])
    assert got.keys() == want.keys()
    for k in want:
        _equal(got[k], want[k], f"{label} {k}")


@pytest.mark.parametrize("scale,interval", [(2, 6), (3, 6), (2, 5)])
def test_prepare_expanded_luts_scales(scale, interval):
    """JAX's default formats at x2 and x3 (rank tables; interval 3's
    16-corner formats are held in tests/test_torch_lut_cascade_int.py)."""
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(scale + interval)
    modes = "sdyeho"
    luts = {f"s{s}_{m}": rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
            for s, v in ((1, 1), (2, scale * scale)) for m in modes}
    want = jax_prepare(luts, interval=interval)
    for device in (None, "cpu"):
        got = tens.prepare_expanded_luts(luts, interval=interval,
                                         device=device)
        for k in want:
            _equal(got[k], want[k], k)
