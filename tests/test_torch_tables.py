"""The port's expanded-table build against `mulut_tpu`'s.

`mulut_tpu_torch.ops.ensemble.prepare_expanded_luts` builds every format
of the JAX package's, here with the flags of the JAX evaluator's kernel
path (`KERNEL_FORMATS`: `shared_quad=True, corner16_modes="y",
fold16_modes="sd", k128_stage1="sd", int8_stage1="y"`), on the host with
NumPy (device=None) or with the torch twins on a device; the other flag
sets and the rank builders are held in tests/test_torch_rank_tables.py.
Tolerance: exact byte equality — every format is a gather/permutation of
the int8 source tables.
"""

import numpy as np
import pytest
import torch

from mulut_tpu.ops.ensemble import prepare_expanded_luts as jax_prepare
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import simplex_tables as tst

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


def _luts(interval, seed, dtype=np.int8):
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(seed)
    return {
        f"s{s}_{m}": rng.integers(-127, 128, (L ** 4, v)).astype(dtype)
        for s, v in ((1, 1), (2, 16)) for m in "sdy"
    }


@pytest.fixture(scope="module")
def interval4():
    luts = _luts(4, 0)
    return luts, jax_prepare(luts, interval=4, **KERNEL_FORMATS)


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("src_dtype", [np.int8, np.int32])
def test_tables_interval6(device, src_dtype):
    luts = _luts(6, 5, src_dtype)
    want = jax_prepare(luts, interval=6, **KERNEL_FORMATS)
    _assert_equal(tens.prepare_expanded_luts(luts, interval=6,
                                             device=device,
                                             **KERNEL_FORMATS), want)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_tables_interval4(interval4, device):
    """The shipped 17**4 shape (85.5 MB folded stage-2 tables)."""
    luts, want = interval4
    got = tens.prepare_expanded_luts(luts, interval=4, device=device,
                                     **KERNEL_FORMATS)
    _assert_equal(got, want)
    L4 = 17 ** 4
    shapes = {k: tuple(t.shape) for k, t in got.items()}
    assert shapes == {
        "s1_s": (L4, 128), "s1_d": (L4, 128), "s1_y": (L4, 16),
        "s2_s": (L4, 1024), "s2_d": (L4, 1024), "s2_y": (L4, 256),
    }


def test_tables_from_numpy(interval4):
    _, want = interval4
    got = tens.tables_from_numpy(want, "cpu")
    assert all(isinstance(t, torch.Tensor) for t in got.values())
    _assert_equal(got, want)


@pytest.mark.parametrize("interval,v", [(6, 1), (6, 16), (5, 4)])
def test_device_twins(interval, v):
    """expand_lut_device / fold_lut_device == the NumPy builders."""
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(v)
    lut = rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
    t = torch.as_tensor(lut)
    np.testing.assert_array_equal(tst.expand_lut_device(t, interval).numpy(),
                                  tst.expand_lut(lut, interval))
    from mulut_tpu_torch.ops.taps import fold_geometry, lane_rotation_perm

    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    for mode in "sde":
        geo = fold_geometry(mode)
        for p in (None, perms):
            np.testing.assert_array_equal(
                tst.fold_lut_device(t, geo, p, interval).numpy(),
                tst.fold_lut(lut, geo, p, interval))


@pytest.mark.parametrize("key,v", [("s2_e", 16), ("s1_h", 1), ("s1_e", 1),
                                   ("s2_o", 16)])
def test_unported_formats_raise(key, v):
    """The e/h/o formats of the kernel path, refused before the rank tables
    were ported, now byte-equal to JAX's: rank-folded (s2_e), shared rank
    (s2_o), (L**4, 64) folded (s1_e) and (L**4, 16) int32 (s1_h)."""
    lut = np.random.default_rng(v).integers(-127, 128, (5 ** 4, v)).astype(
        np.int8)
    want = jax_prepare({key: lut}, interval=6, **KERNEL_FORMATS)
    for device in (None, "cpu"):
        _assert_equal(tens.prepare_expanded_luts(
            {key: lut}, interval=6, device=device, **KERNEL_FORMATS), want)
