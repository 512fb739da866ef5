"""The frame pool is fixed by the seed."""

import numpy as np

from bench_gpu import harness, traffic


def _traffic():
    return harness.cell_spec("lut_dev_540p_b8")["traffic"]


def test_pool_fixed_by_seed():
    t = {**_traffic(), "height": 27, "width": 48}
    a = traffic.frame_pool(2**31 + 99, t)
    b = traffic.frame_pool(2**31 + 99, t)
    c = traffic.frame_pool(2**31 + 100, t)
    assert a.shape == (16, 27, 48, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_batches_in_turn():
    t = {**_traffic(), "height": 9, "width": 16}
    pool = traffic.frame_pool(3, t)
    bs = traffic.batches(pool, t["frames_per_batch"])
    assert len(bs) == 2
    assert all(b.flags.c_contiguous for b in bs)
    assert np.array_equal(np.concatenate(bs), pool)


def test_frames_have_content():
    f = traffic.synth_frame(np.random.default_rng(0), 540, 960)
    assert f.shape == (540, 960, 3)
    assert f.std() > 20 and len(np.unique(f)) > 100
