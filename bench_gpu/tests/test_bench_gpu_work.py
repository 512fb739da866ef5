"""The work arithmetic (`work/`) against figures worked by hand."""

import pytest

from bench_gpu import harness, work
from bench_gpu.work import net_dense


def _work(cell, **traffic):
    s = harness.cell_spec(cell)
    t = {**s["traffic"], **traffic}
    return s["config"], t, work.cell_work(s["config"], t)


def test_dense64_flops_per_site():
    # per unit: head 4 x 64, dense layers reading 64, 128, 192 and 256
    # inputs, a v-lane output over the 320-wide concat; x2 for
    # multiply-adds; 3 modes x 4 rotations; stage 1 v=1, stage 2 v=16
    hidden = 64 * 64 + 128 * 64 + 192 * 64 + 256 * 64
    assert hidden == 40_960
    assert net_dense.dense_unit_flops(64, 4, 1) == 2 * (256 + hidden + 320)
    assert net_dense.dense_unit_flops(64, 4, 16) == 2 * (256 + hidden
                                                         + 5_120)
    per_site = 12 * (83_072 + 92_672)
    assert per_site == 2_108_928
    # MuLUT-SDY-X2's 265,587 parameters (both stages, three modes)
    assert 3 * (net_dense.dense_unit_params(64, 4, 1)
                + net_dense.dense_unit_params(64, 4, 16)) == 265_587


def test_dense64_batch():
    cfg, traffic, w = _work("dense64_dev_540p_b8")
    sites = 8 * 3 * 540 * 960
    assert sites == 12_441_600
    assert w["flops"] == sites * 2_108_928
    assert w["flops"] == pytest.approx(26.24e12, rel=1e-3)
    # 8 frames of 270 x 480 give a quarter: 6.633 ms, the bound of
    # chip_smoke.py's K4 row
    _, _, w270 = _work("dense64_dev_540p_b8", height=270, width=480)
    assert w270["k4_bound_s"] == pytest.approx(6.633e-3, rel=1e-3)
    assert w["step_bound_s"] == pytest.approx(26.53e-3, rel=1e-3)
    assert w["k4_bound_s"] == pytest.approx(w["step_bound_s"], rel=1e-6)


def test_lut_bytes():
    # a batch of 8 x 270 x 480, the size of the figures the bounds were
    # checked on
    cfg, traffic, w = _work("lut_dev_540p_b8", height=270, width=480)
    n = 3_110_400
    L4 = 17 ** 4
    assert work.frame_io_bytes(cfg, traffic) == n + 16 * n   # 3.1 + 49.8 MB
    tables = 3 * L4 + 3 * 16 * L4                           # ~4.26 MB
    assert w["step_bytes"] == 17 * n + tables
    assert w["step_bytes"] == pytest.approx(57.1e6, rel=1e-2)
    assert w["k1_bytes"] == 3 * (n + L4 + 2 * n) + 3 * (n + 16 * L4
                                                        + 32 * n)
    assert w["k2_bytes"] == n * 3 * 16 * 2 + 16 * n
    assert w["ops"] == 3 * n * 4 * 5 * 2 * (1 + 16)
    assert w["step_bound_s"] == pytest.approx(
        w["step_bytes"] / work.PEAK_HBM_BYTES)
    # the intermediates the program writes (~2.6 GB) are no part of it
    assert w["step_bound_s"] < 2e-5


def test_out_pixels():
    cfg, traffic, _ = _work("lut_dev_540p_b8")
    assert work.out_pixels(cfg, traffic) == 8 * 2160 * 3840


def test_unknown_kind_is_refused():
    with pytest.raises(ModuleNotFoundError):
        work.cell_work({"kind": "no_such_kind"}, {})
