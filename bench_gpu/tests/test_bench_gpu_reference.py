"""The plain reference against the port's CPU path at a tiny size, for
both configurations.  The reference imports nothing of the port; only
this test holds the two side by side."""

import numpy as np
import pytest
import torch

from bench_gpu import harness, traffic, weights
from bench_gpu.reference import common, lut, net

ROOT = harness.ROOT
LUT_CELL, NET_CELL = "lut_dev_540p_b8", "dense64_dev_540p_b8"


def _frames(seed, n=2, h=12, w=20):
    t = {**harness.cell_spec(LUT_CELL)["traffic"], "height": h, "width": w,
         "pool": n, "frames_per_batch": n}
    return traffic.frame_pool(seed, t)


@pytest.fixture(scope="module")
def lut_cfg():
    return harness.cell_spec(LUT_CELL)["config"]


@pytest.fixture(scope="module")
def net_cfg():
    return harness.cell_spec(NET_CELL)["config"]


def test_lut_tables_and_cascade_exact(lut_cfg):
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops.tail_kernel import lut_cascade_u8
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator
    from mulut_tpu_torch.pipelines.transfer import transfer_to_luts

    ref_tabs = lut.reference_tables(lut_cfg, 0, ROOT, "cpu")
    tabs = transfer_to_luts(load_params_npz(str(ROOT / lut_cfg["weights"])),
                            modes="sdy", stages=2, interval=4, device="cpu")
    for k in ref_tabs:
        assert np.array_equal(tabs[k], ref_tabs[k].numpy()), k
    ev = LutEvaluator(tabs, stages=2, modes="sdy", scale=4, interval=4,
                      device="cpu")
    for seed in (0, 2**31 + 3):
        x = torch.from_numpy(_frames(seed).transpose(0, 3, 1, 2).copy())
        got = lut_cascade_u8(ev.luts, x, stages=2, modes="sdy", scale=4,
                             interval=4)
        want = lut.cascade(ref_tabs, x, stages=2, modes="sdy", scale=4,
                           interval=4)
        assert torch.equal(got, want)


def test_int4_tables_leave_sixteen_levels():
    t = {"a": torch.arange(-127, 128, dtype=torch.int8)[:, None]}
    q = lut.int4_tables(t)["a"]
    assert len(torch.unique(q)) == 16 and int(q.abs().max()) <= 128


def test_drawn_units_are_fixed_by_the_seed(net_cfg):
    a = weights.units(net_cfg, 2**31 + 5, ROOT, "cpu")
    b = weights.units(net_cfg, 2**31 + 5, ROOT, "cpu")
    c = weights.units(net_cfg, 2**31 + 6, ROOT, "cpu")
    assert sorted(a) == [f"s{s}_{m}" for s in (1, 2) for m in "dsy"]
    n = sum(t.numel() for u in a.values() for t in u.values())
    assert n == net_cfg["parameters"] == 265_587
    assert a["s2_y"]["w6"].shape == (320, 16)
    assert a["s1_d"]["w4"].shape == (192, 64)
    for u in a:
        for k in a[u]:
            assert torch.equal(a[u][k], b[u][k])
    assert not torch.equal(a["s1_s"]["w1"], c["s1_s"]["w1"])
    # Kaiming normal, fan-in: the widest layer's spread
    assert float(a["s1_s"]["w5"].std()) == pytest.approx((2 / 256) ** 0.5,
                                                         rel=0.05)


def test_net_reference_against_float32_path(net_cfg):
    """The port's float32 net mode differs from the reference only where
    a mix sits on a tie (the port divides by 12 as XLA's fused multiply
    by float32(1/12); the reference divides)."""
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    units = weights.units(net_cfg, 11, ROOT, "cpu")
    ev = NetEvaluator(units, stages=2, modes="sdy", scale=4, device="cpu")
    frames = _frames(7)
    got = ev.upscale_batch(frames)
    want = net.upscale_rgb(units, torch.from_numpy(frames), stages=2,
                           modes="sdy", scale=4, dense=True)
    d = np.abs(got.astype(int) - want.numpy().astype(int))
    assert got.shape == want.shape
    assert (d == 0).mean() >= 0.95 and d.max() <= 8


def test_net_reference_against_bf16_path(net_cfg):
    """The bf16 path (K4's plain version on the CPU) sits close to the
    float32 reference, the fp8 control far from it."""
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    units = weights.units(net_cfg, 12, ROOT, "cpu")
    frames = torch.from_numpy(_frames(8))
    kw = dict(stages=2, modes="sdy", scale=4, dense=True)
    want = net.upscale_rgb(units, frames, **kw).numpy().astype(int)
    ev = NetEvaluator(units, stages=2, modes="sdy", scale=4, fast=True,
                      device="cpu")
    got = ev._rgb(frames, (ev.params, ev.stacked)).numpy().astype(int)
    ctl = net.upscale_rgb(units, frames, **kw, fmt="fp8").numpy().astype(int)
    mse = {k: float(((v - want).astype(float) ** 2).mean())
           for k, v in (("bf16", got), ("fp8", ctl))}
    assert mse["bf16"] < 10.0 and mse["fp8"] > 3 * mse["bf16"], mse


def test_fp8_rounding():
    t = torch.linspace(-3, 3, 1001)
    q = common.to_fp8(t)
    assert float(q.abs().max()) == pytest.approx(3.0)
    assert len(torch.unique(q)) < 256
    assert float((q - t).abs().max()) <= 3.0 / 16
