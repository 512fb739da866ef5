"""`chip_smoke.py` phase 15 (the rank-format tables and the integer
cascade) rehearsed on the CPU at a small size: a batch of 2 frames of
12 x 20, interval 6 (rank tables of 15,000 rows; "x2-s-i3" at its own
interval 3), a 6 x 10 crop, with the CUDA-event timer and the
`torch.cuda` memory calls stubbed.  The card-vs-CPU and kernel-vs-plain
gates compare the CPU path with itself here, and no kernel launches;
what this holds is that the phase runs end to end on every configuration
and prints each reading the card run reports, and that each
configuration's K1 call sites are the expected ones.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import tail_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_ms(torch_, fn, reps):
    """One call on the host clock (the card run repeats `reps` times)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def test_phase15_rehearsal_on_cpu(capsys, monkeypatch):
    for name, value in (("BATCH", 2), ("H", 12), ("W", 20), ("CROP_H", 6),
                        ("CROP_W", 10), ("INTERVAL", 6)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_cuda_ms", _cpu_ms)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 12, 20, 3)).astype(
        np.uint8)
    entries = cs._lut_rank(torch, tk, imgs, dev="cpu")
    out = capsys.readouterr().out
    assert [e["name"] for e in entries] == [
        "window_fold_contract_x4_sdyeho", "tail_assemble_x4_sdyeho",
        "window_fold_contract_x4_rank", "window_fold_contract_x2_sdy",
        "window_fold_contract_x3_sdy", "window_fold_contract_x2_eho",
        "window_fold_contract_x2_s_i3", "gather_fold_contract_rank"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(set(e) == keys for e in entries)
    for label in cs.LUT_RANK:
        assert f"{label}: crop (2, 6, 10, 3) byte-equal" in out, label
        assert f"{label}: cascade on the card" in out, label
    # the K1 row formats each configuration runs
    for line in ("x4-sdyeho: window_fold_contract u=64 rot=1 (15000, 384) "
                 "int8 C=6",
                 "x4-sdyeho: window_fold_contract u=16 rot=4 (15000, 80) "
                 "int8 C=5",
                 "x4-sdyeho: window_fold_contract u=4 rot=1 (625, 64) int8 "
                 "C=16",
                 "x4-sdyeho: window_fold_contract u=1 rot=4 (625, 16) int32",
                 "x2-sdy: window_fold_contract u=16 rot=1 (15000, 128) int8 "
                 "C=8",
                 "x2-sdy: window_fold_contract u=4 rot=4 (4, 15000, 20) int8 "
                 "C=5",
                 "x3-sdy: window_fold_contract u=36 rot=1 (15000, 180) int8 "
                 "C=5",
                 "x3-sdy: window_fold_contract u=9 rot=4 (4, 15000, 45) int8 "
                 "C=5",
                 "x2-s-i3: window_fold_contract u=16 rot=1 (1185921, 256) "
                 "int8 C=16",
                 "x4-rank: bytes equal to phase 5's",
                 "upscale_yuv_batch: crop (2, 6, 10, 3) byte-equal",
                 "gather_fold_contract x3-sdy"):
        assert line in out, line
