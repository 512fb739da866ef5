"""`chip_smoke.py` phase 16 (how the port cuts an image or a batch)
rehearsed on the CPU at a small size: 40 x 64 and 72 x 96 frames in
16-row bands, band + bucket on three small frames, 4 row or batch shards
of the CPU, the data-parallel steps at nf=8, interval 6 (tables of 5**4
rows), with the CUDA-event timer and the dry run (tested on its own)
stubbed.  No kernel launches here and peak memory is not measured, so the
launch and memory gates are the card's; what this holds is that the
phase runs end to end, that each of its byte-equality gates passes on the
kernels' plain versions, and that it prints each reading the card run
reports.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch import dryrun
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


def test_phase16_rehearsal_on_cpu(capsys, monkeypatch):
    for name, value in (("FRAME_4K", (40, 64)), ("FRAME_8K", (72, 96)),
                        ("BAND_ROWS", 16), ("MANY_BUCKET", 16),
                        ("MANY_BAND", 8), ("NET_SHARD_BATCH", 3),
                        ("BAND_CHECK_MARGIN", 8), ("INTERVAL", 6),
                        ("MANY_SIZES", [(22, 30), (17, 40), (9, 12)]),
                        ("TRAIN", dict(cs.TRAIN, nf=8, batch=4, crop=8,
                                       images=2, hr=64))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_cuda_ms", _cpu_ms)
    # the dry run has its own test (tests/test_torch_parallel.py)
    monkeypatch.setattr(dryrun, "dryrun_multidevice",
                        lambda n, devices: ["stubbed"])
    imgs = np.random.default_rng(0).integers(0, 256, (4, 24, 32, 3)).astype(
        np.uint8)
    cs._parallel(torch, tk, imgs, dev="cpu")
    out = capsys.readouterr().out
    for line in (
            "4K band=16: bytes equal to the untiled cascade; 3 slabs",
            "8K banded: ", "5 slabs of 24 rows",
            "8K band 2 (rows 32-48): bytes equal to the untiled cascade on "
            "rows 24-56",
            "band + bucket: bytes equal to bucket alone",
            "row-sharded bench batch: bytes equal",
            "row-sharded 4K frame: bytes equal",
            "net_row_sharded: (4, 3, 96, 128) bytes equal",
            "NetEvaluator(4 shards).upscale_batch: (3, 96, 128, 3) bytes "
            "equal",
            "NetEvaluator(4 shards).upscale_yuv_batch: (3, 96, 128, 3) bytes "
            "equal",
            "train step, 2 shards vs one device: loss",
            "fine-tune step, _ftr2 tables, 2 shards vs one device: loss",
            "fine-tune step, random tables, 2 shards vs one device: loss",
            "fine-tune step, _ftr2 tables, 2 shards: card vs CPU: loss",
            "fine-tune step, _ftr2 tables in float64, 2 shards vs one "
            "device: loss",
            "fine-tune step, _ftr2 tables: params after the step, 2 shards "
            "vs one device",
            "train step: params after the step",
            "dryrun_multidevice(4, ['cpu'] * 4): stubbed",
            "phase 16: "):
        assert line in out, line
