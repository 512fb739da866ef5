"""Operations and bytes of a batch, from the configuration's shapes alone.

Nothing here reads a tensor of the program, so a kernel's roofline reads
the same work whatever implements it.  Each bound is the least time that
any implementation of the same call could take on one H100 SXM: the
larger of the useful operations over the peak and the compulsory bytes
over the memory bandwidth.  Bytes count each input read once and each
output written once, at the narrowest type that holds its values; a
layout that the program chooses (float32 lanes, per-rotation copies,
expanded tables, tap matrices) does not count, so a later kernel that
drops one cannot read above 100%.

This module holds the peaks and what every kind shares; `work/<kind>.py`
(the configuration's `kind`) gives `work(cfg, traffic)`, the dict of
bounds in seconds that the readers in `metrics/` read.

Peaks: NVIDIA's published H100 SXM figures, dense, without sparsity.
"""

from __future__ import annotations

import importlib

PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 in, float32 accumulate
PEAK_INT8_OPS = 1979e12      # tensor cores, int8
PEAK_HBM_BYTES = 3.35e12     # HBM3

N_ROTATIONS = 4              # the rotation ensemble


def sites(traffic: dict, channels: int) -> int:
    return (traffic["frames_per_batch"] * channels * traffic["height"]
            * traffic["width"])


def stage_lanes(cfg: dict) -> list:
    """Output lanes per site of each stage: 1, and scale**2 at the last."""
    return [cfg["scale"] ** 2 if s + 1 == cfg["stages"] else 1
            for s in range(cfg["stages"])]


def bound_s(ops: float, ops_peak: float, nbytes: float) -> float:
    return max(ops / ops_peak, nbytes / PEAK_HBM_BYTES)


def frame_io_bytes(cfg: dict, traffic: dict) -> int:
    """The batch's uint8 RGB frames in and upscaled frames out."""
    lr = sites(traffic, 3)
    return lr + lr * cfg["scale"] ** 2


def out_pixels(cfg: dict, traffic: dict) -> int:
    """Output pixels of a batch (H*s x W*s per frame, channels not
    counted)."""
    return (traffic["frames_per_batch"] * traffic["height"]
            * traffic["width"] * cfg["scale"] ** 2)


def cell_work(cfg: dict, traffic: dict) -> dict:
    """The work of one batch of the cell: `work/<kind>.py`'s `work`."""
    kind = importlib.import_module(f"{__name__}.{cfg['kind']}")
    return kind.work(cfg, traffic)
