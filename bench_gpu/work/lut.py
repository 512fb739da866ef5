"""Work of the LUT cascade (configuration kind `lut`) on a batch of RGB
frames.

K1, one call per stage and mode: the stage's uint8 plane in, the mode's
source table (L**4 rows of v int8 lanes) read once, the sum of the four
rotations out as int16 lanes (|sum| <= 4 * 127 * q < 2**15).  K2, once:
the last stage's per-mode int16 lanes in, the uint8 sub-pixels out.
Operations: the simplex contraction's multiply-adds (4 rotations x 5
corners x v lanes per site and mode), against the int8 tensor-core peak,
the highest the card has.
"""

from __future__ import annotations

from bench_gpu.work import (N_ROTATIONS, PEAK_HBM_BYTES, PEAK_INT8_OPS,
                            bound_s, frame_io_bytes, sites, stage_lanes)

N_CORNERS = 5                # corners of a 4-D simplex


def work(cfg: dict, traffic: dict) -> dict:
    L = 2 ** (8 - cfg["interval"]) + 1
    M = len(cfg["modes"])
    n = sites(traffic, 3)
    lanes = stage_lanes(cfg)
    k1_bytes = sum(M * (n + L ** 4 * v + n * v * 2) for v in lanes)
    k1_ops = sum(M * n * N_ROTATIONS * N_CORNERS * v * 2 for v in lanes)
    v_last = lanes[-1]
    k2_bytes = n * M * v_last * 2 + n * v_last
    tables = sum(M * L ** 4 * v for v in lanes)
    step_bytes = frame_io_bytes(cfg, traffic) + tables
    return {
        "k1_bound_s": bound_s(k1_ops, PEAK_INT8_OPS, k1_bytes),
        "k2_bound_s": k2_bytes / PEAK_HBM_BYTES,
        "step_bound_s": bound_s(k1_ops, PEAK_INT8_OPS, step_bytes),
        "ops": k1_ops, "k1_bytes": k1_bytes, "k2_bytes": k2_bytes,
        "step_bytes": step_bytes,
    }
