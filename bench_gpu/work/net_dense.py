"""Work of net mode with dense-concat MuLUT units (configuration kind
`net_dense`) on a batch of RGB frames: the network on all three channels.

K4, one call per stage: the stage's plane in (uint8 values), every mode's
bf16 weights read once, the stage's uint8 output (1 lane, or scale**2 at
the last stage) out.  Operations: every unit's matmuls at every site, 4
rotations per mode, against the bf16 tensor-core peak.
"""

from __future__ import annotations

from bench_gpu.work import (N_ROTATIONS, PEAK_BF16_FLOPS, bound_s,
                            frame_io_bytes, sites, stage_lanes)


def dense_unit_flops(nf: int, depth: int, v: int) -> int:
    """Multiply-adds x 2 of one dense unit at one site: the 4-tap head,
    `depth` layers each reading the concat of all before it (k * nf
    inputs for the k-th), the v-lane output over (depth + 1) * nf."""
    hidden = sum(k * nf * nf for k in range(1, depth + 1))
    return 2 * (4 * nf + hidden + (depth + 1) * nf * v)


def dense_unit_params(nf: int, depth: int, v: int) -> int:
    hidden = sum(k * nf * nf + nf for k in range(1, depth + 1))
    return 4 * nf + nf + hidden + (depth + 1) * nf * v + v


def work(cfg: dict, traffic: dict) -> dict:
    nf, depth, M = cfg["nf"], cfg["depth"], len(cfg["modes"])
    n = sites(traffic, 3)
    k4_bound, flops, weights = 0.0, 0, 0
    for v in stage_lanes(cfg):
        f = n * M * N_ROTATIONS * dense_unit_flops(nf, depth, v)
        w = M * dense_unit_params(nf, depth, v) * 2
        k4_bound += bound_s(f, PEAK_BF16_FLOPS, n + w + n * v)
        flops += f
        weights += w
    step_bytes = frame_io_bytes(cfg, traffic) + weights
    return {
        "k4_bound_s": k4_bound,
        "step_bound_s": bound_s(flops, PEAK_BF16_FLOPS, step_bytes),
        "flops": flops, "step_bytes": step_bytes,
    }
