"""What decides `correct`: the program's outputs against the plain
reference, each number beside its limit.

The reference of the configuration's kind (`reference/<kind>.py`)
recomputes everything from the units and the frames: the LUT cell's
tables and cascade, the net cell's float32 forward.  The numbers:

- `table_off`: entries of the int8 tables that set-up derived from the
  units and that differ from the reference's (LUT cells);
- `bytes_off`: output bytes of the compared batches that differ from the
  reference's (LUT cells; the cascade is exact);
- `mse_worst_frame`: the largest, over the compared frames, of a frame's
  mean squared difference from the float32 reference, in uint8 levels
  (net cells: bf16 on the tensor cores against float32).

A number is compared where the cell's workload file gives it a limit;
it passes when it is at most the limit.
"""

from __future__ import annotations

import importlib

import numpy as np


class Reservoir:
    """A uniform sample of `k` of the window's batches, drawn from the
    seed; it keeps references to outputs and copies nothing."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.items: list = []

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = item


def reference_kind(cfg: dict):
    """`reference/<kind>.py` of the configuration."""
    return importlib.import_module(f"bench_gpu.reference.{cfg['kind']}")


def batch_readings(got: np.ndarray, want: np.ndarray) -> dict:
    if got.shape != want.shape or got.dtype != np.uint8:
        # a missing or misshapen answer reads as the worst it could be
        return {"bytes_off": int(want.size), "mse_worst_frame": 255.0 ** 2}
    d = got.astype(np.int32) - want.astype(np.int32)
    mse = (d.reshape(d.shape[0], -1).astype(np.float64) ** 2).mean(axis=1)
    return {"bytes_off": int(np.count_nonzero(d)),
            "mse_worst_frame": float(mse.max())}


def readings(cfg: dict, seed: int, frame_batches: list, sample: list,
             program_state, root, device):
    """Readings of the sampled (batch index, host output) pairs and of
    what the program's set-up derived.  Returns (readings, per-batch
    readings)."""
    ref = reference_kind(cfg).Reference(cfg, seed, root, device)
    out = dict(ref.state_readings(program_state))
    refs: dict = {}
    per_batch = []
    for b, got in sample:
        if b not in refs:
            refs[b] = ref.outputs(frame_batches[b])
        per_batch.append(batch_readings(got, refs[b]))
    if per_batch:
        out["bytes_off"] = sum(r["bytes_off"] for r in per_batch)
        out["mse_worst_frame"] = max(r["mse_worst_frame"] for r in per_batch)
    return out, per_batch


def judge(values: dict, limits: dict, per_batch: list):
    """(correct, failed batches, {name: {"value", "limit"}}) over the
    numbers that have a limit; a number that could not be read fails."""
    check = {}
    for name, limit in limits.items():
        v = values.get(name)
        check[name] = {"value": v, "limit": limit}
    correct = bool(per_batch) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())
    failed = sum(any(name in r and r[name] > limits[name] for name in limits)
                 for r in per_batch)
    return correct, failed, check
