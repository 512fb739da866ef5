"""LUT artifact IO: the .npy naming scheme shared with the reference.

File layout (ref: sr/2_transfer_to_lut.py:114-116, sr/4_test_lut.py:330-333):
    {name}_x{scale}_{bits}bit_int8_s{stage}_{mode}.npy
where transfer/finetune write with bits=interval and the test step loads with
bits=8-interval; these coincide at the default interval=4.  We write with
interval (matching produced artifacts) and read with 8-interval (matching the
consumer), so the default pipeline round-trips and reference artifacts load.

NumPy twin of `mulut_tpu.utils.lut_io`.
"""

from __future__ import annotations

import os
import re

import numpy as np

_STAGE_KEY_RE = re.compile(r"^s(\d+)_([a-z]+)$")


def lut_key(stage: int, mode: str) -> str:
    return f"s{stage}_{mode}"


def parse_stage_key(key: str) -> tuple:
    """'s12_y' -> (12, 'y')."""
    m = _STAGE_KEY_RE.match(key)
    if m is None:
        raise ValueError(f"not a stage key: {key!r}")
    return int(m.group(1)), m.group(2)


def lut_filename(name: str, scale: int, bits: int, stage: int, mode: str) -> str:
    return f"{name}_x{scale}_{bits}bit_int8_s{stage}_{mode}.npy"


def save_lut(folder: str, arr: np.ndarray, *, name: str, scale: int,
             interval: int, stage: int, mode: str) -> str:
    path = os.path.join(folder, lut_filename(name, scale, interval, stage, mode))
    np.save(path, arr.astype(np.int8))
    return path


def load_luts(
    folder: str,
    *,
    stages: int,
    modes: str,
    scale: int,
    interval: int = 4,
    name: str = "LUT_ft",
    dtype=np.int32,
) -> dict:
    """Load the full LUT set as {key: (L**4, v) dtype} flat tables.

    Accepts both bit labels: the consumer's `{8-interval}bit` first (so
    reference artifacts load), then the producer's `{interval}bit`.
    """
    luts = {}
    for s in range(stages):
        stage = s + 1
        v = scale * scale if stage == stages else 1
        for mode in modes:
            candidates = [
                os.path.join(
                    folder, lut_filename(name, scale, bits, stage, mode)
                )
                for bits in dict.fromkeys((8 - interval, interval))
            ]
            path = next((p for p in candidates if os.path.exists(p)),
                        candidates[0])
            luts[lut_key(stage, mode)] = (
                np.load(path).astype(dtype).reshape(-1, v)
            )
    return luts
