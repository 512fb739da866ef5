"""Sampling-pattern geometry for MuLUT modes.

Each mode samples exactly four pixels (a, b, c, d) out of a small receptive
field; the pattern is fully described by four (dy, dx) tap offsets plus the
right/bottom padding needed so every output pixel has all four taps in range
(ref: common/network.py:137-216 for the train-time patterns, mode_pad_dict at
sr/model.py:12, and the eval-time neighbor offsets at sr/4_test_lut.py:18-52).

Pure-Python twin of `mulut_tpu.ops.taps` (tests hold the two equal).
"""

from __future__ import annotations

import numpy as np

# mode -> ((dy, dx) for a, b, c, d)
TAPS = {
    "s": ((0, 0), (0, 1), (1, 0), (1, 1)),   # 2x2 square
    "d": ((0, 0), (0, 2), (2, 0), (2, 2)),   # dilated 2x2
    "y": ((0, 0), (1, 1), (1, 2), (2, 1)),   # diagonal "Y"
    "e": ((0, 0), (0, 3), (3, 0), (3, 3)),   # dilation-3 2x2 (Ex1/ExN)
    "h": ((0, 0), (2, 2), (2, 3), (3, 2)),   # Hx1 picks (common/network.py:207-211)
    "o": ((0, 0), (2, 2), (1, 3), (3, 1)),   # Ox1 picks (common/network.py:212-216)
}

# Right/bottom replicate padding per mode (ref: sr/model.py:12).
PAD = {"s": 1, "d": 2, "y": 2, "e": 3, "h": 3, "o": 3}


def mode_taps(mode: str):
    return TAPS[mode]


def mode_pad(mode: str) -> int:
    return PAD[mode]


def rotated_taps(mode: str, r: int):
    """Tap offsets equivalent to sampling the r-times-rot90'd image.

    The reference evaluates each rotation as rot90(img, r) -> pad ->
    interp -> rot90(out, 4-r) (ref: sr/4_test_lut.py:293-298).  Sampling
    the standard taps on the rotated image equals sampling *rotated* taps
    on the unrotated image.  Offsets may go negative; callers pad the
    image on ALL sides by `mode_pad(mode)` (edge mode), which reproduces
    the reference's per-rotation bottom/right edge padding exactly.
    """
    maps = {
        0: lambda dy, dx: (dy, dx),
        1: lambda dy, dx: (dx, -dy),
        2: lambda dy, dx: (-dy, -dx),
        3: lambda dy, dx: (-dx, dy),
    }
    return tuple(maps[r % 4](dy, dx) for dy, dx in TAPS[mode])


def fold_geometry(mode: str):
    """Rotation-folding geometry for 90-degree-symmetric tap patterns.

    When a mode's tap pattern is invariant under 90-degree rotation as a
    POINT SET (s, d, e), rotation r's taps are the base taps translated by
    a static shift and relabeled by a letter permutation:

        rotated_taps(mode, r)[i] == TAPS[mode][sigma_r[i]] + shift_r

    so all 4 rotations share one table gather per pixel (see
    `simplex_tables.fold_lut`).

    Returns a tuple over r = 0..3 of ((shift_dy, shift_dx), sigma), or
    None when the pattern has no 90-degree symmetry (y, h, o).
    """
    base = TAPS[mode]
    out = []
    for r in range(4):
        rt = rotated_taps(mode, r)
        sy = min(dy for dy, dx in rt)
        sx = min(dx for dy, dx in rt)
        norm = tuple((dy - sy, dx - sx) for dy, dx in rt)
        if set(norm) != set(base):
            return None
        sigma = tuple(base.index(t) for t in norm)
        out.append(((sy, sx), sigma))
    return tuple(out)


def lane_rotation_perm(upscale: int, r: int):
    """Lane permutation equal to rot90(up x up output block, 4-r).

    A unit's v = upscale**2 output lanes tile the output block row-major
    (lane = a*up + b for subcell (a, b)).  Un-rotating the full output
    image (ref: sr/4_test_lut.py:297-298) permutes each pixel's block by
    rot90(-r); `out[..., perm]` applies it in lane space.
    """
    grid = np.arange(upscale * upscale).reshape(upscale, upscale)
    return np.rot90(grid, -(r % 4)).flatten().copy()
