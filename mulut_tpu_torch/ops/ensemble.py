"""Rotation ensemble, exact integer stage mix and the cascade's table build.

The reference accumulates the four rotations and all sampling modes in
float64 and rounds with NumPy banker's rounding (ref: sr/4_test_lut.py:
279-306).  Every intermediate is a multiple of 1/q, so the cascade is
carried in int32 and each stage mix is one exact rational
round-half-to-even.  The rotation ensemble runs in tap-offset space: each
rotation r reads the same all-sides edge-padded image through rotated tap
offsets (`taps.rotated_taps`) instead of rotating the image.

Torch twin of the parts of `mulut_tpu.ops.ensemble` that the packed
cascade (`tail_kernel.lut_cascade_packed`) runs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import simplex_tables
from .simplex import simplex_planes_quad_int
from .taps import TAPS, fold_geometry, lane_rotation_perm, mode_pad, rotated_taps

# Table format per mode, as `mulut_tpu.pipelines.evaluate.LutEvaluator`
# builds them for its kernel path (`prepare_expanded_luts(shared_quad=True,
# corner16_modes="y", fold16_modes="sd", k128_stage1="sd",
# int8_stage1="y")`):
#   final stage, non-symmetric: shared un-permuted (L**4, 16*v) rows;
#   final stage, symmetric: rotation-folded (L**4, 64*v) rows, lane
#     un-rotation baked in;
#   inner stage, symmetric: (L**4, 128) corner-major 8-lane groups;
#   inner stage, non-symmetric: (L**4, 16) int8 rows.
CORNER16_MODES = "y"
FOLD16_MODES = "sd"
K128_STAGE1 = "sd"
INT8_STAGE1 = "y"


def round_half_even_div(n: torch.Tensor, d: int) -> torch.Tensor:
    """round_half_to_even(n / d) for non-negative integer n, static int d."""
    quo = n // d
    rem = n - quo * d
    twice = 2 * rem
    round_up = (twice > d) | ((twice == d) & (quo % 2 == 1))
    return quo + round_up.to(n.dtype)


def stage_mix(acc: torch.Tensor, *, q: int, avg_factor: int,
              bias: int) -> torch.Tensor:
    """clip(acc/(q*avg) + bias, 0, 255) with exact half-even rounding.

    `acc` is the integer rotation/mode accumulator (q times the
    reference's float `pred`).  Matches ref: sr/4_test_lut.py:300-302.
    """
    d = q * avg_factor
    n = torch.clamp(acc + bias * d, 0, 255 * d)
    return round_half_even_div(n, d)


def _edge_pad(img: torch.Tensor, rows: tuple, cols: tuple) -> torch.Tensor:
    """Edge-replicate padding of the last two axes by (before, after) rows
    and cols.  A clamped index gather: `F.pad(mode="replicate")` does not
    take integer tensors."""
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    ri = torch.arange(-rows[0], H + rows[1], device=dev).clamp_(0, H - 1)
    ci = torch.arange(-cols[0], W + cols[1], device=dev).clamp_(0, W - 1)
    return img.index_select(-2, ri).index_select(-1, ci)


def _pad_all(img: torch.Tensor, pad: int) -> torch.Tensor:
    return _edge_pad(img, (pad, pad), (pad, pad))


def rotation_ensemble_lanes_quad_int(lut, img, *, mode: str, upscale: int,
                                     interval: int):
    """4-rotation ensemble of a non-symmetric mode on an inner (v == 1)
    stage, rotation-summed.

    Args:
      lut: (L**4, 16) expanded table shared by all four rotations (at
        v == 1 there is no output-lane permutation).
      img: (..., H, W) int32, unpadded.

    Returns:
      (..., H, W, 1) int32 accumulator (q x reference float).
    """
    if upscale != 1:
        raise NotImplementedError(
            "wide (v > 1) quad stages run through tail_kernel.quad_flat; "
            "the XLA-twin cascade (lut_cascade_int) is a later slice")
    pad = mode_pad(mode)
    xp = _pad_all(img, pad)
    h, w = img.shape[-2], img.shape[-1]
    planes4 = [
        [
            xp[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]
            for dy, dx in rotated_taps(mode, r)
        ]
        for r in range(4)
    ]
    return simplex_planes_quad_int([lut] * 4, planes4, v=1,
                                   interval=interval)


def clamp_pad_region(img: torch.Tensor, valid_hw) -> torch.Tensor:
    """Overwrite rows/cols beyond (h, w) with edge replicas of the valid
    region.

    `img` is (..., Hb, Wb); `valid_hw = (h, w)` are scalars — or (B,)
    vectors for a batch of differently-sized images sharing one bucket
    buffer (leading img dim = B).  Equivalent to cropping each image to
    its (h, w) and edge-padding back to (Hb, Wb).
    """
    h, w = valid_hw
    Hb, Wb = img.shape[-2], img.shape[-1]
    dev = img.device
    h = torch.as_tensor(h, device=dev).to(torch.int64)
    w = torch.as_tensor(w, device=dev).to(torch.int64)
    ar_h = torch.arange(Hb, device=dev)
    ar_w = torch.arange(Wb, device=dev)
    if h.ndim == 0:
        rows = torch.minimum(ar_h, h - 1)
        cols = torch.minimum(ar_w, w - 1)
        return img.index_select(-2, rows).index_select(-1, cols)
    lead = (h.shape[0],) + (1,) * (img.ndim - 3)
    rows = torch.minimum(ar_h, (h - 1).reshape(lead + (1,)))[..., None]
    cols = torch.minimum(ar_w, (w - 1).reshape(lead + (1,)))[..., None, :]
    img = torch.gather(img, -2, rows.expand(img.shape))
    return torch.gather(img, -1, cols.expand(img.shape))


def _table_format(key: str, v: int) -> str:
    mode = key.rsplit("_", 1)[-1]
    symmetric = mode in TAPS and fold_geometry(mode) is not None
    if v > 1 and mode in CORNER16_MODES:
        return "corner16"
    if v > 1 and symmetric and mode in FOLD16_MODES:
        return "fold16"
    if v == 1 and symmetric and mode in K128_STAGE1:
        return "k128"
    if v == 1 and not symmetric and mode in INT8_STAGE1:
        return "int8"
    raise NotImplementedError(
        f"table {key!r} (v={v}): only the s/d/y formats of the packed "
        "cascade are ported; the rank-expanded and per-rotation formats "
        "(other modes) come with lut_cascade_int in a later slice")


def prepare_expanded_luts(luts: dict, *, interval: int = 4,
                          device=None) -> dict:
    """Expanded int8 tables of the packed cascade, per "s{stage}_{mode}".

    `luts` holds the source (L**4, v) tables (any integer dtype, values in
    int8 range).  With `device=None` the tables are built on the host with
    NumPy and returned as NumPy arrays; otherwise they are built ON that
    torch device from the small source LUTs (every format is a gather or
    permutation: the `simplex_tables.*_device` twins) and returned as
    tensors.  Both routes are byte-equal to `mulut_tpu`'s
    `prepare_expanded_luts` with the evaluator's kernel-path formats (see
    the module constants).
    """
    out = {}
    for key, lut in luts.items():
        arr = np.asarray(lut).astype(np.int8)
        v = arr.shape[1] if arr.ndim == 2 else 1
        up = int(round(v ** 0.5))
        fmt = _table_format(key, v)
        geo = fold_geometry(key.rsplit("_", 1)[-1])
        if device is None:
            expand, fold, a8 = (simplex_tables.expand_lut,
                                simplex_tables.fold_lut, arr)
        else:
            expand, fold = (simplex_tables.expand_lut_device,
                            simplex_tables.fold_lut_device)
            a8 = torch.as_tensor(arr, device=device)
        if fmt == "corner16":
            t = expand(a8, interval).reshape(-1, 16 * v)
        elif fmt == "fold16":
            perms = [lane_rotation_perm(up, r) for r in range(4)]
            t = fold(a8, geo, perms, interval)
        elif fmt == "k128":
            # corner m's four rotation values in lanes [m*8, m*8+4), zeros
            # in [m*8+4, m*8+8): the group-fold kernel's (C=16, u=8) rows
            f = fold(a8, geo, None, interval).reshape(-1, 16, 4)
            if device is None:
                t = np.pad(f, ((0, 0), (0, 0), (0, 4)))
            else:
                t = torch.zeros(f.shape[:2] + (8,), dtype=f.dtype,
                                device=f.device)
                t[..., :4] = f
            t = t.reshape(-1, 128)
        else:  # int8
            t = expand(a8, interval).reshape(-1, 16)
        out[key] = t
    return out


def tables_from_numpy(tabs: dict, device) -> dict:
    """Expanded tables built elsewhere (e.g. `mulut_tpu`'s
    `prepare_expanded_luts(..., shared_quad=True, corner16_modes="y",
    fold16_modes="sd", k128_stage1="sd", int8_stage1="y")`, as NumPy) ->
    the port's tensors on `device`."""
    return {k: torch.as_tensor(np.ascontiguousarray(np.asarray(t)),
                               device=device)
            for k, t in tabs.items()}
