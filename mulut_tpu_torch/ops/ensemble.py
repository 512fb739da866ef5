"""Rotation ensemble, exact integer stage mix, the cascade's table build and
the integer cascade.

The reference accumulates the four rotations and all sampling modes in
float64 and rounds with NumPy banker's rounding (ref: sr/4_test_lut.py:
279-306).  Every intermediate is a multiple of 1/q, so the cascade is
carried in int32 and each stage mix is one exact rational
round-half-to-even.  The rotation ensemble runs in tap-offset space: each
rotation r reads the same all-sides edge-padded image through rotated tap
offsets (`taps.rotated_taps`) instead of rotating the image.

Every contraction over an expanded table (16-corner, folded, rank, per
rotation) runs the window-read simplex contraction
(`tail_kernel.window_fold_contract`, K1), which launches its CUDA kernel
on the card and runs its plain torch version on the CPU; only the
reference engine over raw (L**4, v) tables (`expanded=False`) is torch
arithmetic.  The rotation un-shifts, stage mixes and the PixelShuffle
interleave are torch ops.

`lut_cascade_banded` runs the cascade over row slabs of a large image
(`run_banded`, shared with the packed banded form in `tail_kernel` and the
row-sharded cascade in `parallel.spatial`).

Torch twin of `mulut_tpu.ops.ensemble` (without the disk cache).
"""

from __future__ import annotations

import numpy as np
import torch

from . import simplex_tables
from . import tail_kernel as tk
from .simplex import _interleave, simplex_planes_int
from .taps import (
    TAPS,
    fold_geometry,
    lane_rotation_perm,
    mode_pad,
    mode_taps,
    rotated_taps,
)

#: The table formats `LutEvaluator` builds for its packed x4 cascade, the
#: flags the JAX package's evaluator passes for its kernel path
#: (`mulut_tpu/pipelines/evaluate.py:103-110`):
#:   final stage, y: shared un-permuted 16-corner (L**4, 16*v) rows;
#:   final stage, s/d: rotation-folded 16-corner (L**4, 64*v) rows;
#:   final stage, e: rank-folded rows; h/o: one shared rank table;
#:   inner stage, s/d: (L**4, 128) corner-major 8-lane groups;
#:   inner stage, y: (L**4, 16) int8 rows; e: (L**4, 64) folded rows;
#:   h/o: (L**4, 16) int32 rows.
KERNEL_FORMATS = dict(shared_quad=True, corner16_modes="y",
                      fold16_modes="sd", k128_stage1="sd", int8_stage1="y")


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


def _quad_sum(lut, img, *, mode: str, v: int, interval: int):
    """The four rotations of a mode, each through its rotated taps from the
    all-sides padded image, contracted in one launch and summed: (..., H,
    W, v) int32.  `lut` is shared by the rotations or stacked per
    rotation (`window_fold_contract`'s formats)."""
    pad = mode_pad(mode)
    h, w = img.shape[-2], img.shape[-1]
    xp = _pad_all(img, pad)
    out = tk.window_fold_contract(
        lut, tk._plane(xp), taps=[rotated_taps(mode, r) for r in range(4)],
        origin=(pad, pad), grid=(h, w), interval=interval, u=v)
    if v == 1:
        return out.reshape(img.shape + (1,))
    # integer-valued float32 below 2**24: the rotation sum is exact
    acc = out[:, :, : out.shape[-1] - 8].sum(0)
    return acc.to(torch.int32).T.reshape(img.shape + (v,))


def rotation_ensemble_lanes_int(lut, img, *, mode: str, upscale: int,
                                interval: int, expanded: bool = False):
    """Sum over 4 rotations in fused tap-offset form.

    Args:
      lut: (L**4, v) int32 table, or with expanded=True a corner-expanded
        int8 table (`simplex_tables.expand_lut`): (L**4, 16 * v) shared by
        the rotations, or (4, L**4, 16 * v) per-rotation copies with the
        lane un-rotation baked in (`prepare_expanded_luts`).
      img: (..., H, W) int32, unpadded.

    Returns:
      (..., H, W, upscale**2) int32 lane accumulator (q x reference float),
      lanes already un-rotated — interleave once to get pixels.
    """
    v = upscale * upscale
    if expanded:
        return _quad_sum(lut, img, mode=mode, v=v, interval=interval)
    pad = mode_pad(mode)
    xp = _pad_all(img, pad)
    h, w = img.shape[-2], img.shape[-1]
    acc = None
    for r in range(4):
        planes = [xp[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                  for dy, dx in rotated_taps(mode, r)]
        out = simplex_planes_int(lut, planes, interval=interval)
        if upscale > 1 and r:
            out = out[..., torch.as_tensor(lane_rotation_perm(upscale, r),
                                           device=out.device)]
        acc = out if acc is None else acc + out
    return acc


def rotation_ensemble_lanes_quad_int(lut, img, *, mode: str, upscale: int,
                                     interval: int, fused: bool = True,
                                     rank: bool = False):
    """4-rotation ensemble of a non-symmetric mode, rotation-summed.

    `lut` is a 16-corner (L**4, 16 * v) table or a rank (L**4 * 24, 5 * v)
    table (`simplex_tables.rank_expand_shared`), shared by the rotations;
    or four of either stacked per rotation (`rank_expand_rotations`, the
    16-corner per-rotation copies); at v == 1 the (L**4, 16) int8 or int32
    inner-stage table.  One window contraction reads all four rotations.
    `fused` and `rank` are the JAX signature's and have no effect here:
    `fused` picks a TPU layout there, and the contraction reads the
    table's format from its shape.  Returns (..., H, W, v) int32.
    """
    v = upscale * upscale
    return _quad_sum(lut, img, mode=mode, v=v, interval=interval)


def rotation_ensemble_lanes_folded_int(flut, img, *, mode: str, upscale: int,
                                       interval: int, fused: bool = True,
                                       rank: bool = False):
    """All 4 rotations of a symmetric-pattern mode (s, d, e) in one gather
    per pixel.

    `flut` is a rotation-folded table: `simplex_tables.fold_lut` rows
    (L**4, 64 * v), or `rank_fold_lut` rows (L**4 * 24, >= 20 * v).  Each
    rotation reads the shared 4-pixel window at a static shift, so one
    contraction runs over the extended plane of every window origin a
    rotation needs, and the rotations' lane blocks are summed through
    static un-shift slices.  `fused` and `rank` are the JAX signature's
    and have no effect here: the contraction reads the table's format from
    its shape.  Returns (..., H, W, v) int32.
    """
    geo = fold_geometry(mode)
    pad = mode_pad(mode)
    v = upscale * upscale
    h, w = img.shape[-2], img.shape[-1]
    my = -min(s[0] for s, _ in geo)
    mx = -min(s[1] for s, _ in geo)
    he, we = h + my, w + mx
    xp = _pad_all(img, pad)
    ext = tk.window_fold_contract(
        flut, tk._plane(xp), taps=(mode_taps(mode),),
        origin=(pad - my, pad - mx), grid=(he, we), interval=interval,
        u=4 * v)[0]
    lead = tuple(img.shape[:-2])
    ext = ext[:, : ext.shape[-1] - 8].reshape((4, v) + lead + (he, we))
    acc = None
    for r, ((sy, sx), _) in enumerate(geo):
        oy, ox = sy + my, sx + mx
        piece = ext[r, ..., oy: oy + h, ox: ox + w]
        acc = piece if acc is None else acc + piece
    return torch.movedim(acc, 0, -1).to(torch.int32)


def prepare_expanded_luts(luts: dict, *, interval: int = 4,
                          rank: bool = True,
                          shared_quad: bool = False,
                          corner16_modes: str = "",
                          fold16_modes: str = "",
                          k128_stage1: str = "",
                          int8_stage1: str = "",
                          device=None) -> dict:
    """Corner-expanded tables, rotation-folded where legal, per
    "s{stage}_{mode}" key (ref: sr/4_test_lut.py:323-333).

    `luts` holds the source (L**4, v) tables (any integer dtype, values in
    int8 range).  Per key, as `mulut_tpu`'s `prepare_expanded_luts`:

      * symmetric modes (s, d, e), v > 1: rank-folded rows
        (`simplex_tables.rank_fold_lut`, (L**4 * 24, tile-padded 20 * v)),
        the lane un-rotation baked in per rotation block — or, for modes in
        `fold16_modes` or without `rank` or at interval < 4, 16-corner
        folded rows (`fold_lut`, (L**4, 64 * v));
      * symmetric modes, v == 1: `fold_lut` rows (L**4, 64);
      * non-symmetric modes (y, h, o), v > 1: per-rotation rank tables
        (4, L**4 * 24, 5 * v), or with `shared_quad` one shared
        un-permuted rank table (L**4 * 24, 5 * v); without rank, per-rotation
        16-corner copies (4, L**4, 16 * v);
      * non-symmetric modes, v == 1: (L**4, 16) int32, or int8 for modes in
        `int8_stage1`;
      * `corner16_modes` (with `shared_quad`), v > 1: one shared
        un-permuted 16-corner table (L**4, 16 * v);
      * `k128_stage1`, v == 1: (L**4, 128) int8, corner m's (rotation)
        values in lanes [m*8, m*8+4) (non-symmetric: lane m*8), zeros
        elsewhere.

    Rank tables need L <= 17 (interval >= 4).  Keys whose mode is not a
    sampling mode get the generic per-rotation formats.  With
    `device=None` the tables are built on the host with NumPy and returned
    as NumPy arrays; otherwise they are built on that torch device from
    the small source LUTs (the `simplex_tables.*_device` twins) and
    returned as tensors.  Both are byte-equal to the JAX package's.
    """
    if device is None:
        def src(a):
            return a
        expand, fold = simplex_tables.expand_lut, simplex_tables.fold_lut
        rank_fold = simplex_tables.rank_fold_lut
        rank_shared = simplex_tables.rank_expand_shared
        rank_rot = simplex_tables.rank_expand_rotations
    else:
        def src(a):
            return torch.as_tensor(a, device=device)
        expand = simplex_tables.expand_lut_device
        fold = simplex_tables.fold_lut_device
        rank_fold = simplex_tables.rank_fold_lut_device
        rank_shared = simplex_tables.rank_expand_shared_device
        rank_rot = simplex_tables.rank_expand_rotations_device
    L = 2 ** (8 - interval) + 1
    out = {}
    for key, lut in luts.items():
        arr = np.asarray(lut).astype(np.int8)
        mode = key.rsplit("_", 1)[-1]
        geo = fold_geometry(mode) if mode in TAPS else None
        v = arr.shape[1] if arr.ndim == 2 else 1
        up = int(round(v ** 0.5))
        use_rank = rank and v > 1 and L <= 17 and mode not in fold16_modes
        perms = [lane_rotation_perm(up, r) for r in range(4)]
        a8 = src(arr)
        if shared_quad and v > 1 and mode in corner16_modes:
            t = expand(a8, interval).reshape(-1, 16 * v)
        elif v == 1 and mode in k128_stage1:
            # corner m's values in lane group [m*8, m*8+8): the group-fold
            # contraction's (C=16, u=8) rows
            if geo is not None:
                f = fold(a8, geo, None, interval).reshape(-1, 16, 4)
            else:
                f = expand(a8, interval).reshape(-1, 16, 1)
            if device is None:
                t = np.pad(f, ((0, 0), (0, 0), (0, 8 - f.shape[2])))
            else:
                t = torch.zeros(f.shape[:2] + (8,), dtype=f.dtype,
                                device=f.device)
                t[..., :f.shape[2]] = f
            t = t.reshape(-1, 128)
        elif geo is not None:
            build = rank_fold if use_rank else fold
            t = build(a8, geo, perms if v > 1 else None, interval)
        elif use_rank:
            t = (rank_shared(a8, interval) if shared_quad
                 else rank_rot(a8, perms, interval))
        else:
            e = expand(a8, interval)
            if v == 1:
                t = e.reshape(-1, 16)
                if mode not in int8_stage1:
                    t = (t.astype(np.int32) if device is None
                         else t.to(torch.int32))
            elif device is None:
                t = np.stack([e[:, :, p].reshape(e.shape[0], -1)
                              for p in perms])
            else:
                t = torch.stack([
                    e.index_select(2, torch.as_tensor(p, device=device))
                    .reshape(e.shape[0], -1) for p in perms])
        out[key] = t
    return out


def rotation_ensemble_int(lut, img, *, mode: str, upscale: int,
                          interval: int):
    """Sum of the 4 rotated simplex-interp passes, spatially interleaved:
    the reference's rot90 -> pad -> interp -> rot90-back loop (ref:
    sr/4_test_lut.py:293-298) without rotating any image."""
    acc = rotation_ensemble_lanes_int(lut, img, mode=mode, upscale=upscale,
                                      interval=interval)
    return _interleave(acc, upscale)


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
    ar_h = torch.arange(Hb, device=dev)
    ar_w = torch.arange(Wb, device=dev)
    if not torch.is_tensor(h) and np.ndim(h) == 0 and np.ndim(w) == 0:
        # host scalars: no copy to the device (and no wait for it)
        rows = ar_h.clamp_(max=int(h) - 1)
        cols = ar_w.clamp_(max=int(w) - 1)
        return img.index_select(-2, rows).index_select(-1, cols)
    h = torch.as_tensor(h, device=dev).to(torch.int64)
    w = torch.as_tensor(w, device=dev).to(torch.int64)
    if h.ndim == 0:
        rows = torch.minimum(ar_h, h - 1)
        cols = torch.minimum(ar_w, w - 1)
        return img.index_select(-2, rows).index_select(-1, cols)
    lead = (h.shape[0],) + (1,) * (img.ndim - 3)
    rows = torch.minimum(ar_h, (h - 1).reshape(lead + (1,)))[..., None]
    cols = torch.minimum(ar_w, (w - 1).reshape(lead + (1,)))[..., None, :]
    img = torch.gather(img, -2, rows.expand(img.shape))
    return torch.gather(img, -1, cols.expand(img.shape))


def lut_cascade_int(luts: dict, img, *, stages: int, modes: str, scale: int,
                    interval: int = 4, expanded: bool = False,
                    fused: bool = True, valid_hw=None):
    """Full multi-stage x multi-mode x rotation-ensemble LUT cascade.

    Args:
      luts: {"s{stage}_{mode}": (L**4, v) int32 tensor} with v = scale**2
        for the last stage and 1 otherwise (ref: sr/4_test_lut.py:323-333);
        with expanded=True, `prepare_expanded_luts` tables instead (their
        formats are recognized by shape).
      img: (..., H, W) integer in [0, 255]; channels ride the leading dims.
      fused: the JAX signature's TPU layout choice; no effect here.
      valid_hw: optional (h, w) scalars or (B,) vectors for bucketed
        evaluation; the pad region is re-synchronized to edge replicas of
        the valid region before every stage (`clamp_pad_region`).

    Returns:
      (..., H*scale, W*scale) int32 in [0, 255], byte-identical to the
      reference NumPy engine (ref: sr/4_test_lut.py:263-306).
    """
    q = 2 ** interval
    L4 = (2 ** (8 - interval) + 1) ** 4
    x = img.to(torch.int32)
    for s in range(stages):
        if valid_hw is not None:
            x = clamp_pad_region(x, valid_hw)
        last = s + 1 == stages
        upscale = scale if last else 1
        avg_factor = len(modes) if last else len(modes) * 4
        bias = 0 if last else 127
        v = upscale * upscale
        acc = None
        for mode in modes:
            lut = luts[f"s{s + 1}_{mode}"]
            kw = dict(mode=mode, upscale=upscale, interval=interval)
            # folded rows: 16-corner (L**4, 64 * v) or rank (24 * L**4, .)
            if (expanded and lut.dim() == 2
                    and (lut.shape[0] == L4 * 24 or lut.shape[1] == 64 * v)
                    and fold_geometry(mode) is not None):
                out = rotation_ensemble_lanes_folded_int(lut, x, **kw)
            elif expanded and (lut.dim() == 3 or lut.shape[1] == 16):
                out = rotation_ensemble_lanes_quad_int(lut, x, **kw)
            else:
                out = rotation_ensemble_lanes_int(lut, x, expanded=expanded,
                                                  **kw)
            acc = out if acc is None else acc + out
        mixed = stage_mix(acc, q=q, avg_factor=avg_factor, bias=bias)
        x = _interleave(mixed, upscale) if upscale > 1 else mixed[..., 0]
    return x


def tables_from_numpy(tabs: dict, device) -> dict:
    """Expanded tables built elsewhere (e.g. `mulut_tpu`'s
    `prepare_expanded_luts(..., shared_quad=True, corner16_modes="y",
    fold16_modes="sd", k128_stage1="sd", int8_stage1="y")`, as NumPy) ->
    the port's tensors on `device`."""
    return {k: torch.as_tensor(np.ascontiguousarray(np.asarray(t)),
                               device=device)
            for k, t in tabs.items()}


def cascade_halo(stages: int, modes: str) -> int:
    """Rows of context the cascade reads beyond a band, per side: the
    widest mode's tap pad, once per stage."""
    return stages * max(mode_pad(m) for m in modes)


def slab_bounds(h: int, band: int, halo: int):
    """Clamped slabs over `h` rows: `slab_h` (band + 2 * halo, at most h)
    and, per band of `band` kept rows, (kept0, start): its first kept row
    and its slab's first row, the slab clamped into the image so that a
    true image edge is a slab edge (where the cascade's own edge padding
    applies); a last band that does not fit overlaps the one before it."""
    slab_h = min(band + 2 * halo, h)
    bounds = []
    for i in range(-(-h // band)):
        kept0 = min(i * band, h - band)
        bounds.append((kept0, min(max(kept0 - halo, 0), h - slab_h)))
    return slab_h, bounds


def slab_valid(valid_hw, start: int, slab_h: int):
    """A slab's `valid_hw`: rows `valid_h - start` of the slab, at least 1
    (a slab wholly in the pad region is cropped off anyway), clamping the
    full buffer then slicing a slab being equal to slicing then clamping
    locally."""
    if valid_hw is None:
        return None
    vh, vw = valid_hw
    if not torch.is_tensor(vh) and np.ndim(vh) == 0:
        return min(max(int(vh) - start, 1), slab_h), vw
    return torch.clamp(torch.as_tensor(vh) - start, 1, slab_h), vw


def run_banded(run, img, *, band: int, halo: int, scale: int,
               valid_hw=None) -> torch.Tensor:
    """`run(slab, slab_valid_hw)`, a cascade (..., h, W) -> (..., h*scale,
    W*scale) with values in [0, 255], over the clamped slabs of
    `slab_bounds`; each band's kept rows go into one preallocated uint8
    (..., H*scale, W*scale) output on `img`'s device.  The cascade's
    receptive field is `halo` rows, so a band's rows equal the untiled
    cascade's.  An image no taller than one slab runs whole."""
    h, w = img.shape[-2], img.shape[-1]
    if h <= band + 2 * halo:
        return run(img, valid_hw).to(torch.uint8)
    slab_h, bounds = slab_bounds(h, band, halo)
    out = torch.empty(tuple(img.shape[:-2]) + (h * scale, w * scale),
                      dtype=torch.uint8, device=img.device)
    for kept0, start in bounds:
        o = run(img.narrow(-2, start, slab_h),
                slab_valid(valid_hw, start, slab_h))
        out.narrow(-2, kept0 * scale, band * scale).copy_(
            o.narrow(-2, (kept0 - start) * scale, band * scale))
    return out


def lut_cascade_banded(luts: dict, img, *, stages: int, modes: str,
                       scale: int, interval: int = 4, expanded: bool = False,
                       fused: bool = True, band: int = 128, valid_hw=None):
    """Row-banded `lut_cascade_int` for large single images: bands of
    `band` rows, each computed in a slab with `cascade_halo` context rows
    per side clamped into the image (`run_banded`), bytes equal to the
    untiled cascade; the slab temporaries do not grow with the image.

    Same signature as `mulut_tpu`'s `lut_cascade_banded`; `valid_hw` (h, w)
    scalars or (B,) vectors compose with the bands through each slab's
    local validity (`slab_valid`).  Returns (..., H*scale, W*scale)
    uint8 (the JAX package returns the same values as int32).
    """
    def run(slab, valid):
        return lut_cascade_int(luts, slab, stages=stages, modes=modes,
                               scale=scale, interval=interval,
                               expanded=expanded, fused=fused,
                               valid_hw=valid)

    return run_banded(run, img, band=band, halo=cascade_halo(stages, modes),
                      scale=scale, valid_hw=valid_hw)
