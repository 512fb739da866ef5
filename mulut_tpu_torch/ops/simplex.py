"""Exact integer 4-D simplex (tetrahedral) interpolation over MuLUT tables.

The reference selects one of 24 corner/weight assignments per pixel through
a chain of masked branches (ref: sr/4_test_lut.py:148-231).  Here the
weights are the adjacent differences of the descending-sorted fractions
(a 5-comparator network) and the corners follow from the fractions' ranks,
which carry the reference's tie-breaking; both are branchless tensor code.

Conventions: LUTs are flat (L**4, v) tables indexed a*L^3 + b*L^2 + c*L + d
(ref: sr/model.py:128); images are (..., H, W) int32 with values in
[0, 255].  Weighted sums are integer-valued float32 below 2**24, so every
summation order is exact.

Torch twin of the integer path of `mulut_tpu.ops.simplex`.
"""

from __future__ import annotations

import numpy as np
import torch

# Corner mask m -> its (a, b, c, d) bits (bit 3 = a).
_CORNER_BITS = np.array(
    [[(m >> 3) & 1, (m >> 2) & 1, (m >> 1) & 1, m & 1] for m in range(16)]
)


def _interleave(out: torch.Tensor, upscale: int) -> torch.Tensor:
    """(..., h, w, up*up) -> (..., h*up, w*up), ref: sr/model.py:283-285."""
    *lead, h, w, _ = out.shape
    out = out.reshape(*lead, h, w, upscale, upscale)
    out = torch.movedim(out, -2, -3)  # (..., h, up, w, up)
    return out.reshape(*lead, h * upscale, w * upscale)


def _sorted_fractions(fa, fb, fc, fd):
    """Descending sort of the four fractions via a 5-comparator network."""
    hi_ab, lo_ab = torch.maximum(fa, fb), torch.minimum(fa, fb)
    hi_cd, lo_cd = torch.maximum(fc, fd), torch.minimum(fc, fd)
    s0 = torch.maximum(hi_ab, hi_cd)
    s3 = torch.minimum(lo_ab, lo_cd)
    mid_hi = torch.minimum(hi_ab, hi_cd)
    mid_lo = torch.maximum(lo_ab, lo_cd)
    return s0, torch.maximum(mid_hi, mid_lo), torch.minimum(mid_hi, mid_lo), s3


def _fraction_ranks(fa, fb, fc, fd):
    """Descending rank (0 = largest) of each fraction, with the reference's
    tie-breaking: y beats x iff f_y > f_x strictly, or f_y == f_x and y is
    the later letter (ref: sr/4_test_lut.py:148-231)."""
    cab = (fa > fb).to(torch.int32)
    cac = (fa > fc).to(torch.int32)
    cad = (fa > fd).to(torch.int32)
    cbc = (fb > fc).to(torch.int32)
    cbd = (fb > fd).to(torch.int32)
    ccd = (fc > fd).to(torch.int32)
    rank_a = 3 - cab - cac - cad
    rank_b = 2 + cab - cbc - cbd
    rank_c = 1 + cac + cbc - ccd
    rank_d = cad + cbd + ccd
    return rank_a, rank_b, rank_c, rank_d


def corner_lams_t(fa, fb, fc, fd, *, interval: int = 4) -> torch.Tensor:
    """Weights of all 16 hypercube corners, corner-major: (16, *fa.shape)
    float32.

    lam[m] = w_popcount(m) if corner mask m equals the set of dims whose
    fraction ranks above popcount(m), else 0 — the branchless form of the
    reference's corner selection.  Exact in f32 (integers <= 2**interval).
    """
    q = 2 ** interval
    s0, s1, s2, s3 = _sorted_fractions(fa, fb, fc, fd)
    w = torch.stack([q - s0, s0 - s1, s1 - s2, s2 - s3, s3]).to(torch.float32)
    ranks = _fraction_ranks(fa, fb, fc, fd)
    dev = fa.device
    col = (16,) + (1,) * fa.ndim
    kk = torch.as_tensor(_CORNER_BITS.sum(1), device=dev)      # (16,)
    ok = None
    for x, r in enumerate(ranks):
        want = torch.as_tensor(_CORNER_BITS[:, x] == 1, device=dev)
        cond = (r.unsqueeze(0) < kk.view(col)) == want.view(col)
        ok = cond if ok is None else ok & cond
    return torch.where(ok, w[kk], 0.0)


def corner_lams(fa, fb, fc, fd, *, interval: int = 4) -> torch.Tensor:
    """`corner_lams_t` with the corner axis last: (*fa.shape, 16) float32."""
    return torch.movedim(corner_lams_t(fa, fb, fc, fd, interval=interval),
                         0, -1)


def _base_and_fracs(planes, *, interval: int):
    """Flat (N,) LUT base index and the four LSB fractions."""
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1
    a, b, c, d = (p.reshape(-1) for p in planes)
    base = (((a // q) * L + b // q) * L + c // q) * L + d // q
    return base, (a % q, b % q, c % q, d % q)


def simplex_planes_quad_int(luts4, planes4, *, v: int, interval: int = 4):
    """All 4 rotations of a NON-symmetric mode, rotation-summed.

    Each rotation gathers its own rows (its taps read different pixels);
    the four per-rotation contractions accumulate into one (N, v) buffer
    in integer-valued f32.

    Args:
      luts4: four (L**4, 16 * v) expanded tables (the same shared table
        repeated 4x for v == 1, where no lane permutation exists).
      planes4: sequence over rotations of four (..., h, w) int32 tap planes.
      v: output lanes per pixel.

    Returns:
      (..., h, w, v) int32 rotation-summed accumulator.
    """
    lead = planes4[0][0].shape
    out = None
    for r in range(4):
        base, fr = _base_and_fracs(planes4[r], interval=interval)
        lam = corner_lams(*fr, interval=interval)             # (N, 16)
        g = luts4[r].index_select(0, base)                    # (N, 16*v)
        g = g.reshape(-1, 16, v).to(torch.float32)
        o = (lam.unsqueeze(-1) * g).sum(1)                    # (N, v)
        out = o if out is None else out + o
    return out.to(torch.int32).reshape(*lead, v)
