"""4-D simplex (tetrahedral) interpolation over MuLUT tables: the exact
integer path of deployment and the differentiable path of LUT fine-tuning.

The reference selects one of 24 corner/weight assignments per pixel through
a chain of masked branches (ref: sr/4_test_lut.py:148-231).  Here the
weights are the adjacent differences of the descending-sorted fractions
(a 5-comparator network) and the corners follow from the fractions' ranks,
which carry the reference's tie-breaking; both are branchless tensor code.

Conventions: LUTs are flat (L**4, v) tables indexed a*L^3 + b*L^2 + c*L + d
(ref: sr/model.py:128); images are (..., H, W) int32 with values in
[0, 255].  Weighted sums are integer-valued float32 below 2**24, so every
summation order is exact.

The differentiable path (`simplex_planes_diff`,
`simplex_planes_expanded_diff`, `expand_weight`; ref: sr/model.py:69-287)
drives STE fine-tuning: gradients flow into the LUT entries through the
corner gathers and into the input through the fractional weights.  Its
forward values reproduce the JAX package's jitted arithmetic, and
`round_ste`, `clip` and `div_add` give the gradients JAX's autodiff gives.

Torch twin of `mulut_tpu.ops.simplex`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import simplex_tables
from .taps import mode_pad, mode_taps

_WEIGHT_COEFFS = simplex_tables.weight_coeffs()  # (64, 5, 5) int32

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


def _take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `table` at `idx`, clamped into range (`jnp.take(...,
    mode="clip")`)."""
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def _lehmer_code(fa, fb, fc, fd):
    """Bijective 0..23 code of the descending fraction-rank permutation.

    Must match `simplex_tables.lehmer_of_ranks` (the rank tables' row
    order); ranks carry the reference's tie-breaking via `_fraction_ranks`.
    """
    ra, rb, rc, rd = _fraction_ranks(fa, fb, fc, fd)
    l2 = rb - (rb > ra).to(torch.int32)
    l3 = rc - (rc > ra).to(torch.int32) - (rc > rb).to(torch.int32)
    return ra * 6 + l2 * 2 + l3


def sorted_weights(fa, fb, fc, fd, *, interval: int = 4) -> torch.Tensor:
    """The 5 simplex weights in rank order, (..., 5) float32:
    (q - s0, s0 - s1, s1 - s2, s2 - s3, s3) over the descending-sorted
    fractions, the weight multiset of every one of the reference's 24
    branches (ref: sr/4_test_lut.py:148-231)."""
    return torch.movedim(sorted_weights_t(fa, fb, fc, fd, interval=interval),
                         0, -1)


def sorted_weights_t(fa, fb, fc, fd, *, interval: int = 4) -> torch.Tensor:
    """`sorted_weights` with the weight axis first: (5, *fa.shape)."""
    q = 2 ** interval
    s0, s1, s2, s3 = _sorted_fractions(fa, fb, fc, fd)
    return torch.stack([q - s0, s0 - s1, s1 - s2, s2 - s3, s3]).to(
        torch.float32)


def simplex_planes_int(lut, planes, *, interval: int = 4):
    """Exact integer 4-D simplex interpolation over four tap planes, from
    the raw table: five corner gathers per site, picked by the 6-bit
    comparison code (`simplex_tables.corner_offsets`).

    Args:
      lut: (L**4, v) int32 table (int8 values widened).
      planes: four (..., h, w) int32 tensors in [0, 255].

    Returns:
      (..., h, w, v) int32 accumulator (q x the reference's float output),
      lanes not interleaved.
    """
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1
    a, b, c, d = planes
    fa, fb, fc, fd = a % q, b % q, c % q, d % q
    base = (((a // q) * L + b // q) * L + c // q) * L + d // q
    offs_t, _ = _tables(L)
    offs = torch.as_tensor(offs_t, device=base.device)[
        _comparison_code(fa, fb, fc, fd)]                 # (..., h, w, 5)
    s0, s1, s2, s3 = _sorted_fractions(fa, fb, fc, fd)
    weights = (q - s0, s0 - s1, s1 - s2, s2 - s3, s3)
    v = lut.shape[1]
    out = None
    for k in range(5):
        idx = (base + offs[..., k]).reshape(-1)
        rows = lut.index_select(0, idx).reshape(*base.shape, v)
        term = weights[k][..., None] * rows
        out = term if out is None else out + term
    return out


def _contract_rows(lam, g, terms: int, width: int):
    """sum_k lam[n, k] * g[n, k*width + j] in float32 (integer values below
    2**24: exact in any order) -> (N, width) int32."""
    g = g.reshape(-1, terms, width).to(torch.float32)
    return torch.einsum("nk,nkv->nv", lam, g).to(torch.int32)


def simplex_planes_expanded_int(elut, planes, *, v: int, interval: int = 4):
    """Single-gather integer simplex interpolation over a corner-expanded
    (L**4, 16 * v) int8 table (`simplex_tables.expand_lut`): the five
    simplex corners are picked out of the 16 by `corner_lams`.

    Returns (..., h, w, v) int32 accumulator (q x the reference's float
    output).
    """
    lead = planes[0].shape
    base, fr = _base_and_fracs(planes, interval=interval)
    lam = corner_lams(*fr, interval=interval)            # (N, 16)
    out = _contract_rows(lam, _take_clip(elut, base), 16, v)
    return out.reshape(*lead, v)


def simplex_planes_folded_int(flut, planes, *, v: int, interval: int = 4):
    """Rotation-folded single-gather simplex interpolation over a
    (L**4, 16 * 4 * v) table (`simplex_tables.fold_lut`): the four
    rotations of a 90-degree-symmetric tap pattern share one gather and
    one weight computation.

    Args:
      planes: four (..., h, w) int32 rotation-0 tap planes over the
        extended window range (see
        `ensemble.rotation_ensemble_lanes_folded_int`).

    Returns:
      (..., h, w, 4, v) int32 per-rotation accumulators; rotation r's
      plane still needs its static spatial un-shift before summing.
    """
    lead = planes[0].shape
    base, fr = _base_and_fracs(planes, interval=interval)
    lam = corner_lams(*fr, interval=interval)            # (N, 16)
    out = _contract_rows(lam, _take_clip(flut, base), 16, 4 * v)
    return out.reshape(*lead, 4, v)


def _rank_rows(rtab, fr):
    """Rows of a rank-expanded table at `lehmer(ranks) * L**4 + base`."""
    return _lehmer_code(*fr) * (rtab.shape[0] // 24)


def simplex_planes_rank_folded_int(rflut, planes, *, v: int,
                                   interval: int = 4):
    """Rank-expanded rotation-folded interpolation over
    `simplex_tables.rank_fold_lut` rows: the row at
    `lehmer(ranks) * L**4 + base` holds the 5 simplex-chain corners of all
    4 rotations (zero term blocks may pad it), contracted with the
    sorted-difference weights.

    Returns (..., h, w, 4, v) int32 per-rotation accumulators.
    """
    lead = planes[0].shape
    terms = rflut.shape[1] // (4 * v)  # >= 5: rows may be tile-padded
    base, fr = _base_and_fracs(planes, interval=interval)
    lam = torch.nn.functional.pad(sorted_weights(*fr, interval=interval),
                                  (0, terms - 5))
    g = _take_clip(rflut, _rank_rows(rflut, fr) + base)
    return _contract_rows(lam, g, terms, 4 * v).reshape(*lead, 4, v)


def simplex_planes_rank_quad_int(rluts4, planes4, *, v: int,
                                 interval: int = 4):
    """Rank-expanded per-rotation interpolation for non-symmetric modes:
    each rotation gathers with its own base and rank code from its own
    (L**4 * 24, 5 * v) table; the rotation sum happens in the accumulator.
    Returns (..., h, w, v) int32."""
    lead = planes4[0][0].shape
    out = None
    for r in range(4):
        base, fr = _base_and_fracs(planes4[r], interval=interval)
        lam = sorted_weights(*fr, interval=interval)
        g = _take_clip(rluts4[r], _rank_rows(rluts4[r], fr) + base)
        o = _contract_rows(lam, g, 5, v)
        out = o if out is None else out + o
    return out.reshape(*lead, v)


def simplex_interp_int(lut, img, *, mode: str, upscale: int,
                       interval: int = 4):
    """Single-pattern integer simplex interpolation on a padded image.

    Args:
      lut: (L**4, upscale**2) int32 table (int8 values widened).
      img: (..., h + pad, w + pad) int32 image in [0, 255], already
        replicate-padded on the bottom/right by `mode_pad(mode)`.

    Returns:
      (..., h*upscale, w*upscale) int32 accumulator (q x the reference's
      float output).
    """
    pad = mode_pad(mode)
    h = img.shape[-2] - pad
    w = img.shape[-1] - pad
    planes = _tap_planes(img, mode, h, w)
    out = simplex_planes_int(lut, planes, interval=interval)
    return _interleave(out, upscale)


def reference_oracle_int(lut, img, *, mode: str, upscale: int,
                         interval: int = 4):
    """Slow, independent NumPy oracle used only by tests: per pixel, the
    strict-comparison decision chain through the host tables and the five
    weighted corners, in Python loops."""
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1
    pad = mode_pad(mode)
    h = img.shape[-2] - pad
    w = img.shape[-1] - pad
    taps = mode_taps(mode)
    v = upscale * upscale
    offs = simplex_tables.corner_offsets(L)
    coeffs = simplex_tables.weight_coeffs()

    lead = img.shape[:-2]
    out = np.zeros(lead + (h, w, v), dtype=np.int64)
    for index in np.ndindex(*lead):
        for i in range(h):
            for j in range(w):
                px = [int(img[index + (i + dy, j + dx)]) for dy, dx in taps]
                msb = [p // q for p in px]
                f = [p % q for p in px]
                basev = ((msb[0] * L + msb[1]) * L + msb[2]) * L + msb[3]
                codev = simplex_tables.comparison_code(
                    np.int64(f[0]), np.int64(f[1]), np.int64(f[2]),
                    np.int64(f[3]))
                wts = coeffs[codev] @ np.array([q] + f, dtype=np.int64)
                acc = np.zeros(v, dtype=np.int64)
                for k in range(5):
                    acc += wts[k] * lut[basev + offs[codev, k]]
                out[index + (i, j)] = acc
    out = out.reshape(lead + (h, w, upscale, upscale))
    out = np.moveaxis(out, -2, -3).reshape(lead + (h * upscale, w * upscale))
    return out


# ---------------------------------------------------------------------------
# The differentiable path (STE fine-tuning)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tables(L: int):
    """NumPy decision tables: corner offsets (64, 5) and weight
    coefficients (64, 5, 5), as in the JAX package."""
    offs = simplex_tables.corner_offsets(L)  # (64, 5) int32
    coeffs = _WEIGHT_COEFFS                  # (64, 5, 5) int32
    return offs, coeffs


def _comparison_code(fa, fb, fc, fd):
    """6-bit code from strict pairwise comparisons (bit layout of tables),
    int64 (an index)."""
    code = (fa > fb).to(torch.int64) * 32
    code += (fa > fc).to(torch.int64) * 16
    code += (fa > fd).to(torch.int64) * 8
    code += (fb > fc).to(torch.int64) * 4
    code += (fb > fd).to(torch.int64) * 2
    code += (fc > fd).to(torch.int64)
    return code


def _tap_planes(img, mode: str, h: int, w: int):
    """The four sampled pixel planes (a, b, c, d), each (..., h, w)."""
    return [img[..., dy: dy + h, dx: dx + w] for dy, dx in mode_taps(mode)]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with straight-through gradient (ref: sr/model.py:59-67); the
    value is exactly torch.round(x)."""
    return x + (torch.round(x) - x).detach()


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with JAX's gradient: 1 inside, 1/2 on a bound, 0 outside
    (`torch.clamp` passes all of it on a bound; LUT entries sit on +-127
    and dark outputs on 0, so the difference shows)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def div_add(x: torch.Tensor, n: int, bias: float) -> torch.Tensor:
    """`x / n + bias` as XLA computes it under jit: one fused multiply-add
    fma(x, float32(1/n), bias), rounded once to float32 (exact on the
    integer-valued accumulators it takes; a true division rounds ties of
    a later round() the other way).  The gradient is the plain
    expression's, `float32(1/n)` per unit, as XLA's rewritten `g / n`."""
    c = float(np.float32(1.0 / n))
    plain = x * c + bias
    exact = (x.to(torch.float64) * c + bias).to(x.dtype)
    return plain + (exact - plain).detach()


def simplex_planes_diff(w127, planes, *, interval: int = 4):
    """Differentiable simplex interpolation over four tap planes.

    Args:
      w127: (L**4, v) float32 LUT already re-quantized to int8 levels with
        STE (round(weight*127) -> clamp(-127, 127)); gradients flow into it
        through the 5 corner gathers and into the planes through the
        fractional weights.
      planes: four (..., h, w) float32 tensors in [0, 255].

    Returns:
      (..., h, w, v) float32 (already divided by q), lanes not interleaved.
    """
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1

    msb = [torch.floor(p / q).to(torch.int64) for p in planes]
    fa, fb, fc, fd = (p % q for p in planes)

    base = ((msb[0] * L + msb[1]) * L + msb[2]) * L + msb[3]
    code = _comparison_code(fa.detach(), fb.detach(), fc.detach(),
                            fd.detach())
    offs_t, _ = _tables(L)
    offs = torch.as_tensor(offs_t, device=base.device).to(torch.int64)[code]

    # Sorted-fraction weights; each weight's gradient flows to the
    # fraction it came from (ref: sr/model.py:199-282).
    s0, s1, s2, s3 = _sorted_fractions(fa, fb, fc, fd)
    weights = (q - s0, s0 - s1, s1 - s2, s2 - s3, s3)

    v = w127.shape[1]
    out = None
    for k in range(5):
        idx = base + offs[..., k]
        rows = w127.index_select(0, idx.reshape(-1)).reshape(*idx.shape, v)
        term = weights[k][..., None] * rows
        out = term if out is None else out + term
    return out / q


def _shift_fwd(x, axis):
    """(S x) along a digit axis: out[i] = x[min(i+1, L-1)]."""
    L = x.shape[axis]
    return torch.cat([x.narrow(axis, 1, L - 1), x.narrow(axis, L - 1, 1)],
                     dim=axis)


def _shiftT(x, axis):
    """(S^T x) along a digit axis: out[j] = x[j-1] (+ x[L-1] at j = L-1)."""
    L = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    last = x.narrow(axis, L - 2, 1) + x.narrow(axis, L - 1, 1)
    return torch.cat([zero, x.narrow(axis, 0, L - 2), last], dim=axis)


class _ExpandWeight(torch.autograd.Function):
    """Differentiable corner expansion: (L**4, v) -> (L**4, 16*v).

    Corner mask m's rows are `w[min(digits + bits(m), L-1)]`, i.e.
    (S (x) S (x) S (x) S) w with the per-digit shift matrix
    S[i, j] = [j == min(i+1, L-1)] applied on m's bit dims.  The forward
    builds all 16 corners in 4 doubling steps (one shifted copy per digit
    dim); the backward folds the 4 bit axes with the transposed shift
    (shift-down + accumulate-into-the-last-bin), innermost bit first, as
    the JAX package's custom VJP does (`_expand_weight_bwd`).  Slices and
    adds only: autograd's backward of the 16-corner gather would be a
    scatter-add into every row, which dominated the fine-tune step on the
    TPU (the JAX docstring's measurement).
    """

    @staticmethod
    def forward(ctx, w127, interval):
        L = 2 ** (8 - interval) + 1
        L4, v = w127.shape
        ctx.dims = (L, L4, v)
        x = w127.reshape(L, L, L, L, v)
        for d in range(4):
            # insert bit axis for digit d after the existing bit axes
            x = torch.stack([x, _shift_fwd(x, d)], dim=4 + d)
        return x.reshape(L4, 16 * v)

    @staticmethod
    def backward(ctx, de):
        L, L4, v = ctx.dims
        g = de.reshape(L, L, L, L, 2, 2, 2, 2, v)
        for d in (3, 2, 1, 0):  # fold innermost bit axis first
            bit_axis = 4 + d
            g = g.select(bit_axis, 0) + _shiftT(g.select(bit_axis, 1), d)
        return g.reshape(L4, v), None


def expand_weight(w127: torch.Tensor, *, interval: int = 4) -> torch.Tensor:
    """Differentiable corner expansion (L**4, v) -> (L**4, 16*v); see
    `_ExpandWeight` for the math and the custom backward."""
    return _ExpandWeight.apply(w127, interval)


def simplex_planes_expanded_diff(e127, planes, *, v: int, interval: int = 4):
    """Differentiable single-gather simplex interpolation.

    `e127` is the differentiably-expanded float table from `expand_weight`,
    so the five corner gathers and their five backward scatters collapse
    into one wide row gather per tapset.  Forward values equal
    `simplex_planes_diff`'s (all addends are integer-valued floats below
    2**24, so float32 summation order is irrelevant).

    Args:
      e127: (L**4, 16 * v) float32 expanded table.
      planes: four (..., h, w) float32 tap planes in [0, 255].

    Returns:
      (..., h, w, v) float32 (already divided by q), lanes not interleaved.
    """
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1

    lead = planes[0].shape
    flat = [p.reshape(-1) for p in planes]
    fa, fb, fc, fd = (p % q for p in flat)
    msb = [torch.floor(p / q).to(torch.int64) for p in flat]
    base = ((msb[0] * L + msb[1]) * L + msb[2]) * L + msb[3]

    s0, s1, s2, s3 = _sorted_fractions(fa, fb, fc, fd)
    w = (q - s0, s0 - s1, s1 - s2, s2 - s3, s3)
    ranks = _fraction_ranks(fa.detach(), fb.detach(), fc.detach(),
                            fd.detach())
    lt = {x: [None] + [(r < k) for k in (1, 2, 3)] + [None]
          for x, r in zip("abcd", ranks)}

    g = e127.index_select(0, base).reshape(-1, 16, v)

    lams = []
    for m in range(16):
        bits = _CORNER_BITS[m]
        k = int(bits.sum())
        used = None
        for x, bit in zip("abcd", bits):
            if k in (0, 4):
                continue
            cond = lt[x][k] if bit else ~lt[x][k]
            used = cond if used is None else used & cond
        lams.append(w[k] if used is None else torch.where(used, w[k], 0.0))
    lam = torch.stack(lams, dim=-1)                       # (N, 16) f32
    out = torch.einsum("nm,nmv->nv", lam, g) / q
    return out.reshape(*lead, v)


def simplex_interp_diff(weight, img, *, mode: str, upscale: int,
                        interval: int = 4):
    """Differentiable simplex interpolation for STE LUT fine-tuning.

    Args:
      weight: (L**4, upscale**2) float32 trainable LUT (values ~ [-1, 1]).
      img: (..., h + pad, w + pad) float32, values in [0, 255], already
        replicate-padded on the bottom/right by `mode_pad(mode)`.

    Returns:
      (..., h*upscale, w*upscale) float32, the torch fine-tune path (ref:
      sr/model.py:69-287) including the weight re-quantization
      round(weight*127) -> clamp(-127, 127) with straight-through gradients.
    """
    pad = mode_pad(mode)
    h = img.shape[-2] - pad
    w = img.shape[-1] - pad
    w127 = clip(round_ste(weight * 127.0), -127.0, 127.0)
    planes = _tap_planes(img, mode, h, w)
    out = simplex_planes_diff(w127, planes, interval=interval)
    return _interleave(out, upscale)
