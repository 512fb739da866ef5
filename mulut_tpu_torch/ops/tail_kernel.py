"""The packed LUT cascade, with its CUDA kernels.

Torch twin of `mulut_tpu.ops.tail_kernel`.  Every contraction of the
cascade (both stages, every mode and rotation, over 16-corner, folded,
rank and per-rotation tables) runs the window-read simplex contraction
(`window_fold_contract`, csrc/window_fold.cu): it reads the edge-padded
plane at the mode's taps and builds the base index, the rank code, the
simplex weights and the five live corners of each site itself.  The final
stage's rotation un-shifts, quad-lane un-rotation, exact stage mix,
PixelShuffle interleave and uint8 packing run in one pass of
`tail_assemble` (csrc/tail_assemble.cu).  The output is packed 32-bit words
whose bytes are the row-major uint8 image (`unpack_u32`), byte-identical
to the JAX package (ref behavior: sr/4_test_lut.py:263-306).  The JAX
boundary's form of the contraction, `gather_fold_contract` over a base
index and (C, N) weights (csrc/fold_contract.cu, C = 16 or the rank
tables' 5, 6 and 8), stays for callers that hold those.

Each kernel wrapper runs its plain torch version when given CPU tensors
and launches the kernel when given CUDA tensors; it never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import ensemble as ens
from . import simplex as sx
from ._build import library
from .taps import (
    fold_geometry,
    lane_rotation_perm,
    mode_pad,
    mode_taps,
    rotated_taps,
)

_MAX_MODES = 6          # csrc/tail_assemble.cu MULUT_MAX_MODES
_WINDOW_LANES = (1, 4, 8, 9, 16, 36, 64)

#: Kernel launches per wrapper (CUDA launches only; the plain CPU versions
#: do not count).  A run resets them to 0 to show which kernels it used.
LAUNCHES = {"gather_fold_contract": 0, "window_fold_contract": 0,
            "tail_assemble": 0}


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def _pad_ragged(img, pad: int, extra_cols: int):
    return ens._edge_pad(img, (pad, pad), (pad, pad + extra_cols))


def _pad8_base_fracs(base, fr):
    """Append the 8 junk sites of the contraction buffers at the index/frac
    level.  Junk sites gather row 0 and get the frac-0 weight vector; no
    consumer reads them."""
    return F.pad(base, (0, 8)), tuple(F.pad(f, (0, 8)) for f in fr)


def _check_device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# K1: gather + weighted group-fold contraction
# ---------------------------------------------------------------------------

#: (C, u) instances of csrc/fold_contract.cu: 16-corner rows at the u's of
#: the cascade's 16-corner tables, and rank rows (C = 5, or 6 and 8 for the
#: tile-padded rank-folded rows of x4 and x2) at theirs.
_FOLD_INSTANCES = frozenset([(16, 4), (16, 8), (16, 16), (16, 64), (5, 4),
                             (5, 9), (5, 16), (5, 36), (6, 64), (8, 16)])


def gather_fold_contract_plain(tab, base, wt, *, C: int, u: int):
    """Plain torch version of `gather_fold_contract` (same contract)."""
    g = tab.index_select(0, base.clamp(0, tab.shape[0] - 1))   # (Np, C*u)
    acc = None
    for c in range(C):
        term = wt[c].unsqueeze(1) * g[:, c * u:(c + 1) * u].to(torch.float32)
        acc = term if acc is None else acc + term
    return acc.T.contiguous()


@functools.cache
def _fold_fn():
    fn = library("fold_contract").gather_fold_contract
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_fold_contract(tab, base, wt, *, C: int, u: int):
    """(u, Np) f32: out[j, n] = sum_c wt[c, n] * tab[base[n], c*u + j].

    The TPU form is `fold_contract(jnp.take(tab, base), wt)`; here the row
    gather is fused into the kernel.  tab (R, C*u) int8: 16-corner rows
    with `corner_lams_t` weights (C=16) or rank rows with `sorted_weights_t`
    weights zero-padded to C (C = 5, 6, 8); base (Np,) int32 (clamped into
    [0, R), as jnp.take(mode="clip")); wt (C, Np) float32 integer weights
    <= 2**interval.  All sums are integers below 2**24, so the result is
    exact.
    """
    Np = base.shape[0]
    if tab.dim() != 2 or tab.shape[1] != C * u or tab.dtype != torch.int8:
        raise ValueError(f"tab must be (R, {C * u}) int8, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if base.dim() != 1 or base.dtype != torch.int32:
        raise ValueError("base must be a 1-D int32 tensor")
    if wt.shape != (C, Np) or wt.dtype != torch.float32:
        raise ValueError(f"wt must be ({C}, {Np}) float32, got "
                         f"{tuple(wt.shape)} {wt.dtype}")
    dev = _check_device(tab, base, wt)
    if dev.type == "cpu":
        return gather_fold_contract_plain(tab, base, wt, C=C, u=u)
    if (C, u) not in _FOLD_INSTANCES:
        raise ValueError(f"the CUDA kernel takes (C, u) in "
                         f"{sorted(_FOLD_INSTANCES)}; got C={C}, u={u}")
    if not (tab.is_contiguous() and base.is_contiguous()
            and wt.is_contiguous()):
        raise ValueError("gather_fold_contract needs contiguous inputs")
    # the kernel's row loads: 16 bytes, 4 or 1 by what the row width keeps
    align = 16 if C * u % 16 == 0 else (4 if C * u % 4 == 0 else 1)
    if tab.data_ptr() % align:
        raise ValueError(f"tab must be {align}-byte aligned")
    out = torch.empty((u, Np), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fold_fn()(
            tab.data_ptr(), base.data_ptr(), wt.data_ptr(), out.data_ptr(),
            Np, tab.shape[0], C, u, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather_fold_contract: CUDA error {err}")
    LAUNCHES["gather_fold_contract"] += 1
    return out


# ---------------------------------------------------------------------------
# K1, redesigned: the window-read simplex contraction
# ---------------------------------------------------------------------------


class _WindowDesc(ctypes.Structure):
    """Mirror of `WindowDesc` in csrc/window_fold.cu (same field order)."""

    _fields_ = [
        ("tap", (ctypes.c_longlong * 4) * 4),
        ("n_sites", ctypes.c_longlong),
        ("pitch", ctypes.c_longlong),
        ("rot_stride", ctypes.c_longlong),
        ("n_rot", ctypes.c_int),
        ("he", ctypes.c_int),
        ("we", ctypes.c_int),
        ("hp", ctypes.c_int),
        ("wp", ctypes.c_int),
        ("oy", ctypes.c_int),
        ("ox", ctypes.c_int),
        ("interval", ctypes.c_int),
        ("L", ctypes.c_int),
        ("n_rows", ctypes.c_int),
        ("n_base", ctypes.c_int),
    ]


@functools.cache
def _window_fn():
    fn = library("window_fold").window_fold_contract
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(_WindowDesc), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _window_planes(xp, taps, origin, grid):
    """Per rotation, the four (lead, he, we) tap planes of the sites."""
    (oy, ox), (he, we) = origin, grid
    return [[xp[:, oy + dy: oy + dy + he, ox + dx: ox + dx + we]
             for dy, dx in rt] for rt in taps]


def window_base_fracs(xp, *, taps, origin, grid, interval: int):
    """Per rotation, the (Np+8,) base index and four fracs of the sites, the
    8 junk sites appended: the inputs the JAX boundary
    (`gather_fold_contract` with `corner_lams_t` weights) takes."""
    return [_pad8_base_fracs(*sx._base_and_fracs(planes, interval=interval))
            for planes in _window_planes(xp, taps, origin, grid)]


def table_terms(tab, *, u: int, interval: int):
    """(terms C, rank) of a contraction table read at u lanes: C = 16 for
    16-corner rows (L**4 of them), C >= 5 for rank rows (24 * L**4, row
    `lehmer * L**4 + base`); per-rotation tables stack on a leading axis.
    Raises ValueError for any other shape."""
    L4 = (2 ** (8 - interval) + 1) ** 4
    rows, width = (tab.shape[-2], tab.shape[-1]) if tab.dim() >= 2 else (0, 0)
    if tab.dim() in (2, 3) and width % u == 0:
        if rows == L4 and width == 16 * u:
            return 16, False
        if rows == 24 * L4 and width // u >= 5:
            return width // u, True
    raise ValueError(
        f"tab must be an int8 16-corner ({L4}, {16 * u}) table (C=16), a "
        f"rank ({24 * L4}, C*{u}) table (C >= 5), or such tables stacked "
        f"per rotation; got {tuple(tab.shape)} {tab.dtype}")


def boundary_inputs(tab, base, fr, *, u: int, interval: int):
    """The JAX boundary's (row index, (C, N) weights, C) of one rotation's
    sites: `base` and `corner_lams_t` for 16-corner rows; for rank rows
    `lehmer * L**4 + base` and `sorted_weights_t` zero-padded to C, as the
    TPU's `_contract` (tail_kernel.py:218) builds them."""
    C, rank = table_terms(tab, u=u, interval=interval)
    if not rank:
        return base, sx.corner_lams_t(*fr, interval=interval), C
    wt = F.pad(sx.sorted_weights_t(*fr, interval=interval), (0, 0, 0, C - 5))
    return sx._lehmer_code(*fr) * (tab.shape[-2] // 24) + base, wt, C


def window_fold_contract_plain(tab, xp, *, taps, origin, grid,
                               interval: int, u: int):
    """Plain torch version of `window_fold_contract` (same contract): the
    tap-plane slices, `simplex._base_and_fracs`, the weights and row index
    of the table's format (`boundary_inputs`) and
    `gather_fold_contract_plain`; for u == 1 the rotation-summed
    `simplex.simplex_planes_quad_int`."""
    if u == 1:
        planes4 = _window_planes(xp, taps, origin, grid)
        return sx.simplex_planes_quad_int(
            [tab] * 4, planes4, v=1, interval=interval).reshape(-1)
    outs = []
    for r, (base, fr) in enumerate(window_base_fracs(
            xp, taps=taps, origin=origin, grid=grid, interval=interval)):
        t = tab[r] if tab.dim() == 3 else tab
        idx, wt, C = boundary_inputs(t, base, fr, u=u, interval=interval)
        outs.append(gather_fold_contract_plain(t, idx, wt, C=C, u=u))
    return torch.stack(outs)


def window_fold_contract(tab, xp, *, taps, origin, grid, interval: int,
                         u: int):
    """Simplex contraction of a grid of sites read from an edge-padded
    plane, per rotation.

    xp: (lead, Hp, Wp) int32 plane with values in [0, 255]; taps: R <= 4
    rotations' four (dy, dx) tap offsets; site (b, y, x) of the
    (lead, he, we) `grid` reads xp[b, oy + y + dy, ox + x + dx] with
    `origin` (oy, ox).  L = 2**(8-interval) + 1.

    For u in (4, 8, 9, 16, 36, 64), tab is int8: a 16-corner (L**4, 16*u)
    table, a rank (24 * L**4, C*u) table (C >= 5, row `lehmer * L**4 +
    base`; `simplex_tables.rank_fold_lut` / `rank_expand_shared`), or R
    such tables stacked per rotation (`rank_expand_rotations`, the
    16-corner per-rotation copies).  Returns (R, u, Np+8) float32, Np =
    lead*he*we: rotation r's `gather_fold_contract` on the row index and
    weights of `boundary_inputs`, the 8 junk sites (base 0, fracs 0)
    appended.  For u == 1, tab is the (L**4, 16) int8 or int32
    inner-stage table and R == 4; returns the rotations' sum as (Np,)
    int32, the bytes of `ensemble.rotation_ensemble_lanes_quad_int`.  All
    sums are integers below 2**24, so the result is exact.
    """
    taps = tuple(tuple((int(dy), int(dx)) for dy, dx in rt) for rt in taps)
    if not 1 <= interval <= 8:
        raise ValueError(f"interval must be in 1..8, got {interval}")
    L = 2 ** (8 - interval) + 1
    if u not in _WINDOW_LANES:
        raise ValueError(f"u must be one of {_WINDOW_LANES}, got {u}")
    if u == 1:
        if (tab.dim() != 2 or tuple(tab.shape) != (L ** 4, 16)
                or tab.dtype not in (torch.int8, torch.int32)):
            raise ValueError(
                f"tab must be the ({L ** 4}, 16) int8 or int32 inner-stage "
                f"table (C=16), got {tuple(tab.shape)} {tab.dtype}")
        rank = False
    else:
        _, rank = table_terms(tab, u=u, interval=interval)
        if tab.dtype != torch.int8:
            raise ValueError(f"tab must be int8, got {tab.dtype}")
    if xp.dim() != 3 or xp.dtype != torch.int32:
        raise ValueError(f"xp must be a (lead, Hp, Wp) int32 plane, got "
                         f"{tuple(xp.shape)} {xp.dtype}")
    if (not 1 <= len(taps) <= 4 or any(len(rt) != 4 for rt in taps)
            or (u == 1 and len(taps) != 4)
            or (tab.dim() == 3 and tab.shape[0] != len(taps))):
        raise ValueError("taps must be 1 to 4 rotations (4 for u == 1, one "
                         "per table of a per-rotation stack) of four "
                         "(dy, dx) offsets each")
    (oy, ox), (he, we) = origin, grid
    hp, wp = xp.shape[1], xp.shape[2]
    if he < 1 or we < 1:
        raise ValueError(f"empty site grid {grid}")
    for rt in taps:
        for dy, dx in rt:
            if (oy + dy < 0 or oy + dy + he > hp or ox + dx < 0
                    or ox + dx + we > wp):
                raise ValueError(
                    f"tap ({dy}, {dx}) from origin {origin} over a {he} x "
                    f"{we} grid leaves the {hp} x {wp} plane")
    dev = _check_device(tab, xp)
    if dev.type == "cpu":
        return window_fold_contract_plain(tab, xp, taps=taps, origin=origin,
                                          grid=grid, interval=interval, u=u)
    if not (tab.is_contiguous() and xp.is_contiguous()):
        raise ValueError("window_fold_contract needs contiguous inputs")
    if tab.data_ptr() % 16:
        raise ValueError("tab must be 16-byte aligned")
    n = xp.shape[0] * he * we
    d = _WindowDesc()
    for r, rt in enumerate(taps):
        for k, (dy, dx) in enumerate(rt):
            d.tap[r][k] = dy * wp + dx
    elem = tab.element_size()
    d.n_sites, d.n_rot = n, len(taps)
    d.pitch = tab.shape[-1] * elem
    d.rot_stride = tab.stride(0) * elem if tab.dim() == 3 else 0
    d.he, d.we, d.hp, d.wp, d.oy, d.ox = he, we, hp, wp, oy, ox
    d.interval, d.L, d.n_rows, d.n_base = (interval, L, tab.shape[-2],
                                           L ** 4)
    if u == 1:
        out = torch.empty((n,), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((len(taps), u, n + 8), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _window_fn()(xp.data_ptr(), tab.data_ptr(), out.data_ptr(),
                           ctypes.byref(d), u, int(rank), elem,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"window_fold_contract: CUDA error {err}")
    LAUNCHES["window_fold_contract"] += 1
    return out


def _plane(xp):
    """(..., Hp, Wp) padded image -> (lead, Hp, Wp) view."""
    return xp.reshape((-1,) + tuple(xp.shape[-2:]))


def stage1_fold_k128(tab, img, *, mode: str, interval: int):
    """Inner-stage (v == 1) rotation ensemble of a symmetric mode over a
    (L**4, 128) int8 k128 table: one window contraction (u=8) yields the
    per-rotation extended-plane values (rows 4..7 zero); the rotation
    un-shifts are 1-D shifted slice adds.  Returns the rotation-summed
    (..., h, w) f32 accumulator (integer-valued)."""
    geo = fold_geometry(mode)
    pad = mode_pad(mode)
    h, w = img.shape[-2], img.shape[-1]
    my = -min(s_[0] for s_, _ in geo)
    mx = -min(s_[1] for s_, _ in geo)
    he, we = h + my, w + mx
    xp = _pad_ragged(img, pad, 0)
    lead = tuple(xp.shape[:-2]) + (he, we)
    n_ext = math.prod(lead)
    ext = window_fold_contract(
        tab, _plane(xp), taps=(mode_taps(mode),), origin=(pad - my, pad - mx),
        grid=(he, we), interval=interval, u=8)[0]
    m_rows = n_ext - (my * we + mx)
    acc = None
    for r, ((sy, sx_), _) in enumerate(geo):
        d = (sy + my) * we + (sx_ + mx)
        piece = ext[r, d: d + m_rows]
        acc = piece if acc is None else acc + piece
    acc = F.pad(acc, (0, n_ext - m_rows))
    return acc.reshape(lead)[..., :h, :w]


def stage1_quad_k128(tab, img, *, mode: str, interval: int):
    """Inner-stage (v == 1) rotation ensemble of a non-symmetric mode over
    a shared k128 table (corner m's value in lane m*8): each rotation
    reads its own taps and contracts to row 0 of its (8, N) output.
    Returns (..., h, w) f32 (integer-valued)."""
    pad = mode_pad(mode)
    h, w = img.shape[-2], img.shape[-1]
    xp = _pad_ragged(img, pad, 0)
    lead = tuple(xp.shape[:-2]) + (h, w)
    n = math.prod(lead)
    ext = window_fold_contract(
        tab, _plane(xp), taps=[rotated_taps(mode, r) for r in range(4)],
        origin=(pad, pad), grid=(h, w), interval=interval, u=8)
    acc = None
    for r in range(4):
        piece = ext[r, 0, :n]
        acc = piece if acc is None else acc + piece
    return acc.reshape(lead)


def folded_flat(flut, img, *, mode: str, v: int, interval: int):
    """Flat rotation-folded contraction of a 90-degree-symmetric mode.

    Evaluates the extended window plane with one extra junk row and a
    128-aligned width, like the TPU layout, so the tail's reads match it
    element for element.  Returns (ext (n_ext+8, 4v) f32 strided view,
    he, we, unshift offsets)."""
    geo = fold_geometry(mode)
    pad = mode_pad(mode) + 1
    h, w = img.shape[-2], img.shape[-1]
    my = -min(s_[0] for s_, _ in geo)
    mx = -min(s_[1] for s_, _ in geo)
    he = h + my + 1
    we = _pad128(w + mx)
    xp = _pad_ragged(img, pad, we - (w + mx))
    ext = window_fold_contract(
        flut, _plane(xp), taps=(mode_taps(mode),),
        origin=(pad - my, pad - mx), grid=(he, we), interval=interval,
        u=4 * v)[0].T
    offs = [(sy + my) * we + (sx_ + mx) for (sy, sx_), _ in geo]
    return ext, he, we, offs


def quad_flat(lut, img, *, mode: str, v: int, interval: int):
    """Flat per-rotation contractions of a non-symmetric mode over ONE
    shared un-permuted 16-corner (L**4, 16*v) table, in one launch.
    Returns ([four (N+8, v) f32 strided views in un-permuted lane order],
    wy), evaluated over h+1 rows x 128-aligned width."""
    pad = mode_pad(mode) + 1
    h, w = img.shape[-2], img.shape[-1]
    hy = h + 1
    wy = _pad128(w)
    xp = _pad_ragged(img, pad, wy - w)
    ext = window_fold_contract(
        lut, _plane(xp), taps=[rotated_taps(mode, r) for r in range(4)],
        origin=(pad, pad), grid=(hy, wy), interval=interval, u=v)
    return [ext[r].T for r in range(4)], wy


# ---------------------------------------------------------------------------
# K2: final-stage assembly
# ---------------------------------------------------------------------------


class _TailDesc(ctypes.Structure):
    """Mirror of `TailDesc` in csrc/tail_assemble.cu (same field order)."""

    _fields_ = [
        ("f_ptr", ctypes.c_void_p * _MAX_MODES),
        ("f_rs", ctypes.c_longlong * _MAX_MODES),
        ("f_ls", ctypes.c_longlong * _MAX_MODES),
        ("q_ptr", (ctypes.c_void_p * 4) * _MAX_MODES),
        ("q_rs", (ctypes.c_longlong * 4) * _MAX_MODES),
        ("q_ls", (ctypes.c_longlong * 4) * _MAX_MODES),
        ("f_he", ctypes.c_int * _MAX_MODES),
        ("f_we", ctypes.c_int * _MAX_MODES),
        ("f_off", (ctypes.c_int * 4) * _MAX_MODES),
        ("q_wy", ctypes.c_int * _MAX_MODES),
        ("nf", ctypes.c_int),
        ("nq", ctypes.c_int),
        ("bc", ctypes.c_int),
        ("h", ctypes.c_int),
        ("wp", ctypes.c_int),
        ("davg", ctypes.c_int),
        ("q_perm", ((ctypes.c_byte * 16) * 4) * _MAX_MODES),
    ]


@functools.cache
def _tail_fn():
    fn = library("tail_assemble").tail_assemble
    fn.argtypes = [ctypes.POINTER(_TailDesc), ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pack_u8(vi, *, bc: int, h: int, wp: int, scale: int):
    """(bc, h, wp, scale*scale) sub-pixel values in [0, 255] -> int32
    (bc*h, scale, wp) whose little-endian bytes are the row-major image."""
    q = vi.reshape(bc, h, wp, scale, scale).permute(0, 1, 3, 2, 4)
    b = q.to(torch.uint8).contiguous()                    # (bc, h, py, wp, px)
    return b.view(torch.int32).reshape(bc * h, scale, wp)


def tail_assemble_plain(folded, quads, *, bc: int, h: int, wp: int,
                        scale: int, davg: int):
    """Plain torch version of `tail_assemble` (same arguments, same
    bytes)."""
    v = scale * scale
    dev = (folded[0][0] if folded else quads[0][0][0]).device
    b = torch.arange(bc, device=dev).view(bc, 1, 1)
    y = torch.arange(h, device=dev).view(1, h, 1)
    x = torch.arange(wp, device=dev).view(1, 1, wp)
    acc = torch.zeros((bc, h, wp, v), dtype=torch.int32, device=dev)
    for outs, wy, perms in quads:
        site = (b * (h + 1) + y) * wy + x
        for r, o in enumerate(outs):
            lanes = torch.as_tensor(np.asarray(perms[r]), device=dev)
            acc += o.index_select(1, lanes)[site].to(torch.int32)
    for ext, he, we, offs in folded:
        for r, d_r in enumerate(offs):
            site = (b * he + y) * we + d_r + x
            acc += ext[:, r * v:(r + 1) * v][site].to(torch.int32)
    vi = ens.round_half_even_div(torch.clamp(acc, 0, 255 * davg), davg)
    return _pack_u8(vi, bc=bc, h=h, wp=wp, scale=scale)


def _check_buffer(t, lanes: int, max_site: int, what: str):
    if t.dim() != 2 or t.shape[1] != lanes or t.dtype != torch.float32:
        raise ValueError(f"{what} must be (N, {lanes}) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.shape[0] <= max_site:
        raise ValueError(f"{what} has {t.shape[0]} sites; the tail reads "
                         f"up to site {max_site}")


def tail_assemble(folded, quads, *, lead, h: int, w: int, scale: int,
                  davg: int):
    """Assemble the final stage from flat mode buffers.

    folded: list of (ext, he, we, offs) from `folded_flat`;
    quads: list of ([4 x (N+8, v) f32], wy, perms) from `quad_flat`.
    Returns int32 (prod(lead) * h, scale, wp) whose bytes equal the JAX
    kernel's packed u32 output — see `unpack_u32`.
    """
    if scale != 4:
        raise NotImplementedError("the packed tail is x4 only (4 sub-pixels "
                                  "per 32-bit word)")
    bc = math.prod(lead)
    v = scale * scale
    wp = _pad128(w)
    bufs = [f[0] for f in folded] + [o for q in quads for o in q[0]]
    if not bufs:
        raise ValueError("tail_assemble needs at least one mode")
    dev = _check_device(*bufs)
    for ext, he, we, offs in folded:
        if len(offs) != 4 or min(offs) < 0:
            raise ValueError("a folded mode has 4 non-negative rotation "
                             "offsets")
        _check_buffer(ext, 4 * v, ((bc - 1) * he + h - 1) * we + max(offs)
                      + wp - 1, "folded buffer")
    for outs, wy, perms in quads:
        if (len(outs) != 4 or wy < wp or len(perms) != 4
                or any(sorted(int(x) for x in p_) != list(range(v))
                       for p_ in perms)):
            raise ValueError("a quad mode has 4 rotation buffers, 4 lane "
                             "permutations and a row pitch of at least wp")
        for o in outs:
            _check_buffer(o, v, ((bc - 1) * (h + 1) + h - 1) * wy + wp - 1,
                          "quad buffer")
    if dev.type == "cpu":
        return tail_assemble_plain(folded, quads, bc=bc, h=h, wp=wp,
                                   scale=scale, davg=davg)
    if len(folded) > _MAX_MODES or len(quads) > _MAX_MODES:
        raise ValueError(f"the CUDA tail takes at most {_MAX_MODES} folded "
                         f"and {_MAX_MODES} quad modes")
    d = _TailDesc()
    for i, (ext, he, we, offs) in enumerate(folded):
        d.f_ptr[i] = ext.data_ptr()
        d.f_rs[i], d.f_ls[i] = ext.stride()
        d.f_he[i], d.f_we[i] = he, we
        for r in range(4):
            d.f_off[i][r] = offs[r]
    for i, (outs, wy, perms) in enumerate(quads):
        d.q_wy[i] = wy
        for r, o in enumerate(outs):
            d.q_ptr[i][r] = o.data_ptr()
            d.q_rs[i][r], d.q_ls[i][r] = o.stride()
            for vv in range(v):
                d.q_perm[i][r][vv] = int(perms[r][vv])
    d.nf, d.nq, d.bc, d.h, d.wp, d.davg = (len(folded), len(quads), bc, h,
                                           wp, int(davg))
    out = torch.empty((bc * h, scale, wp), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _tail_fn()(ctypes.byref(d), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tail_assemble: CUDA error {err}")
    LAUNCHES["tail_assemble"] += 1
    return out


def supports_tail_kernel(modes: str, scale: int, *,
                         interval: int = 4) -> bool:
    """The packed cascade covers x4 (4 sub-pixels per 32-bit word) on mode
    sets where every mode is 90-degree-symmetric (s/d/e) or not (y/h/o),
    at the intervals where `ensemble.prepare_expanded_luts` gives the
    non-symmetric modes one shared table (L <= 17: interval >= 4; below,
    the rank formats give way to per-rotation 16-corner copies)."""
    return (scale == 4 and interval >= 4
            and all(m in "sdeyho" for m in modes))


def lut_cascade_packed(tabs, img, *, stages: int, modes: str, scale: int,
                       interval: int = 4, valid_hw=None):
    """Full cascade with the final stage assembled by `tail_assemble`;
    returns packed int32 (B*C*h, scale, wp) — `unpack_u32` yields the
    uint8 image (byte view).

    `tabs` are `ensemble.prepare_expanded_luts(..., shared_quad=True)`
    tables, with or without the other flags of `ensemble.KERNEL_FORMATS`
    (the formats are recognized by shape).  img: (..., H, W) integer in
    [0, 255]; channels ride the leading dims.  valid_hw: optional (h, w)
    scalars or (B,) vectors for bucketed evaluation (see
    `ensemble.clamp_pad_region`).
    Byte-identical to `mulut_tpu`'s `lut_cascade_packed`.  Raises
    ValueError on a non-symmetric mode's final-stage table that is a
    per-rotation stack (the defaults of `prepare_expanded_luts`, whose
    baked-in lane un-rotation the tail would repeat).
    """
    for m in modes:
        lut = tabs[f"s{stages}_{m}"]
        if fold_geometry(m) is None and lut.dim() != 2:
            raise ValueError(
                f"lut_cascade_packed: s{stages}_{m} is a per-rotation stack "
                f"{tuple(lut.shape)}; the packed cascade takes one shared "
                "table (ops.ensemble.KERNEL_FORMATS, shared_quad=True)")
    q = 2 ** interval
    x = img.to(torch.int32)
    for s in range(stages - 1):
        if valid_hw is not None:
            x = ens.clamp_pad_region(x, valid_hw)
        acc = None
        for mode in modes:
            lut = tabs[f"s{s + 1}_{mode}"]
            k128 = (lut.dim() == 2 and lut.shape[-1] == 128
                    and lut.dtype == torch.int8)
            if k128 and fold_geometry(mode) is not None:
                out = stage1_fold_k128(lut, x, mode=mode, interval=interval)
            elif k128:
                out = stage1_quad_k128(lut, x, mode=mode, interval=interval)
            elif fold_geometry(mode) is not None:
                out = ens.rotation_ensemble_lanes_folded_int(
                    lut, x, mode=mode, upscale=1, interval=interval,
                )[..., 0]
            else:
                out = ens.rotation_ensemble_lanes_quad_int(
                    lut, x, mode=mode, upscale=1, interval=interval,
                )[..., 0]
            acc = out if acc is None else acc + out
        # k128 contributions are integer-valued f32 (< 2**24 — exact)
        acc = acc.to(torch.int32)
        x = ens.stage_mix(acc, q=q, avg_factor=len(modes) * 4, bias=127)
    if valid_hw is not None:
        x = ens.clamp_pad_region(x, valid_hw)
    v = scale * scale
    folded, quads = [], []
    for mode in modes:
        lut = tabs[f"s{stages}_{mode}"]
        # a shared (L**4, 16*v) 16-corner table routes through the quad
        # path even for foldable modes; folded tables are 64*v wide
        corner16 = lut.dim() == 2 and lut.shape[-1] == 16 * v
        if fold_geometry(mode) is not None and not corner16:
            folded.append(
                folded_flat(lut, x, mode=mode, v=v, interval=interval)
            )
        else:
            outs, wy = quad_flat(lut, x, mode=mode, v=v, interval=interval)
            perms = [lane_rotation_perm(scale, r) for r in range(4)]
            quads.append((outs, wy, perms))
    return tail_assemble(
        folded, quads, lead=x.shape[:-2], h=x.shape[-2], w=x.shape[-1],
        scale=scale, davg=q * len(modes),
    )


def lut_cascade_u8(tabs, img, **kw):
    """`lut_cascade_packed` unpacked on the device: (..., H*scale,
    W*scale) uint8 (a view of the packed words)."""
    packed = lut_cascade_packed(tabs, img, **kw)
    return unpack_u32_device(packed, img.shape[:-2], img.shape[-2],
                             img.shape[-1], kw["scale"])


def lut_cascade_packed_banded(tabs, img, *, stages: int, modes: str,
                              scale: int, interval: int = 4, band: int = 128,
                              valid_hw=None):
    """The packed cascade over row slabs (`ensemble.run_banded`): K1 and
    K2 on every slab, each slab unpacked on the device and its kept rows
    written into one uint8 (..., H*scale, W*scale) output, bytes equal to
    the untiled cascade.  Arguments as `ensemble.lut_cascade_banded`."""
    def run(slab, valid):
        return lut_cascade_u8(tabs, slab, stages=stages, modes=modes,
                              scale=scale, interval=interval, valid_hw=valid)

    return ens.run_banded(run, img, band=band,
                          halo=ens.cascade_halo(stages, modes), scale=scale,
                          valid_hw=valid_hw)


def unpack_u32_device(packed, lead, h: int, w: int, scale: int):
    """Packed (prod(lead)*h, scale, wp) words -> (*lead, h*scale, w*scale)
    uint8 on the packed tensor's device: a byte view plus reshape (the
    words are little-endian on both host and card)."""
    wp = packed.shape[-1]
    bc = math.prod(lead)
    out = packed.contiguous().view(torch.uint8).reshape(
        bc, h * scale, wp * scale)
    return out.reshape(*(tuple(lead) + (h * scale, wp * scale)))[
        ..., : w * scale]


def unpack_u32(packed, lead, h: int, w: int, scale: int) -> np.ndarray:
    """Host uint8 (*lead, h*scale, w*scale) image from the packed words."""
    out = unpack_u32_device(packed, lead, h, w, scale)
    return np.ascontiguousarray(out.cpu().numpy())
