"""Branchless decision tables and expanded-table builders for 4-D simplex
(tetrahedral) interpolation.

The reference implementation (ref: sr/4_test_lut.py:140-231) selects one of
24 weight/corner assignments per pixel via a sequential chain of boolean-mask
branches over the six strict pairwise comparisons of the four LSB fractions.
The chain is replayed here once on the host for all 2**6 comparison codes
(`corner_offsets`, `weight_coeffs`).

The expanded tables are pure gathers/permutations of the source (L**4, v)
int8 LUT.  Each builder has a NumPy form (host) and a torch twin
(`*_device`) that builds the same bytes on the card from the small source
LUT, rank-expanded tables included.  NumPy twin of
`mulut_tpu.ops.simplex_tables` (tests hold the two byte-equal).
"""

from __future__ import annotations

import numpy as np
import torch

# Comparison bit layout within the 6-bit code: code = sum(bit_i << i) with
#   bit 5: fa > fb   (ab)
#   bit 4: fa > fc   (ac)
#   bit 3: fa > fd   (ad)
#   bit 2: fb > fc   (bc)
#   bit 1: fb > fd   (bd)
#   bit 0: fc > fd   (cd)
_BITS = {"ab": 5, "ac": 4, "ad": 3, "bc": 2, "bd": 1, "cd": 0}

# The 24 branches, in the reference's evaluation order.  Each branch is
#   (requires_true, requires_false, requires_failed_branches, permutation)
# where permutation is a string over 'abcd' giving descending fraction order.
_BRANCHES = [
    # group 1: fab & fbc (ref i1..i4)
    (("ab", "bc", "cd"), (), (), "abcd"),              # i1
    (("ab", "bc", "bd"), (), (0,), "abdc"),            # i2
    (("ab", "bc", "ad"), (), (0, 1), "adbc"),          # i3
    (("ab", "bc"), (), (0, 1, 2), "dabc"),             # i4
    # group 2: ~fbc & fab & fac (ref i5..i8)
    (("ab", "ac", "bd"), ("bc",), (), "acbd"),         # i5
    (("ab", "ac", "cd"), ("bc",), (4,), "acdb"),       # i6
    (("ab", "ac", "ad"), ("bc",), (4, 5), "adcb"),     # i7
    (("ab", "ac"), ("bc",), (4, 5, 6), "dacb"),        # i8
    # group 3: ~fbc & ~fac & fab (ref i9..i12, with the SR-LUT overflow fix:
    # i10 tests fad before i11 tests fcd, ref sr/4_test_lut.py:178-191)
    (("ab", "bd"), ("bc", "ac"), (), "cabd"),          # i9
    (("ab", "ad"), ("bc", "ac"), (8,), "cadb"),        # i10  (c > a > d > b)
    (("ab", "cd"), ("bc", "ac"), (8, 9), "cdab"),      # i11  (c > d > a > b)
    (("ab",), ("bc", "ac"), (8, 9, 10), "dcab"),       # i12
    # group 4: ~fab & fac (ref i13..i16)
    (("ac", "cd"), ("ab",), (), "bacd"),               # i13
    (("ac", "ad"), ("ab",), (12,), "badc"),            # i14
    (("ac", "bd"), ("ab",), (12, 13), "bdac"),         # i15
    (("ac",), ("ab",), (12, 13, 14), "dbac"),          # i16
    # group 5: ~fab & ~fac & fbc (ref i17..i20)
    (("bc", "ad"), ("ab", "ac"), (), "bcad"),          # i17
    (("bc", "cd"), ("ab", "ac"), (16,), "bcda"),       # i18
    (("bc", "bd"), ("ab", "ac"), (16, 17), "bdca"),    # i19
    (("bc",), ("ab", "ac"), (16, 17, 18), "dbca"),     # i20
    # group 6: ~fab & ~fac & ~fbc (ref i21..i24)
    (("ad",), ("ab", "ac", "bc"), (), "cbad"),         # i21
    (("bd",), ("ab", "ac", "bc"), (20,), "cbda"),      # i22
    (("cd",), ("ab", "ac", "bc"), (20, 21), "cdba"),   # i23
    ((), ("ab", "ac", "bc"), (20, 21, 22), "dcba"),    # i24
]

_DIM = {"a": 0, "b": 1, "c": 2, "d": 3}


def _branch_condition(code: int, branch_idx: int) -> bool:
    """Whether `branch_idx`'s full condition (incl. ~earlier masks) holds."""
    req_true, req_false, req_failed, _ = _BRANCHES[branch_idx]
    for name in req_true:
        if not (code >> _BITS[name]) & 1:
            return False
    for name in req_false:
        if (code >> _BITS[name]) & 1:
            return False
    for earlier in req_failed:
        if _branch_condition(code, earlier):
            return False
    return True


def _perm_tables(perm: str):
    """Corner offsets (5,) and weight coefficient matrix (5,5) for sigma."""
    corners = np.zeros(5, dtype=np.int64)
    mask = [0, 0, 0, 0]
    for k, ch in enumerate(perm):
        mask[_DIM[ch]] = 1
        corners[k + 1] = mask[0] * 8 + mask[1] * 4 + mask[2] * 2 + mask[3]
    # weights = M @ [q, fa, fb, fc, fd]
    M = np.zeros((5, 5), dtype=np.int64)
    cols = [1 + _DIM[ch] for ch in perm]  # column of f_{sigma_k}
    M[0, 0] = 1
    M[0, cols[0]] = -1
    for k in range(3):
        M[k + 1, cols[k]] = 1
        M[k + 1, cols[k + 1]] = -1
    M[4, cols[3]] = 1
    return corners, M


def _build_tables():
    corner_bits = np.zeros((64, 5), dtype=np.int64)
    coeffs = np.zeros((64, 5, 5), dtype=np.int64)
    for code in range(64):
        chosen = None
        # Replay the reference's sequential masked assignments: the last
        # matching write wins, so scan all.
        for b in range(len(_BRANCHES)):
            if _branch_condition(code, b):
                chosen = b
        if chosen is None:
            # Logically-inconsistent codes keep the reference's out == 0.
            continue
        corners, M = _perm_tables(_BRANCHES[chosen][3])
        corner_bits[code] = corners
        coeffs[code] = M
    return corner_bits, coeffs


_CORNER_BITS, _COEFFS = _build_tables()


def corner_offsets(L: int) -> np.ndarray:
    """(64, 5) int32 flat LUT-index offsets for bin-size L per dimension."""
    bits = _CORNER_BITS
    strides = np.array([L ** 3, L ** 2, L, 1], dtype=np.int64)
    a = (bits >> 3) & 1
    b = (bits >> 2) & 1
    c = (bits >> 1) & 1
    d = bits & 1
    off = a * strides[0] + b * strides[1] + c * strides[2] + d * strides[3]
    return off.astype(np.int32)


def weight_coeffs() -> np.ndarray:
    """(64, 5, 5) int32: weights = coeffs[code] @ [q, fa, fb, fc, fd]."""
    return _COEFFS.astype(np.int32)


def expand_lut(lut: np.ndarray, interval: int = 4) -> np.ndarray:
    """Pre-expand a LUT so each row carries all 16 hypercube-corner values.

    E[row, m, :] = lut[flat(digits(row) + bits(m) clipped to L-1), :] for
    the 4-bit corner mask m (bit 3 = a).  One gather of E[base] then
    serves all five simplex corners of a pixel.

    Returns (L**4, 16, v) with lut's dtype.
    """
    L = 2 ** (8 - interval) + 1
    v = lut.shape[1] if lut.ndim == 2 else 1
    flat = lut.reshape(L ** 4, v)
    idx = np.arange(L ** 4, dtype=np.int64)
    digits = np.stack(
        [idx // L ** 3 % L, idx // L ** 2 % L, idx // L % L, idx % L], axis=1
    )
    out = np.empty((L ** 4, 16, v), dtype=lut.dtype)
    for m in range(16):
        bits = np.array([(m >> 3) & 1, (m >> 2) & 1, (m >> 1) & 1, m & 1])
        d = np.minimum(digits + bits, L - 1)
        corner = ((d[:, 0] * L + d[:, 1]) * L + d[:, 2]) * L + d[:, 3]
        out[:, m, :] = flat[corner]
    return out


def _mode_mask_perm(sigma) -> np.ndarray:
    """(16,) corner-mask permutation induced by digit permutation sigma."""
    return np.array(
        [
            sum(((m >> (3 - sigma[i])) & 1) << (3 - i) for i in range(4))
            for m in range(16)
        ]
    )


def fold_lut(
    lut: np.ndarray,
    geometry,
    lane_perms=None,
    interval: int = 4,
) -> np.ndarray:
    """Fold the 4-rotation ensemble of a corner-expanded LUT into its rows.

    For 90-degree-symmetric tap patterns (`taps.fold_geometry`), rotation r
    reads the same 4-pixel window as rotation 0 with the letter roles
    permuted by sigma_r; simplex interpolation is equivariant under that
    permutation, so all four rotations share one gather and one weight
    computation per pixel.

    Returns (L**4, 16 * 4 * v): column block [m][r][:] of row n is
    E[perm_idx_r(n), perm_bits_r(m), lane_perms[r]].
    """
    L = 2 ** (8 - interval) + 1
    e = expand_lut(lut, interval)  # (L**4, 16, v)
    idx = np.arange(L ** 4, dtype=np.int64)
    digits = [idx // L ** 3 % L, idx // L ** 2 % L, idx // L % L, idx % L]
    blocks = []
    for r, (_, sigma) in enumerate(geometry):
        d = [digits[s] for s in sigma]
        pidx = ((d[0] * L + d[1]) * L + d[2]) * L + d[3]
        er = e[pidx][:, _mode_mask_perm(sigma)]
        if lane_perms is not None:
            er = er[:, :, lane_perms[r]]
        blocks.append(er)
    folded = np.stack(blocks, axis=2)  # (L**4, 16, 4, v)
    return folded.reshape(L ** 4, -1)


def _digits_device(L: int, device):
    idx = torch.arange(L ** 4, dtype=torch.int64, device=device)
    return (idx // L ** 3 % L, idx // L ** 2 % L, idx // L % L, idx % L)


def expand_lut_device(lut: torch.Tensor, interval: int = 4) -> torch.Tensor:
    """Torch twin of `expand_lut`: (L**4, v) -> (L**4, 16, v), on lut's
    device."""
    L = 2 ** (8 - interval) + 1
    v = lut.shape[1] if lut.ndim == 2 else 1
    flat = lut.reshape(L ** 4, v)
    da, db, dc, dd = _digits_device(L, lut.device)
    cols = []
    for m in range(16):
        a = torch.clamp(da + ((m >> 3) & 1), max=L - 1)
        b = torch.clamp(db + ((m >> 2) & 1), max=L - 1)
        c = torch.clamp(dc + ((m >> 1) & 1), max=L - 1)
        d = torch.clamp(dd + (m & 1), max=L - 1)
        corner = ((a * L + b) * L + c) * L + d
        cols.append(flat.index_select(0, corner))
    return torch.stack(cols, dim=1)


def fold_lut_device(lut: torch.Tensor, geometry, lane_perms=None,
                    interval: int = 4) -> torch.Tensor:
    """Torch twin of `fold_lut`: -> (L**4, 16*4*v), on lut's device."""
    L = 2 ** (8 - interval) + 1
    dev = lut.device
    e = expand_lut_device(lut, interval)  # (L**4, 16, v)
    digits = _digits_device(L, dev)
    blocks = []
    for r, (_, sigma) in enumerate(geometry):
        d = [digits[s] for s in sigma]
        pidx = ((d[0] * L + d[1]) * L + d[2]) * L + d[3]
        er = e.index_select(0, pidx)
        er = er.index_select(
            1, torch.as_tensor(_mode_mask_perm(sigma), device=dev))
        if lane_perms is not None:
            er = er.index_select(
                2, torch.as_tensor(lane_perms[r], device=dev))
        blocks.append(er)
    folded = torch.stack(blocks, dim=2)  # (L**4, 16, 4, v)
    return folded.reshape(L ** 4, -1)


# ---------------------------------------------------------------------------
# Rank-expanded tables: 5 simplex-chain corners per row
# ---------------------------------------------------------------------------


def lehmer_of_ranks(ra, rb, rc, rd, xp=np):
    """Bijective 0..23 code of the descending-rank permutation.

    Works on scalars or arrays.  Must match `simplex._lehmer_code` (and the
    kernel's code in csrc/window_fold.cu) exactly: the rank tables below
    are indexed by this code.
    """
    l2 = rb - (rb > ra)
    l3 = rc - (rc > ra) - (rc > rb)
    del rd  # implied by the other three
    return ra * 6 + l2 * 2 + l3


def rank_chain_masks() -> np.ndarray:
    """(24, 5) int corner masks of the simplex chain per Lehmer rank code.

    For a pixel whose fractions have descending ranks (ra, rb, rc, rd)
    (0 = largest; reference tie-break), the k-th simplex corner is the
    hypercube mask of the k highest-ranked dimensions:
    m_0 = 0000, m_k = m_{k-1} | bit(dim with rank k-1), m_4 = 1111
    (ref: sr/4_test_lut.py:148-231 — each branch's corner chain).
    """
    import itertools

    out = np.zeros((24, 5), dtype=np.int64)
    bit = (8, 4, 2, 1)  # a, b, c, d
    for ranks in itertools.permutations(range(4)):
        p = int(lehmer_of_ranks(*ranks))
        order = sorted(range(4), key=lambda x: ranks[x])  # dims by rank
        m = 0
        for k, dim in enumerate(order):
            m |= bit[dim]
            out[p, k + 1] = m
    return out


def _rank_pad(row: int, v: int) -> int:
    """Padded row width of a rank-folded table: rows are padded to whole
    128-byte tiles with zero term blocks when the term width 4v divides
    128 (or 128 divides it), as the JAX package lays them out for the
    TPU's gather."""
    if row % 128 and (128 % (4 * v) == 0 or (4 * v) % 128 == 0):
        return -(-row // 128) * 128
    return row


def rank_fold_lut(
    lut: np.ndarray,
    geometry,
    lane_perms=None,
    interval: int = 4,
) -> np.ndarray:
    """Rank-expanded rotation-folded table: 5 chain corners per row.

    Rows are indexed rank-major, `lehmer(rank) * L**4 + base`: row p of
    base n holds exactly the 5 simplex-chain corners (in rank order) of
    every rotation, so the contraction is 5 multiply-adds with the
    sorted-difference weights.  Rows are zero-padded to whole 128-byte
    tiles where the term width 4v divides 128 (`_rank_pad`: 6 terms of 64
    at v=16, 8 of 16 at v=4); consumers skip or zero-weight the padding.

    Returns (L**4 * 24, padded 5 * 4 * v): column block [k][r][:] is chain
    corner k of rotation r (k-major, matching `fold_lut`'s m-major layout).
    """
    L = 2 ** (8 - interval) + 1
    v = lut.shape[1] if lut.ndim == 2 else 1
    folded = fold_lut(lut, geometry, lane_perms, interval)
    folded = folded.reshape(L ** 4, 16, 4 * v)
    chains = rank_chain_masks()  # (24, 5)
    out = np.ascontiguousarray(
        folded[:, chains].transpose(1, 0, 2, 3)  # (24, L**4, 5, 4v)
    )
    row = 5 * 4 * v
    out = out.reshape(L ** 4 * 24, row)
    target = _rank_pad(row, v)
    if target != row:
        out = np.pad(out, ((0, 0), (0, target - row)))
    return out


def rank_expand_rotations(
    lut: np.ndarray,
    lane_perms=None,
    interval: int = 4,
) -> np.ndarray:
    """Per-rotation rank-expanded tables for non-symmetric modes (y/h/o).

    Each rotation gathers with its own base and rank code, so rotation r
    gets its own (L**4 * 24, 5 * v) block with the output-lane un-rotation
    `lane_perms[r]` pre-applied.  Rank-major row order.

    Returns (4, L**4 * 24, 5 * v) with lut's dtype.
    """
    L = 2 ** (8 - interval) + 1
    e = expand_lut(lut, interval)  # (L**4, 16, v)
    v = e.shape[-1]
    chains = rank_chain_masks()
    ec = e[:, chains].transpose(1, 0, 2, 3)  # (24, L**4, 5, v)
    rots = []
    for r in range(4):
        er = ec[..., lane_perms[r]] if lane_perms is not None else ec
        rots.append(
            np.ascontiguousarray(er).reshape(L ** 4 * 24, 5 * v)
        )
    return np.stack(rots)


def rank_expand_shared(lut: np.ndarray, interval: int = 4) -> np.ndarray:
    """ONE shared un-permuted rank-expanded table for all 4 rotations of a
    non-symmetric mode (the consumer applies the lane un-rotation).
    Rank-major row order.

    Returns (L**4 * 24, 5 * v) with lut's dtype.
    """
    L = 2 ** (8 - interval) + 1
    e = expand_lut(lut, interval)          # (L**4, 16, v)
    v = e.shape[-1]
    ec = e[:, rank_chain_masks()].transpose(1, 0, 2, 3)  # (24, L**4, 5, v)
    return np.ascontiguousarray(ec).reshape(L ** 4 * 24, 5 * v)


def expand_indices(interval: int = 4) -> np.ndarray:
    """(L**4 * 16,) int32: row r*16 + m = flat(digits(r) + bits(m), clipped).

    `table[expand_indices].reshape(L**4, 16*v)` equals `expand_lut(table)`.
    """
    L = 2 ** (8 - interval) + 1
    idx = np.arange(L ** 4, dtype=np.int64)
    digits = np.stack(
        [idx // L ** 3 % L, idx // L ** 2 % L, idx // L % L, idx % L], axis=1
    )
    out = np.empty((L ** 4, 16), dtype=np.int32)
    for m in range(16):
        bits = np.array([(m >> 3) & 1, (m >> 2) & 1, (m >> 1) & 1, m & 1])
        d = np.minimum(digits + bits, L - 1)
        out[:, m] = ((d[:, 0] * L + d[:, 1]) * L + d[:, 2]) * L + d[:, 3]
    return out.reshape(-1)


def comparison_code(fa, fb, fc, fd, xp=np):
    """6-bit code from the strict pairwise comparisons (host/NumPy helper)."""
    return (
        (fa > fb).astype(np.int32) * 32
        + (fa > fc).astype(np.int32) * 16
        + (fa > fd).astype(np.int32) * 8
        + (fb > fc).astype(np.int32) * 4
        + (fb > fd).astype(np.int32) * 2
        + (fc > fd).astype(np.int32) * 1
    )


def _rank_pad_device(out: torch.Tensor, v: int) -> torch.Tensor:
    row = out.shape[-1]
    target = _rank_pad(row, v)
    if target != row:
        out = torch.nn.functional.pad(out, (0, target - row))
    return out


def _chains_device(device) -> torch.Tensor:
    return torch.as_tensor(rank_chain_masks().reshape(-1), device=device)


def rank_fold_lut_device(lut: torch.Tensor, geometry, lane_perms=None,
                         interval: int = 4) -> torch.Tensor:
    """Torch twin of `rank_fold_lut`: -> (L**4*24, padded 5*4*v), on lut's
    device."""
    L = 2 ** (8 - interval) + 1
    v = lut.shape[1] if lut.ndim == 2 else 1
    folded = fold_lut_device(lut, geometry, lane_perms, interval)
    folded = folded.reshape(L ** 4, 16, 4 * v)
    out = folded.index_select(1, _chains_device(lut.device))
    out = out.reshape(L ** 4, 24, 5, 4 * v).transpose(0, 1)
    return _rank_pad_device(out.reshape(L ** 4 * 24, 5 * 4 * v), v)


def rank_expand_shared_device(lut: torch.Tensor,
                              interval: int = 4) -> torch.Tensor:
    """Torch twin of `rank_expand_shared`: -> (L**4*24, 5*v)."""
    L = 2 ** (8 - interval) + 1
    e = expand_lut_device(lut, interval)  # (L**4, 16, v)
    v = e.shape[-1]
    ec = e.index_select(1, _chains_device(lut.device))
    ec = ec.reshape(L ** 4, 24, 5, v).transpose(0, 1)
    return ec.reshape(L ** 4 * 24, 5 * v)


def rank_expand_rotations_device(lut: torch.Tensor, lane_perms=None,
                                 interval: int = 4) -> torch.Tensor:
    """Torch twin of `rank_expand_rotations`: -> (4, L**4*24, 5*v)."""
    L = 2 ** (8 - interval) + 1
    e = expand_lut_device(lut, interval)
    v = e.shape[-1]
    ec = e.index_select(1, _chains_device(lut.device))
    ec = ec.reshape(L ** 4, 24, 5, v).transpose(0, 1)   # (24, L**4, 5, v)
    rots = []
    for r in range(4):
        er = (ec.index_select(3, torch.as_tensor(lane_perms[r],
                                                 device=lut.device))
              if lane_perms is not None else ec)
        rots.append(er.reshape(L ** 4 * 24, 5 * v))
    return torch.stack(rots)
