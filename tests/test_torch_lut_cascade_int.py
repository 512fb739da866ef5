"""The port's integer cascade and rank contractions against `mulut_tpu`'s.

- the three rotation ensembles (`rotation_ensemble_lanes_int` with and
  without expanded tables, `_quad_int`, `_folded_int`), rank on and off,
  fused on and off, at v = 1, 4, 9 and 16;
- `lut_cascade_int` over JAX's default table formats (and over the raw
  tables): x2 and x3 "sdy" (tests/test_x2_config.py, test_x3_config.py),
  x2 "eho" (test_eho_modes.py), x2 "s" at interval 3 (test_interval3.py),
  and with per-image `valid_hw`;
- `lut_cascade_packed` on JAX's all-rank tables (`shared_quad=True`, the
  tables of tests/test_tail_kernel.py) against JAX's in interpret mode;
- K1: the window form's plain version on rank rows (C = 5, 6, 8; shared,
  per-rotation and folded tables at u = 4, 9, 16, 36, 64) against JAX's
  `_contract` (the fold kernel in interpret mode) on the same planes, and
  `gather_fold_contract` at C != 16 against `fold_contract`.

The port's wrappers get CPU tensors here and run their plain torch
versions (the CUDA kernel is held against them on the card by
`chip_smoke.py --lut-rank`).  Interval 6 keeps the rank tables at 15,000
rows.  Tolerance: exact equality (integer sums below 2**24, integer stage
mixes).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mulut_tpu.ops import ensemble as jens
from mulut_tpu.ops import simplex as jsx
from mulut_tpu.ops import simplex_tables as jst
from mulut_tpu.ops import tail_kernel as jtk
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import tail_kernel as ttk
from mulut_tpu_torch.ops.taps import (
    fold_geometry,
    lane_rotation_perm,
    mode_pad,
    mode_taps,
    rotated_taps,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lut(interval, v, seed):
    L = 2 ** (8 - interval) + 1
    return np.random.default_rng(seed).integers(
        -127, 128, (L ** 4, v)).astype(np.int8)


def _image(shape, seed, interval=6):
    """Random pixels with a flat block and a block of tied fractions."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape)
    img[..., 1:4, 1:5] = 2 ** interval + 1
    img[..., 4:, :3] = 2 ** interval * rng.integers(1, 3, shape[:-2] + (
        shape[-2] - 4, 3)) + 2
    return img.astype(np.int32)


def _eq(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("v", [1, 4, 9, 16])
def test_lanes_int_equal(v):
    """Raw tables, and 16-corner per-rotation copies (expanded=True)."""
    up = int(round(v ** 0.5))
    lut = _lut(6, v, v).astype(np.int32)
    img = _image((2, 8, 9), v)
    kw = dict(mode="y", upscale=up, interval=6)
    want = jens.rotation_ensemble_lanes_int(jnp.asarray(lut),
                                            jnp.asarray(img), **kw)
    _eq(tens.rotation_ensemble_lanes_int(torch.as_tensor(lut),
                                         torch.as_tensor(img), **kw), want)
    e = jst.expand_lut(lut.astype(np.int8), 6)
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    copies = np.stack([e[:, :, p].reshape(625, -1) for p in perms])
    _eq(tens.rotation_ensemble_lanes_int(
        torch.as_tensor(copies if v > 1 else copies[0]),
        torch.as_tensor(img), expanded=True, **kw), want)
    _eq(tens.rotation_ensemble_int(torch.as_tensor(lut),
                                   torch.as_tensor(img), **kw),
        jens.rotation_ensemble_int(jnp.asarray(lut), jnp.asarray(img),
                                   **kw))


@pytest.mark.parametrize("rank", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode,v", [("y", 4), ("h", 9), ("o", 16),
                                    ("y", 1)])
def test_lanes_quad_equal(mode, v, rank, fused):
    """Per-rotation rank tables (rank) or 16-corner copies, and at v == 1
    the int32 (L**4, 16) inner-stage table."""
    if v == 1 and rank:
        rank = False                # no rank format at v == 1
    up = int(round(v ** 0.5))
    lut = _lut(6, v, v + ord(mode))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    if rank:
        tab = jst.rank_expand_rotations(lut, perms, 6)
    elif v > 1:
        e = jst.expand_lut(lut, 6)
        tab = np.stack([e[:, :, p].reshape(625, -1) for p in perms])
    else:
        tab = jst.expand_lut(lut, 6).reshape(625, 16).astype(np.int32)
    img = _image((2, 9, 7), v)
    kw = dict(mode=mode, upscale=up, interval=6, fused=fused, rank=rank)
    want = jens.rotation_ensemble_lanes_quad_int(jnp.asarray(tab),
                                                 jnp.asarray(img), **kw)
    _eq(tens.rotation_ensemble_lanes_quad_int(torch.as_tensor(tab),
                                              torch.as_tensor(img), **kw),
        want)


@pytest.mark.parametrize("rank", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode,v", [("s", 4), ("d", 9), ("e", 16),
                                    ("e", 1)])
def test_lanes_folded_equal(mode, v, rank, fused):
    if v == 1 and rank:
        rank = False                # symmetric v == 1 tables are fold_lut
    up = int(round(v ** 0.5))
    lut = _lut(6, v, v + 3 * ord(mode))
    geo = fold_geometry(mode)
    perms = [lane_rotation_perm(up, r) for r in range(4)] if v > 1 else None
    build = jst.rank_fold_lut if rank else jst.fold_lut
    tab = build(lut, geo, perms, 6)
    img = _image((2, 8, 11), v)
    kw = dict(mode=mode, upscale=up, interval=6, fused=fused, rank=rank)
    want = jens.rotation_ensemble_lanes_folded_int(jnp.asarray(tab),
                                                   jnp.asarray(img), **kw)
    _eq(tens.rotation_ensemble_lanes_folded_int(torch.as_tensor(tab),
                                                torch.as_tensor(img), **kw),
        want)


def test_rank_flag_must_match_table():
    """JAX's `rank` must match the table; the port reads the table's
    format from its shape, so the flag has no effect: a rank table gives
    JAX's rank=True bytes whatever the flag says."""
    tab = jst.rank_expand_shared(_lut(6, 4, 0), 6)
    img = _image((2, 9, 7), 4)
    kw = dict(mode="y", upscale=2, interval=6)
    want = jens.rotation_ensemble_lanes_quad_int(
        jnp.asarray(tab), jnp.asarray(img), rank=True, **kw)
    for rank in (True, False):
        _eq(tens.rotation_ensemble_lanes_quad_int(
            torch.as_tensor(tab), torch.as_tensor(img), rank=rank, **kw),
            want)


# (stages, modes, scale, interval): the JAX config tests' cascades
CONFIGS = [
    (2, "sdy", 2, 6),     # tests/test_x2_config.py
    (2, "sdy", 3, 6),     # tests/test_x3_config.py
    (2, "eho", 2, 6),     # tests/test_eho_modes.py
    (2, "sdyeho", 3, 5),
]
# x2 "s" at interval 3 (tests/test_interval3.py) runs through the
# evaluator in tests/test_torch_lut_scales.py


@functools.lru_cache(maxsize=None)
def _jax_cascade(stages, modes, scale, interval, expanded, bucketed):
    def run(tabs, img, hw):
        return jens.lut_cascade_int(
            tabs, img, stages=stages, modes=modes, scale=scale,
            interval=interval, expanded=expanded,
            valid_hw=hw if bucketed else None)
    return jax.jit(run)


@pytest.mark.parametrize("stages,modes,scale,interval", CONFIGS)
def test_lut_cascade_int_equal(stages, modes, scale, interval):
    """Over JAX's default (rank) formats and over the raw tables."""
    rng = np.random.default_rng(scale * 10 + interval)
    L = 2 ** (8 - interval) + 1
    luts = {f"s{s + 1}_{m}": rng.integers(
        -127, 128, (L ** 4, scale ** 2 if s + 1 == stages else 1)).astype(
            np.int8) for s in range(stages) for m in modes}
    img = _image((2, 9, 8), scale, interval)
    cfg = dict(stages=stages, modes=modes, scale=scale, interval=interval)
    jtabs = jens.prepare_expanded_luts(luts, interval=interval)
    want = _jax_cascade(stages, modes, scale, interval, True, False)(
        jtabs, jnp.asarray(img), None)
    ttabs = tens.prepare_expanded_luts(luts, interval=interval,
                                       device="cpu")
    got = tens.lut_cascade_int(ttabs, torch.as_tensor(img), expanded=True,
                               **cfg)
    assert got.dtype == torch.int32
    _eq(got, want)
    raw = {k: torch.as_tensor(t.astype(np.int32)) for k, t in luts.items()}
    _eq(tens.lut_cascade_int(raw, torch.as_tensor(img), **cfg), want)


def test_lut_cascade_int_valid_hw():
    """Bucketed evaluation with per-image (B,) extents, x3."""
    rng = np.random.default_rng(8)
    luts = {f"s{s}_{m}": rng.integers(-127, 128, (625, v)).astype(np.int8)
            for s, v in ((1, 1), (2, 9)) for m in "sdy"}
    img = _image((2, 1, 12, 14), 8)
    hw = (np.array([12, 7], np.int32), np.array([9, 14], np.int32))
    want = _jax_cascade(2, "sdy", 3, 6, True, True)(
        jens.prepare_expanded_luts(luts, interval=6), jnp.asarray(img),
        tuple(jnp.asarray(a) for a in hw))
    got = tens.lut_cascade_int(
        tens.prepare_expanded_luts(luts, interval=6, device="cpu"),
        torch.as_tensor(img), stages=2, modes="sdy", scale=3, interval=6,
        expanded=True, valid_hw=hw)
    _eq(got, want)


def test_packed_cascade_all_rank():
    """`prepare_expanded_luts(shared_quad=True)`, the tables of JAX's
    tests/test_tail_kernel.py: rank-folded and shared rank final stages,
    (L**4, 64) folded and int32 (L**4, 16) inner stages, against JAX's
    packed cascade in interpret mode (e/h/o: tests/test_torch_lut_scales.py
    at x4 "sdyeho")."""
    modes = "sdy"
    rng = np.random.default_rng(118)
    luts = {f"s{s}_{m}": rng.integers(-127, 128, (625, v)).astype(np.int8)
            for s, v in ((1, 1), (2, 16)) for m in modes}
    jtabs = jens.prepare_expanded_luts(luts, interval=6, shared_quad=True)
    img = _image((2, 13, 57), 4)
    want = jax.jit(lambda t, x: jtk.lut_cascade_packed(
        t, x, stages=2, modes=modes, scale=4, interval=6, interpret=True))(
            jtabs, jnp.asarray(img))
    got = ttk.lut_cascade_packed(
        tens.prepare_expanded_luts(luts, interval=6, device="cpu",
                                   shared_quad=True),
        torch.as_tensor(img), stages=2, modes=modes, scale=4, interval=6)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def _rank_table(kind, v):
    lut = _lut(6, v, v + len(kind))
    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    if kind == "fold":
        return jst.rank_fold_lut(lut, fold_geometry("s"), perms, 6)
    if kind == "shared":
        return jst.rank_expand_shared(lut, 6)
    return jst.rank_expand_rotations(lut, perms, 6)


# (table kind, v, u, C): every rank call site of the cascades
RANK_SITES = [
    ("fold", 16, 64, 6),      # x4 rank-folded, rows padded to 6 x 64
    ("fold", 4, 16, 8),       # x2 rank-folded, rows padded to 8 x 16
    ("fold", 9, 36, 5),       # x3 rank-folded
    ("shared", 16, 16, 5),    # x4 shared rank (packed quad path)
    ("rotations", 4, 4, 5),   # x2 per-rotation rank
    ("rotations", 9, 9, 5),   # x3 per-rotation rank
]


@pytest.mark.parametrize("kind,v,u,C", RANK_SITES)
def test_window_plain_rank_rows_equal_contract(kind, v, u, C):
    """The window form's plain version on rank rows against JAX's
    `_contract` (row `lehmer * L**4 + base`, `sorted_weights_t` padded to
    C, `fold_contract` in interpret mode) rotation by rotation."""
    tab = _rank_table(kind, v)
    img = _image((2, 7, 9), u)
    xp = np.pad(img, ((0, 0), (3, 3), (3, 3)), mode="edge")
    if kind == "fold":
        taps, origin = (mode_taps("s"),), (2, 2)
    else:
        taps, origin = [rotated_taps("h", r) for r in range(4)], (3, 3)
    grid = (7, 9)
    got = ttk.window_fold_contract(
        torch.as_tensor(tab), torch.as_tensor(xp), taps=taps, origin=origin,
        grid=grid, interval=6, u=u)
    assert got.shape == (len(taps), u, 2 * 7 * 9 + 8)
    for r, rt in enumerate(taps):
        t = tab[r] if tab.ndim == 3 else tab
        planes = [jnp.asarray(xp[:, origin[0] + dy: origin[0] + dy + 7,
                                 origin[1] + dx: origin[1] + dx + 9])
                  for dy, dx in rt]
        base, fr = jsx._base_and_fracs(planes, interval=6)
        base, fr = jtk._pad8_base_fracs(base, fr)
        g = jnp.take(jnp.asarray(t), jsx._lehmer_code(*fr)
                     * (t.shape[0] // 24) + base, axis=0, mode="clip")
        want = jtk._contract(g, fr, C=C, v=u, interval=6)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want).T)


@pytest.mark.parametrize("C,u", [(5, 4), (5, 9), (5, 16), (5, 36), (6, 64),
                                 (8, 16)])
def test_gather_fold_contract_rank_c_equals_jax(C, u):
    rng = np.random.default_rng(C * 100 + u)
    rows, n = 15000, 700
    tab = rng.integers(-128, 128, (rows, C * u)).astype(np.int8)
    base = rng.integers(0, rows, n + 8).astype(np.int32)
    wt = rng.integers(0, 65, (C, n + 8)).astype(np.float32)
    wt[5:] = 0.0                                   # padded terms
    got = ttk.gather_fold_contract(torch.as_tensor(tab),
                                   torch.as_tensor(base),
                                   torch.as_tensor(wt), C=C, u=u)
    want = jtk.fold_contract(jnp.take(jnp.asarray(tab), jnp.asarray(base),
                                      axis=0),
                             jnp.asarray(wt), C=C, u=u, interpret=True)
    assert got.shape == (u, n + 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
