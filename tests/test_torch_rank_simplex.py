"""The port's integer simplex functions against `mulut_tpu.ops.simplex`.

`_lehmer_code`, `sorted_weights` / `sorted_weights_t` and every
`simplex_planes_*_int` (raw, expanded, folded, rank-folded, rank
per-rotation), `simplex_interp_int` and the NumPy oracle
`reference_oracle_int`, on the same seeded inputs.  The planes include
JAX's tie patterns (`tests/test_folded_engine.py:
test_rank_folded_tie_patterns`: every rank order of fractions drawn from
three adjacent values, at interval 6 here so the rank tables stay at
15,000 rows), where a wrong rank code changes bytes only once the tie's
weight is non-zero.  Tolerance: exact equality (integer sums below 2**24).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mulut_tpu.ops import simplex as jsx
from mulut_tpu.ops import simplex_tables as jst
from mulut_tpu_torch.ops import simplex as tsx
from mulut_tpu_torch.ops.taps import fold_geometry, lane_rotation_perm

INTERVAL = 6
L = 2 ** (8 - INTERVAL) + 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_planes():
    """Four (81, 4) planes: every fraction quadruple over {0, 1, 2} (all
    tie patterns), beside random pixels."""
    q = 2 ** INTERVAL
    vals = np.array(list(itertools.product([q, q + 1, q + 2], repeat=4))).T
    rnd = np.random.default_rng(0).integers(0, 256, (4, 81))
    return [np.stack([v, r], axis=1).astype(np.int32)
            for v, r in zip(vals, rnd)]


def _both(planes):
    return ([jnp.asarray(p) for p in planes],
            [torch.as_tensor(p) for p in planes])


def _eq(got, want):
    want = np.asarray(want)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_lehmer_and_sorted_weights_equal():
    f = np.array(list(itertools.product(range(4), repeat=4))).T.astype(
        np.int32)
    jf, tf = _both(list(f))
    _eq(tsx._lehmer_code(*tf), jsx._lehmer_code(*jf))
    _eq(tsx.sorted_weights(*tf, interval=2),
        jsx.sorted_weights(*jf, interval=2))
    _eq(tsx.sorted_weights_t(*tf, interval=2),
        jsx.sorted_weights_t(*jf, interval=2))
    # the code indexes the rank tables' chains: bijective on rank orders
    codes = tsx._lehmer_code(*tf).numpy()
    assert set(codes.tolist()) == set(range(24))


@pytest.mark.parametrize("v", [1, 4, 9, 16])
def test_planes_int_and_expanded_equal(v):
    rng = np.random.default_rng(v)
    lut = rng.integers(-127, 128, (L ** 4, v)).astype(np.int32)
    elut = jst.expand_lut(lut.astype(np.int8), INTERVAL).reshape(L ** 4, -1)
    jp, tp = _both(_tie_planes())
    want = jsx.simplex_planes_int(jnp.asarray(lut), jp, interval=INTERVAL)
    _eq(tsx.simplex_planes_int(torch.as_tensor(lut), tp, interval=INTERVAL),
        want)
    _eq(tsx.simplex_planes_expanded_int(torch.as_tensor(elut), tp, v=v,
                                        interval=INTERVAL),
        jsx.simplex_planes_expanded_int(jnp.asarray(elut), jp, v=v,
                                        interval=INTERVAL))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(
        jsx.simplex_planes_expanded_int(jnp.asarray(elut), jp, v=v,
                                        interval=INTERVAL)))


@pytest.mark.parametrize("mode", ["s", "d", "e"])
@pytest.mark.parametrize("v", [1, 4, 9, 16])
def test_planes_folded_and_rank_folded_equal(mode, v):
    rng = np.random.default_rng(ord(mode) + v)
    lut = rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
    geo = fold_geometry(mode)
    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    jp, tp = _both(_tie_planes())
    flut = jst.fold_lut(lut, geo, perms, INTERVAL)
    _eq(tsx.simplex_planes_folded_int(torch.as_tensor(flut), tp, v=v,
                                      interval=INTERVAL),
        jsx.simplex_planes_folded_int(jnp.asarray(flut), jp, v=v,
                                      interval=INTERVAL))
    rflut = jst.rank_fold_lut(lut, geo, perms, INTERVAL)
    want = jsx.simplex_planes_rank_folded_int(jnp.asarray(rflut), jp, v=v,
                                              interval=INTERVAL)
    _eq(tsx.simplex_planes_rank_folded_int(torch.as_tensor(rflut), tp, v=v,
                                           interval=INTERVAL), want)
    # rank rows carry the same function as the 16-corner folded rows
    np.testing.assert_array_equal(np.asarray(want), np.asarray(
        jsx.simplex_planes_folded_int(jnp.asarray(flut), jp, v=v,
                                      interval=INTERVAL)))


@pytest.mark.parametrize("v", [4, 9, 16])
def test_planes_rank_quad_equal(v):
    rng = np.random.default_rng(v + 50)
    lut = rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
    up = int(round(v ** 0.5))
    perms = [lane_rotation_perm(up, r) for r in range(4)]
    rl = jst.rank_expand_rotations(lut, perms, INTERVAL)
    el = np.stack([jst.expand_lut(lut, INTERVAL)[:, :, p].reshape(L ** 4, -1)
                   for p in perms])
    planes4 = [_tie_planes() for _ in range(4)]
    for r in range(1, 4):          # each rotation reads other pixels
        planes4[r] = [np.roll(p, r, axis=0) for p in planes4[r]]
    jp4 = [[jnp.asarray(p) for p in pl] for pl in planes4]
    tp4 = [[torch.as_tensor(p) for p in pl] for pl in planes4]
    want = jsx.simplex_planes_rank_quad_int(jnp.asarray(rl), jp4, v=v,
                                            interval=INTERVAL)
    _eq(tsx.simplex_planes_rank_quad_int(torch.as_tensor(rl), tp4, v=v,
                                         interval=INTERVAL), want)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(
        jsx.simplex_planes_quad_int(jnp.asarray(el), jp4, v=v,
                                    interval=INTERVAL)))


@pytest.mark.parametrize("mode,upscale", [("s", 2), ("y", 3), ("h", 1),
                                          ("e", 4)])
def test_interp_int_and_oracle_equal(mode, upscale):
    from mulut_tpu_torch.ops.taps import mode_pad

    rng = np.random.default_rng(upscale)
    lut = rng.integers(-127, 128, (L ** 4, upscale ** 2)).astype(np.int32)
    pad = mode_pad(mode)
    img = rng.integers(0, 256, (2, 5 + pad, 6 + pad)).astype(np.int32)
    img[0, :3, :3] = 2 ** INTERVAL + 1          # a flat, tied block
    want = jsx.simplex_interp_int(jnp.asarray(lut), jnp.asarray(img),
                                  mode=mode, upscale=upscale,
                                  interval=INTERVAL)
    _eq(tsx.simplex_interp_int(torch.as_tensor(lut), torch.as_tensor(img),
                               mode=mode, upscale=upscale,
                               interval=INTERVAL), want)
    oracle = tsx.reference_oracle_int(lut, img, mode=mode, upscale=upscale,
                                      interval=INTERVAL)
    np.testing.assert_array_equal(oracle, jsx.reference_oracle_int(
        lut, img, mode=mode, upscale=upscale, interval=INTERVAL))
    np.testing.assert_array_equal(oracle, np.asarray(want))
