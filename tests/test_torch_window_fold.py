"""The window-read simplex contraction (`window_fold_contract`) on the CPU.

Here the wrapper gets CPU tensors and runs its plain torch version; the
CUDA kernel (csrc/window_fold.cu) is held against that plain version on the
card by chip_smoke.py.  Each call site of the packed cascade is held against
its JAX function on the same seeded image and table, at intervals 4 and 6:
`stage1_fold_k128`, `stage1_quad_k128` (u=8), `folded_flat` (u=64),
`quad_flat` (u=16) with the fold kernel in interpret mode under `jax.jit`,
and the rotation-summed u=1 form against
`ensemble.rotation_ensemble_lanes_quad_int`.  A NumPy model of the kernel's
per-site arithmetic (five corners from the fraction ranks, the other eleven
never read) is held against the 16-corner plain version.  Tolerance: exact
equality everywhere (integer sums below 2**24).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mulut_tpu.ops import ensemble as jens
from mulut_tpu.ops import tail_kernel as jtk
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.ops import simplex as tsx
from mulut_tpu_torch.ops import tail_kernel as ttk
from mulut_tpu_torch.ops.taps import mode_taps, rotated_taps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(interval, width, seed):
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (L ** 4, width)).astype(np.int8)


def _image(lead, h, w, seed, interval):
    """Random pixels with a flat block (all four fracs tied), a block of
    equal fracs over different bases, and the values 0 and 255."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, lead + (h, w))
    img[..., 1:5, 2:7] = 77
    q = 2 ** interval
    img[..., 5:, :4] = q * rng.integers(0, 256 // q, lead + (h - 5, 4)) + 3
    img[..., 0, :] = 0
    img[..., -1, 1::2] = 255
    img[..., :, -1] = 255
    return img.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fn(name, mode, interval, v):
    fn = getattr(jtk, name)
    kw = dict(mode=mode, interval=interval)
    if v:
        kw["v"] = v
    return jax.jit(lambda tab, img: fn(tab, img, **kw))


# (call site, JAX function, mode, table width, v)
SITES = [
    ("stage1_fold_k128", "s", 128, 0),
    ("stage1_fold_k128", "d", 128, 0),
    ("stage1_quad_k128", "y", 128, 0),
    ("folded_flat", "s", 1024, 16),
    ("folded_flat", "d", 1024, 16),
    ("quad_flat", "y", 256, 16),
]


@pytest.mark.parametrize("interval", [4, 6])
@pytest.mark.parametrize("name,mode,width,v", SITES)
def test_call_site_equals_jax(name, mode, width, v, interval):
    tab = _table(interval, width, width + ord(mode))
    img = _image((2,), 9, 13, interval + ord(mode), interval)
    want = _jax_fn(name, mode, interval, v)(jnp.asarray(tab),
                                            jnp.asarray(img))
    kw = dict(mode=mode, interval=interval, **({"v": v} if v else {}))
    got = getattr(ttk, name)(torch.as_tensor(tab), torch.as_tensor(img),
                             **kw)
    if name == "folded_flat":
        assert got[1:] == tuple(want[1:3]) + (list(want[3]),)
        got, want = got[0], want[0]
    elif name == "quad_flat":
        assert got[1] == want[1]
        got, want = torch.stack(got[0]), np.stack(want[0])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interval", [4, 6])
def test_stage1_quad_int8_equals_jax(interval):
    """u=1: the four rotations summed in the wrapper (through the port's
    `rotation_ensemble_lanes_quad_int`, which the packed cascade's stage 1
    calls for the int8 (L**4, 16) table), against JAX's."""
    tab = _table(interval, 16, interval)
    img = _image((3,), 10, 15, 2 * interval, interval)
    want = jax.jit(lambda t, x: jens.rotation_ensemble_lanes_quad_int(
        t, x, mode="y", upscale=1, interval=interval))(jnp.asarray(tab),
                                                       jnp.asarray(img))
    got = tens.rotation_ensemble_lanes_quad_int(
        torch.as_tensor(tab), torch.as_tensor(img), mode="y", upscale=1,
        interval=interval)[..., 0]
    assert got.dtype == torch.int32 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., 0])


def _model_corners(f, interval):
    """NumPy model of csrc/window_fold.cu's `simplex_of` on the four frac
    arrays: the 5-comparator sort, the weights and the five corner masks
    from the descending ranks (the later letter wins a tie)."""
    hi_ab, lo_ab = np.maximum(f[0], f[1]), np.minimum(f[0], f[1])
    hi_cd, lo_cd = np.maximum(f[2], f[3]), np.minimum(f[2], f[3])
    mid_hi, mid_lo = np.minimum(hi_ab, hi_cd), np.maximum(lo_ab, lo_cd)
    s = [np.maximum(hi_ab, hi_cd), np.maximum(mid_hi, mid_lo),
         np.minimum(mid_hi, mid_lo), np.minimum(lo_ab, lo_cd)]
    w = [2 ** interval - s[0], s[0] - s[1], s[1] - s[2], s[2] - s[3], s[3]]
    c = {(i, j): (f[i] > f[j]).astype(np.int64)
         for i, j in itertools.combinations(range(4), 2)}
    ranks = [3 - c[0, 1] - c[0, 2] - c[0, 3],
             2 + c[0, 1] - c[1, 2] - c[1, 3],
             1 + c[0, 2] + c[1, 2] - c[2, 3],
             c[0, 3] + c[1, 3] + c[2, 3]]
    masks = [sum((ranks[x] < k).astype(np.int64) << (3 - x)
                 for x in range(4)) for k in range(5)]
    return masks, w


def _kernel_model(tab, xp, taps, origin, grid, interval, u):
    """NumPy model of csrc/window_fold.cu: per site, base and fracs by shift
    and mask, `_model_corners`, and a sum over those five corners only."""
    (oy, ox), (he, we) = origin, grid
    L = 2 ** (8 - interval) + 1
    outs = []
    for rt in taps:
        p = [xp[:, oy + dy: oy + dy + he, ox + dx: ox + dx + we].reshape(-1)
             for dy, dx in rt]
        if u > 1:
            p = [np.pad(x, (0, 8)) for x in p]          # junk sites
        row = np.zeros_like(p[0])
        for x in p:
            row = row * L + (x >> interval)
        masks, w = _model_corners([x & (2 ** interval - 1) for x in p],
                                  interval)
        g = tab[np.clip(row, 0, L ** 4 - 1)].reshape(-1, 16, u)
        acc = 0
        for m, wk in zip(masks, w):
            acc = acc + wk[:, None] * np.take_along_axis(
                g.astype(np.int64), m[:, None, None], axis=1)[:, 0]
        outs.append(acc.T)
    if u == 1:
        return sum(outs).reshape(-1).astype(np.int32)
    return np.stack(outs).astype(np.float32)


# (u, taps, origin of a plane padded by 2 on each side) of each instance
INSTANCES = [
    (8, (mode_taps("s"),), (1, 1)),
    (8, [rotated_taps("y", r) for r in range(4)], (2, 2)),
    (16, [rotated_taps("y", r) for r in range(4)], (2, 2)),
    (64, (mode_taps("d"),), (0, 0)),
    (1, [rotated_taps("y", r) for r in range(4)], (2, 2)),
]


@pytest.mark.parametrize("interval", [4, 6])
@pytest.mark.parametrize("u,taps,origin", INSTANCES)
def test_plain_equals_kernel_model_and_old_k1(u, taps, origin, interval):
    """The wrapper's plain version against the five-corner model of the
    kernel, and (u > 1) each rotation against the JAX-boundary contraction
    `gather_fold_contract_plain(tab, base, corner_lams_t(fracs))` on the
    same planes."""
    tab = _table(interval, 16 * u, u)
    img = _image((2,), 8, 11, u, interval)
    xp = np.pad(img, ((0, 0), (2, 2), (2, 2)), mode="edge")
    grid = (8, 11)
    got = ttk.window_fold_contract(
        torch.as_tensor(tab), torch.as_tensor(xp), taps=taps, origin=origin,
        grid=grid, interval=interval, u=u)
    np.testing.assert_array_equal(
        got.numpy(), _kernel_model(tab, xp, taps, origin, grid, interval, u))
    if u == 1:
        return
    oy, ox = origin
    for r, rt in enumerate(taps):
        planes = [torch.as_tensor(xp[:, oy + dy: oy + dy + 8,
                                     ox + dx: ox + dx + 11])
                  for dy, dx in rt]
        base, fr = tsx._base_and_fracs(planes, interval=interval)
        base, fr = ttk._pad8_base_fracs(base, fr)
        want = ttk.gather_fold_contract_plain(
            torch.as_tensor(tab), base,
            tsx.corner_lams_t(*fr, interval=interval), C=16, u=u)
        assert torch.equal(got[r], want)


@pytest.mark.parametrize("interval", [2, 4])
def test_five_corners_carry_every_weight(interval):
    """Over every fraction quadruple (ties included), the model's five
    (corner, weight) pairs scattered into 16 slots equal `corner_lams_t`:
    the eleven corners the kernel never reads have weight 0."""
    f = np.array(list(itertools.product(range(2 ** interval), repeat=4))).T
    masks, w = _model_corners(f, interval)
    got = np.zeros((16, f.shape[1]), np.float32)
    for m, wk in zip(masks, w):
        assert not got[m, np.arange(f.shape[1])].any()   # distinct corners
        got[m, np.arange(f.shape[1])] = wk
    want = tsx.corner_lams_t(*(torch.as_tensor(x) for x in f),
                             interval=interval).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    "tab dtype", "tab rows", "C", "u", "xp dtype", "xp rank", "interval",
    "rotations", "u1 rotations", "tap left", "tap right", "tap below",
    "device"])
def test_wrapper_refusals(case):
    interval, u = 6, 8
    tab = torch.zeros((625, 128), dtype=torch.int8)
    xp = torch.zeros((2, 10, 12), dtype=torch.int32)
    kw = dict(taps=(mode_taps("s"),), origin=(1, 1), grid=(8, 10),
              interval=interval, u=u)
    match = {"tab dtype": "int8", "tab rows": "int8", "C": "C=16",
             "u": "u must", "xp dtype": "int32", "xp rank": "int32",
             "interval": "interval", "rotations": "rotations",
             "u1 rotations": "rotations", "tap left": "leaves",
             "tap right": "leaves", "tap below": "leaves",
             "device": "device"}[case]
    if case == "tab dtype":
        tab = tab.int()
    elif case == "tab rows":
        tab = tab[:600]
    elif case == "C":
        tab = torch.zeros((625, 5 * u), dtype=torch.int8)
    elif case == "u":
        kw["u"] = 5
        tab = torch.zeros((625, 80), dtype=torch.int8)
    elif case == "xp dtype":
        xp = xp.long()
    elif case == "xp rank":
        xp = xp[0]
    elif case == "interval":
        kw["interval"] = 9
    elif case == "rotations":
        kw["taps"] = [mode_taps("s")] * 5
    elif case == "u1 rotations":
        kw["u"] = 1
        tab = torch.zeros((625, 16), dtype=torch.int8)
    elif case == "tap left":
        kw["origin"] = (1, 0)
        kw["taps"] = (rotated_taps("s", 2),)
    elif case == "tap right":
        kw["grid"] = (8, 11)
    elif case == "tap below":
        kw["origin"] = (2, 1)
    elif case == "device":
        tab, xp = tab.to("meta"), xp.to("meta")
    with pytest.raises(ValueError, match=match):
        ttk.window_fold_contract(tab, xp, **kw)


def test_wrapper_counts_no_cpu_launch():
    """The plain path on CPU tensors does not count as a kernel launch."""
    before = dict(ttk.LAUNCHES)
    tab = torch.as_tensor(_table(6, 128, 0))
    xp = torch.as_tensor(np.pad(_image((1,), 6, 7, 0, 6),
                                ((0, 0), (1, 1), (1, 1)), mode="edge"))
    out = ttk.window_fold_contract(tab, xp, taps=(mode_taps("s"),),
                                   origin=(0, 0), grid=(7, 8), interval=6,
                                   u=8)
    assert out.shape == (1, 8, 7 * 8 + 8)
    assert ttk.LAUNCHES == before
