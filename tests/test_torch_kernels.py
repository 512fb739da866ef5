"""The port's two kernel wrappers against the JAX Pallas kernels.

K1 `gather_fold_contract(tab, base, wt)` against `fold_contract(jnp.take(
tab, base), wt, interpret=True)`; K2 `tail_assemble` against the JAX
`tail_assemble(..., interpret=True)`.  Here the wrappers get CPU tensors and
run their plain torch versions (the CUDA kernels are held against those
same plain versions on the card by chip_smoke.py).  Tolerance: exact
equality — the contraction is integer-valued float32 below 2**24 and the
tail's mix is integer arithmetic, so every summation order gives the same
bytes.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mulut_tpu.ops import tail_kernel as jtk
from mulut_tpu_torch.ops import tail_kernel as ttk
from mulut_tpu_torch.ops.taps import fold_geometry, lane_rotation_perm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C,u,n", [(16, 8, 3000), (16, 16, 1000),
                                   (16, 64, 517)])
def test_fold_contract_equals_jax(C, u, n):
    rng = np.random.default_rng(u)
    rows = 625
    tab = rng.integers(-128, 128, (rows, C * u)).astype(np.int8)
    base = rng.integers(0, rows, n + 8).astype(np.int32)
    base[n:] = 0                                        # junk lanes
    wt = rng.integers(0, 17, (C, n + 8)).astype(np.float32)
    wt[:, n:] = 0.0
    got = ttk.gather_fold_contract(torch.as_tensor(tab),
                                   torch.as_tensor(base),
                                   torch.as_tensor(wt), C=C, u=u)
    want = jtk.fold_contract(jnp.take(jnp.asarray(tab), jnp.asarray(base),
                                      axis=0),
                             jnp.asarray(wt), C=C, u=u, interpret=True)
    assert got.shape == (u, n + 8) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[:, n:].any()


def test_fold_contract_clamps_like_take_clip():
    rng = np.random.default_rng(2)
    tab = rng.integers(-128, 128, (50, 128)).astype(np.int8)
    base = np.array([-3, 0, 49, 50, 400], np.int32)
    wt = rng.integers(0, 17, (16, 5)).astype(np.float32)
    got = ttk.gather_fold_contract(torch.as_tensor(tab),
                                   torch.as_tensor(base),
                                   torch.as_tensor(wt), C=16, u=8)
    want = jtk.fold_contract(
        jnp.take(jnp.asarray(tab), jnp.asarray(base), axis=0, mode="clip"),
        jnp.asarray(wt), C=16, u=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tail_inputs(rng, lead, h, w, fold_modes, quad_modes):
    """Random integer-valued mode buffers of the packed cascade's final
    stage geometry (as folded_flat / quad_flat lay them out)."""
    bc = math.prod(lead)
    v = 16
    folded, quads = [], []
    for mode in fold_modes:
        geo = fold_geometry(mode)
        my = -min(s[0] for s, _ in geo)
        mx = -min(s[1] for s, _ in geo)
        he, we = h + my + 1, ttk._pad128(w + mx)
        offs = [(sy + my) * we + (sx + mx) for (sy, sx), _ in geo]
        ext = rng.integers(-2032, 2033, (4 * v, bc * he * we + 8))
        folded.append((ext.astype(np.float32), he, we, offs))
    for _ in quad_modes:
        wy = ttk._pad128(w)
        outs = [rng.integers(-2032, 2033, (v, bc * (h + 1) * wy + 8))
                .astype(np.float32) for _ in range(4)]
        quads.append((outs, wy, [lane_rotation_perm(4, r)
                                 for r in range(4)]))
    return folded, quads


@pytest.mark.parametrize(
    "lead,h,w,fold_modes,quad_modes",
    [
        ((2,), 13, 57, "sd", "y"),      # the default sdy formats
        ((1, 3), 8, 130, "sd", "y"),    # w > 128, 2-D lead
        ((1,), 9, 20, "", "sdy"),       # every mode through the quad path
        ((2,), 6, 33, "sde", ""),       # folded modes only
    ],
)
def test_tail_assemble_equals_jax(lead, h, w, fold_modes, quad_modes):
    rng = np.random.default_rng(h * w)
    folded, quads = _tail_inputs(rng, lead, h, w, fold_modes, quad_modes)
    davg = 16 * (len(fold_modes) + len(quad_modes))
    want = jtk.tail_assemble(
        [(jnp.asarray(e).T, he, we, o) for e, he, we, o in folded],
        [([jnp.asarray(x).T for x in outs], wy, p) for outs, wy, p in quads],
        lead=lead, h=h, w=w, scale=4, davg=davg, interpret=True)
    # (u, Np) buffers seen through their transpose, as the cascade hands
    # the fold kernel's outputs over
    got = ttk.tail_assemble(
        [(torch.as_tensor(e).T, he, we, o) for e, he, we, o in folded],
        [([torch.as_tensor(x).T for x in outs], wy, p)
         for outs, wy, p in quads],
        lead=lead, h=h, w=w, scale=4, davg=davg)
    want = np.asarray(want)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        ttk.unpack_u32(got, lead, h, w, 4),
        jtk.unpack_u32(want, lead, h, w, 4))


def test_unpack_u32_device_matches_host():
    rng = np.random.default_rng(4)
    lead, h, w = (2, 3), 5, 70
    packed = rng.integers(0, 2 ** 32, (6 * h, 4, 128)).astype(np.uint32)
    got = ttk.unpack_u32_device(torch.as_tensor(packed.view(np.int32)),
                                lead, h, w, 4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  jtk.unpack_u32(packed, lead, h, w, 4))


def test_wrappers_check_inputs():
    tab = torch.zeros((10, 128), dtype=torch.int8)
    base = torch.zeros(4, dtype=torch.int32)
    wt = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="int8"):
        ttk.gather_fold_contract(tab.int(), base, wt, C=16, u=8)
    with pytest.raises(ValueError, match="int32"):
        ttk.gather_fold_contract(tab, base.long(), wt, C=16, u=8)
    with pytest.raises(ValueError, match="float32"):
        ttk.gather_fold_contract(tab, base, wt[:, :3], C=16, u=8)
    with pytest.raises(ValueError, match="device"):
        ttk.gather_fold_contract(tab.to("meta"), base.to("meta"),
                                 wt.to("meta"), C=16, u=8)
    rng = np.random.default_rng(0)
    folded, quads = _tail_inputs(rng, (1,), 4, 20, "s", "y")
    ext, he, we, offs = folded[0]
    short = torch.as_tensor(ext[:, :-200]).T
    with pytest.raises(ValueError, match="sites"):
        ttk.tail_assemble([(short, he, we, offs)], [], lead=(1,), h=4, w=20,
                          scale=4, davg=32)
    with pytest.raises(NotImplementedError, match="x4"):
        ttk.tail_assemble([(torch.as_tensor(ext).T, he, we, offs)], [],
                          lead=(1,), h=4, w=20, scale=2, davg=32)
