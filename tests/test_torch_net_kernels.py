"""The port's net-mode kernel wrappers against the JAX Pallas kernels.

K3 `stage_ensemble_apply_w` (plain units over the flat padded plane)
against JAX `stage_ensemble_apply_w(..., interpret=True)` on the windows
JAX cuts from the same image, under every mix epilogue; K4
`stage_ensemble_apply` (dense units over the tap matrix) against JAX
`stage_ensemble_apply(..., interpret=True)`.  The wrappers get CPU tensors
and run their plain torch versions (the CUDA kernels are held against
those plain versions on the card by chip_smoke.py).  Every JAX call runs
under `jax.jit`, as `NetEvaluator` runs it, so its stage mixes take XLA's
jitted form.

Tolerances: the raw accumulators and the mixed outputs may differ on at
most 1e-3 of entries, by at most 2 (in output units; 1/255 for the inner
mix), since float32 matmul sums and tanh differ in the last bits between
XLA-CPU and torch and can flip a round(127 * tanh) tie; the inner-mix
helper, the K4 head and the weight stacks are byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu.models.srnet import init_srnets as jax_init_srnets
from mulut_tpu.ops.taps import rotated_taps
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.srnet import _ensemble_taps, _window_plane
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import unit_kernel as tuk

MODES = "sdy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pin_jax_routes(monkeypatch):
    """Pin the JAX package's default net-mode routes (window kernel, rs
    schedule, site-major dense) against environment overrides; the flags
    are not jit keys, so the caches are cleared around the test."""
    monkeypatch.setattr(jsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(jsn, "PLAIN_LAYOUT", "feature")
    monkeypatch.setattr(jsn, "DENSE_LAYOUT", "site")
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", "rs")
    monkeypatch.setattr(tsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(tsn, "PLAIN_LAYOUT", "feature")
    for f in (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w):
        f.clear_cache()
    yield
    for f in (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w):
        f.clear_cache()


def _params(arch: str, nf: int, seed: int):
    """Same float32 params for both packages: JAX init -> NumPy."""
    p = jax_init_srnets(jax.random.PRNGKey(seed), nf=nf, scale=4,
                        modes=MODES, stages=2, arch=arch)
    return jax.tree_util.tree_map(np.asarray, p)


def _stacks(params_np):
    jst = [juk.stack_stage_params(params_np, stage=s, modes=MODES,
                                  upscale=4 if s == 2 else 1)
           for s in (1, 2)]
    tp = params_from_numpy(params_np, "cpu")
    tst = [tuk.stack_stage_params(tp, stage=s, modes=MODES,
                                  upscale=4 if s == 2 else 1)
           for s in (1, 2)]
    return jst, tst


def _assert_close(got, want, *, frac=1e-3, max_abs=2.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


def test_inner_mix_matches_jit_on_every_tie():
    """Every tie acc = 6 (mod 12) in [-1524, 1524]: byte-equal to JAX's
    jitted round(acc / 12 + 127) mix, where an exact division is not."""
    acc = np.arange(-1524, 1525, dtype=np.float32)
    acc = acc[(acc.astype(np.int64) % 12) == 6]
    assert acc.size == 254
    want = np.asarray(jax.jit(lambda a: (jnp.clip(
        jnp.round(a / 12 + 127.0), 0, 255) / 255.0).astype(jnp.bfloat16))(
            jnp.asarray(acc))).astype(np.float32)
    got = tuk.inner_mix(torch.as_tensor(acc), 3).float().numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.clip(np.round(acc / np.float32(12) + np.float32(127)), 0, 255)
    jit_mixed = np.round(want * 255)
    assert (exact != jit_mixed).mean() > 0.05    # the division form differs
    f32 = tuk.inner_mix(torch.as_tensor(acc), 3, dtype=torch.float32)
    want32 = np.asarray(jax.jit(lambda a: jnp.clip(
        jnp.round(a / 12 + 127.0), 0, 255) / 255.0)(jnp.asarray(acc)))
    np.testing.assert_array_equal(f32.numpy(), want32)


@pytest.mark.parametrize("arch", ["mxu", "dense"])
def test_stack_and_transpose_equal_jax(arch):
    p = _params(arch, 16, 1)
    jst, tst = _stacks(p)
    for js, ts in zip(jst, tst):
        assert set(js) == set(ts)
        for k in js:
            assert ts[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                ts[k].float().numpy(), np.asarray(js[k]).astype(np.float32),
                err_msg=k)
        jt, tt = juk.transpose_plain_stack(js), tuk.transpose_plain_stack(ts)
        assert set(jt) == set(tt)
        for k in jt:
            assert tt[k].is_contiguous()
            np.testing.assert_array_equal(
                tt[k].float().numpy(), np.asarray(jt[k]).astype(np.float32),
                err_msg=k)


def test_window_offsets_and_plane_geometry():
    assert tuk.window_offsets(MODES) == juk.window_offsets(MODES)
    x = torch.arange(2 * 1 * 5 * 6, dtype=torch.float32).reshape(2, 1, 5, 6)
    plane, (Hp, Wp, P) = _window_plane(x, MODES)
    assert (Hp, Wp, P) == (9, 10, 2)
    assert plane.shape == (2 * Hp * Wp,)
    offs = tuk.plane_tap_offsets(MODES, Wp)
    # site (b, y, x) of the padded domain reads its taps at p + dy*Wp + dx
    p = (1 * Hp + P + 2) * Wp + P + 2          # image pixel (1, 0, 2, 2)
    for r in range(4):
        for (dy, dx), o in zip(rotated_taps("y", r), offs[2][r]):
            assert plane[p + o] == x[1, 0, 2 + dy, 2 + dx]


_MIX_ROWS = {None: 16, "inner": 1, "final": 16, "final_u8": 16,
             "final_pack": 4}


@pytest.mark.parametrize("mix", [None, "inner", "final", "final_u8",
                                 "final_pack"])
def test_window_kernel_plain_equals_jax(mix):
    """K3's plain version against the JAX window kernel, stage by stage,
    from the same stage input (nf=16, depth 2, 2x1x7x9)."""
    p = _params("mxu", 16, 2)
    jst, tst = _stacks(p)
    rng = np.random.default_rng(3)
    x = rng.random((2, 1, 7, 9)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    P, offs = juk.window_offsets(MODES)
    Wp, tile = 9 + 2 * P, 256
    for s, (js, ts) in enumerate(zip(jst, tst)):
        jst_t = juk.transpose_plain_stack(js)
        w1e = juk.scatter_window_heads(js, MODES)
        win, (n, _, Wp_, _) = jsn._window_inputs(xb, MODES, tile)
        assert Wp_ == Wp
        S = P * Wp + P
        lanes = tuple(S + dy * Wp + dx for dy, dx in offs)
        jmix = None if mix is None else (mix, 3)
        want = jax.jit(lambda w, j=jst_t, e=w1e: juk.stage_ensemble_apply_w(
            j, e, w, n_modes=3, offs=lanes, tile=tile, interpret=True,
            mix=jmix))(win)
        want = np.asarray(want)[:_MIX_ROWS[mix], :n]
        plane, _ = _window_plane(torch.as_tensor(np.array(
            xb.astype(jnp.float32))).to(torch.bfloat16), MODES)
        got = tuk.stage_ensemble_apply_w(
            tuk.transpose_plain_stack(ts), plane, modes=MODES, width=Wp,
            mix=mix, v=1 if s == 0 else 16)
        assert tuple(got.shape) == want.shape
        if mix == "final_pack":
            assert got.dtype == torch.int32
            _assert_close(got.numpy().view(np.uint8), want.view(np.uint8))
        elif mix == "inner":
            assert got.dtype == torch.bfloat16
            _assert_close(got.float().numpy() * 255,
                          want.astype(np.float32) * 255)
        else:
            _assert_close(got.float().numpy(), want.astype(np.float32))
        assert not any(tuk.LAUNCHES.values())
        # the next stage's input: the x4 stage reads the inner output
        xb = jax.jit(lambda w, j=jst_t, e=w1e: juk.stage_ensemble_apply_w(
            j, e, w, n_modes=3, offs=lanes, tile=tile, interpret=True,
            mix=("inner", 3)))(win)[0, :n].reshape(2, 1, 7 + 2 * P, Wp)[
                :, :, P: P + 7, P: P + 9]


def test_dense_kernel_plain_equals_jax():
    """K4's plain version against the JAX dense ensemble kernel on the
    same bf16 tap matrix, both stages (nf=8 dense, 2x1x6x7)."""
    p = _params("dense", 8, 4)
    jst, tst = _stacks(p)
    x = np.random.default_rng(5).random((2, 1, 6, 7)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    taps_j = jsn._ensemble_taps(xb, MODES)
    taps_t = _ensemble_taps(torch.as_tensor(x).to(torch.bfloat16), MODES)
    np.testing.assert_array_equal(taps_t.float().numpy(),
                                  np.asarray(taps_j).astype(np.float32))
    for s, (js, ts) in enumerate(zip(jst, tst)):
        want = np.asarray(jax.jit(lambda t, j=js: juk.stage_ensemble_apply(
            j, t, n_modes=3, interpret=True))(taps_j))
        got = tuk.stage_ensemble_apply(tuk.transpose_plain_stack(ts), taps_t,
                                       n_modes=3, v=1 if s == 0 else 16)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _assert_close(got.numpy(), want)


def test_dense_head_bit_equal_to_jax():
    """The K4 head's bf16 chain (every product and partial sum rounded)
    is byte-equal to the JAX kernel's broadcast head under jit."""
    rng = np.random.default_rng(6)
    t = rng.random((2500, 4)).astype(np.float32)
    w1 = (rng.standard_normal((4, 80)) * 0.7).astype(np.float32)
    b1 = (rng.standard_normal(80) * 0.1).astype(np.float32)

    def jhead(t, w1, b1):
        x = None
        for k in range(4):
            term = t[:, k: k + 1] * w1[k: k + 1, :]
            x = term if x is None else x + term
        return jnp.maximum(x + b1[None, :], 0).astype(jnp.bfloat16)

    bf = jnp.bfloat16
    want = np.asarray(jax.jit(jhead)(jnp.asarray(t, bf), jnp.asarray(w1, bf),
                                     jnp.asarray(b1, bf))).astype(np.float32)
    got = tuk._dense_head(torch.as_tensor(t).to(torch.bfloat16),
                          torch.as_tensor(w1).to(torch.bfloat16),
                          torch.as_tensor(b1).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrappers_check_inputs(monkeypatch):
    tp = params_from_numpy(_params("mxu", 16, 7), "cpu")
    plain = tuk.stack_stage_params(tp, stage=2, modes=MODES, upscale=4)
    plain_t = tuk.transpose_plain_stack(plain)
    plane = torch.zeros(200, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mix"):
        tuk.stage_ensemble_apply_w(plain_t, plane, modes=MODES, width=10,
                                   mix="mid")
    with pytest.raises(ValueError, match="bfloat16"):
        tuk.stage_ensemble_apply_w(plain_t, plane.float(), modes=MODES,
                                   width=10)
    with pytest.raises(ValueError, match="modes"):
        tuk.stage_ensemble_apply_w(plain_t, plane, modes="sd", width=10)
    with pytest.raises(ValueError, match="device"):
        tuk.stage_ensemble_apply_w(plain_t, plane.to("meta"), modes=MODES,
                                   width=10)
    taps = torch.zeros((5, 48), dtype=torch.bfloat16)
    # plain stacks over the site-major tap matrix run K8, which has no
    # packed epilogue
    out = tuk.stage_ensemble_apply(plain_t, taps, n_modes=3)
    assert out.shape == (5, 16) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="mix"):
        tuk.stage_ensemble_apply(plain_t, taps, n_modes=3, mix="final_pack")
    dp = params_from_numpy(_params("dense", 8, 7), "cpu")
    dense = tuk.transpose_plain_stack(
        tuk.stack_stage_params(dp, stage=2, modes=MODES, upscale=4))
    with pytest.raises(ValueError, match="mix"):
        tuk.stage_ensemble_apply(dense, taps, n_modes=3, mix="final")
    # plain stacks with PLAIN_WINDOW off take the tap-matrix kernel K6
    out = tuk.stage_ensemble_apply_t(plain_t, taps.T.contiguous(), n_modes=3)
    assert out.shape == (16, 5) and out.dtype == torch.float32
    monkeypatch.setattr(tsn, "PLAIN_WINDOW", False)
    out = tsn.srnets_predict_fast([plain_t, plain_t], torch.zeros(1, 1, 5, 6),
                                  modes=MODES, stages=2, scale=4)
    assert out.shape == (1, 1, 20, 24)
    assert not any(tuk.LAUNCHES.values())
    # quantized stacks go to K11 in its own layout (hwqt); the JAX
    # package's layout (hwq) is refused
    with pytest.raises(ValueError, match="hwqt"):
        tuk.stage_ensemble_apply(dict(dense, hwq=dense["w2t"]), taps,
                                 n_modes=3)
    with pytest.raises(ValueError, match="taps"):
        tuk.stage_ensemble_apply(dense, taps[:, :40], n_modes=3)
    with pytest.raises(ValueError, match="bfloat16"):
        tuk.stage_ensemble_apply(dict(dense, w3t=dense["w3t"].float()), taps,
                                 n_modes=3)
