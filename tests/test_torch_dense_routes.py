"""The port's dense-unit kernel routes of net mode against the JAX package.

K5 (`stage_ensemble_apply_w` on a dense stack: the dense window kernel),
K7 (`stage_ensemble_apply_t`: the feature-major tap matrix), K9
(`stage_ensemble_apply` on a rotation-paired stack) and K10
(`fused_unit_apply`: one dense unit), each through its plain torch version
(CPU tensors), against the JAX Pallas kernel in interpret mode through
its jitted entry; the routes of `srnets_predict_fast` under the JAX package's
flags (`DENSE_LAYOUT`, `PLAIN_WINDOW`, paired stacks), `NetEvaluator` with
MULUT_PAIRED_KERNEL=1, and `srnets_predict(unit_impl="pallas")` in bf16.
Dense units nf=8, x4 `sdy`, 2 stages, images 2x1x7x9 from NumPy seeds.

Tolerances: the net-mode parity rule (ROADMAP.md): kernel outputs may
differ from JAX on at most 1e-3 of entries, by at most 2 output units,
and uint8 images end to end likewise.  The weight layouts, the tap maps
and the tap matrices are byte-equal, and K5's, K7's and K9's raw
accumulators are byte-equal to K4's (all four run one pass body).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

MODES = "sdy"
CFG = dict(modes=MODES, stages=2, scale=4)
_JAX_ENTRIES = (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w,
                juk.stage_ensemble_apply_t, juk.fused_unit_apply)


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
def _pin_routes(monkeypatch):
    """Both packages' default routes (site-major dense, window kernels, rs
    schedule) against environment overrides; the JAX flags are not jit
    keys, so its caches are cleared around each test."""
    monkeypatch.setattr(jsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(jsn, "PLAIN_LAYOUT", "feature")
    monkeypatch.setattr(jsn, "DENSE_LAYOUT", "site")
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", "rs")
    monkeypatch.setattr(tsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(tsn, "DENSE_LAYOUT", "site")
    monkeypatch.delenv("MULUT_PAIRED_KERNEL", raising=False)
    for f in _JAX_ENTRIES:
        f.clear_cache()
    yield
    for f in _JAX_ENTRIES:
        f.clear_cache()


@pytest.fixture(scope="module")
def dense():
    """Seed-0 dense params (NumPy float32, the port's NumPy init, which
    JAX's would only slow down), and per stage the JAX
    site-major stack and the port's stack in the kernels' layout."""
    p = tsn.init_srnets(np.random.default_rng(0), nf=8, arch="dense", **CFG)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    return (p, jsn.stack_srnets_for_fast(bf, **CFG),
            tsn.stack_srnets_for_fast(params_from_numpy(p, "cpu"), **CFG))


def _image(seed: int, shape=(2, 1, 7, 9)):
    """A bf16 stage input for both packages."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.as_tensor(np.asarray(xb, np.float32)).to(torch.bfloat16)


def _assert_close(got, want, *, frac=1e-3, max_abs=2.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


def _assert_mix_close(got: torch.Tensor, want: np.ndarray, mix):
    """A mixed kernel output against JAX's, in output units (greylevels
    for the inner mix, bytes for the packed words)."""
    if mix == "final_pack":
        assert got.dtype == torch.int32
        _assert_close(got.numpy().view(np.uint8), want.view(np.uint8))
    elif mix == "inner":
        assert got.dtype == torch.bfloat16
        _assert_close(got.float().numpy() * 255,
                      want.astype(np.float32) * 255)
    else:
        _assert_close(got.float().numpy(), want.astype(np.float32))


_MIX_ROWS = {None: 16, "inner": 1, "final": 16, "final_u8": 16,
             "final_pack": 4}
_MIXES = [None, "inner", "final", "final_u8", "final_pack"]


@pytest.mark.parametrize("modes", ["sdy", "s", "sd", "y"])
def test_window_tap_rows_equal_jax(modes):
    assert tuk.window_tap_rows(modes) == juk.window_tap_rows(modes)


def test_pair_stage_params_equal_jax(dense):
    """The port's paired stack (kernels' layout) is byte for byte JAX's
    `transpose_plain_stack(pair_stage_params(.))`, and its diagonal blocks
    give back the unpaired stack."""
    _, jst, tst = dense
    for js, ts in zip(jst, tst):
        want = juk.transpose_plain_stack(juk.pair_stage_params(js))
        got = tuk.pair_stage_params(ts)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.bfloat16 and got[k].is_contiguous()
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k]).astype(np.float32),
                err_msg=k)
        back = tuk._unpair_stage_params(got)
        for k in ts:
            assert torch.equal(back[k], ts[k]), k
    with pytest.raises(ValueError, match="dense"):
        tuk.pair_stage_params({"hwt": None})


@pytest.mark.parametrize("mix", _MIXES)
def test_dense_window_plain_equals_jax(dense, mix):
    """K5's plain version against JAX `_dense_w_kernel` on the windows JAX
    cuts from the same bf16 image, both stages."""
    _, jst, tst = dense
    P, offs = juk.window_offsets(MODES)
    Wp, tile = 9 + 2 * P, 256
    lanes = tuple(P * Wp + P + dy * Wp + dx for dy, dx in offs)
    jmix = None if mix is None else (mix, 3)
    for s, (js, ts) in enumerate(zip(jst, tst)):
        xb, xt = _image(10 + s)
        win, (n, _, _, _) = jsn._window_inputs(xb, MODES, tile)
        want = juk.stage_ensemble_apply_w(
            juk.transpose_plain_stack(js), None, win, n_modes=3, offs=lanes,
            tile=tile, interpret=True, mix=jmix,
            tap_rows=juk.window_tap_rows(MODES))
        want = np.asarray(want)[:_MIX_ROWS[mix], :n]
        plane, _ = tsn._window_plane(xt, MODES)
        got = tuk.stage_ensemble_apply_w(ts, plane, modes=MODES, width=Wp,
                                         mix=mix, v=1 if s == 0 else 16)
        assert tuple(got.shape) == want.shape
        _assert_mix_close(got, want, mix)
    assert not any(tuk.LAUNCHES.values())


@pytest.mark.parametrize("mix", _MIXES)
def test_dense_feature_plain_equals_jax(dense, mix):
    """K7's plain version against JAX `_dense_t_kernel` on the same
    feature-major tap matrix (byte-equal to JAX's), both stages."""
    _, jst, tst = dense
    jmix = None if mix is None else (mix, 3)
    for s, (js, ts) in enumerate(zip(jst, tst)):
        xb, xt = _image(20 + s)
        taps_j = jsn._ensemble_taps_t(xb, MODES)
        taps_t = tsn._ensemble_taps_t(xt, MODES)
        np.testing.assert_array_equal(taps_t.float().numpy(),
                                      np.asarray(taps_j).astype(np.float32))
        want = np.asarray(juk.stage_ensemble_apply_t(
            juk.transpose_plain_stack(js), taps_j, n_modes=3, interpret=True,
            mix=jmix))[:_MIX_ROWS[mix]]
        got = tuk.stage_ensemble_apply_t(ts, taps_t, n_modes=3, mix=mix,
                                         v=1 if s == 0 else 16)
        assert tuple(got.shape) == want.shape
        _assert_mix_close(got, want, mix)
    assert not any(tuk.LAUNCHES.values())


def test_paired_plain_equals_jax(dense):
    """K9's plain version against JAX `_pair_ensemble_kernel` on the same
    tap matrix, both stages."""
    _, jst, tst = dense
    for s, (js, ts) in enumerate(zip(jst, tst)):
        xb, xt = _image(30 + s)
        want = np.asarray(juk.stage_ensemble_apply(
            juk.pair_stage_params(js), jsn._ensemble_taps(xb, MODES),
            n_modes=3, interpret=True))
        got = tuk.stage_ensemble_apply(
            tuk.pair_stage_params(ts), tsn._ensemble_taps(xt, MODES),
            n_modes=3, v=1 if s == 0 else 16)
        assert got.dtype == torch.float32
        _assert_close(got.numpy(), want)


def test_raw_accumulators_equal_k4(dense):
    """K5, K7 and K9 (plain versions, raw accumulator) byte-equal K4's on
    the same image: one pass body, four tap and weight forms."""
    _, _, tst = dense
    _, xt = _image(40)
    B, C, H, W = xt.shape
    for s, st in enumerate(tst):
        v = 1 if s == 0 else 16
        k4 = tuk.stage_ensemble_apply(st, tsn._ensemble_taps(xt, MODES),
                                      n_modes=3, v=v)
        k9 = tuk.stage_ensemble_apply(tuk.pair_stage_params(st),
                                      tsn._ensemble_taps(xt, MODES),
                                      n_modes=3, v=v)
        k7 = tuk.stage_ensemble_apply_t(st, tsn._ensemble_taps_t(xt, MODES),
                                        n_modes=3, v=v)
        plane, (Hp, Wp, P) = tsn._window_plane(xt, MODES)
        k5 = tuk.stage_ensemble_apply_w(st, plane, modes=MODES, width=Wp,
                                        v=v)
        k5 = k5.reshape(16, B, C, Hp, Wp)[..., P: P + H, P: P + W]
        assert torch.equal(k9, k4)
        assert torch.equal(k7.T, k4)
        assert torch.equal(k5.reshape(16, -1).T, k4)


def _u8_close(got, want, *, frac=1e-3, max_abs=2):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


@pytest.mark.parametrize("layout,window,paired,final_clip", [
    ("feature", True, False, "pack"),
    ("feature", False, False, False),
    ("site", True, True, False),
    # paired stacks stay site-major under "feature" (K9, not K5 or K7)
    ("feature", True, True, False),
])
def test_predict_fast_routes_equal_jax(dense, monkeypatch, layout, window,
                                       paired, final_clip):
    """`srnets_predict_fast` end to end under each dense route's flags,
    the same flags set in both packages."""
    p, _, _ = dense
    for mod in (jsn, tsn):
        monkeypatch.setattr(mod, "DENSE_LAYOUT", layout)
        monkeypatch.setattr(mod, "PLAIN_WINDOW", window)
    x = np.random.default_rng(1).random((2, 1, 7, 9)).astype(np.float32)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jst = jsn.stack_srnets_for_fast(bf, paired=paired, **CFG)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict_fast(
        jst, a, interpret=True, final_clip=final_clip, **CFG))(
            jnp.asarray(x)))
    tst = tsn.stack_srnets_for_fast(params_from_numpy(p, "cpu"),
                                    paired=paired, **CFG)
    called = {}
    for name in ("stage_ensemble_apply", "stage_ensemble_apply_w",
                 "stage_ensemble_apply_t"):
        def spy(*a, _n=name, _f=getattr(tuk, name), **k):
            called[_n] = called.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(tuk, name, spy)
    got = tsn.srnets_predict_fast(tst, torch.as_tensor(x),
                                  final_clip=final_clip, **CFG)
    route = ("stage_ensemble_apply" if paired or layout == "site" else
             "stage_ensemble_apply_w" if window else "stage_ensemble_apply_t")
    assert called == {route: 2}
    assert got.shape == (2, 1, 28, 36)
    if final_clip == "pack" and route != "stage_ensemble_apply":
        assert got.dtype == torch.uint8 and want.dtype == np.uint8
    _u8_close(got.float().numpy(), want.astype(np.float32))


def test_net_evaluator_paired_kernel(dense, monkeypatch):
    """MULUT_PAIRED_KERNEL=1 at construction gives paired stacks (K9) and
    the unpaired evaluator's bytes; plain units refuse to pair, as in the
    JAX package."""
    p, _, _ = dense
    imgs = np.random.default_rng(2).integers(0, 256, (2, 9, 11, 3)).astype(
        np.uint8)
    base = NetEvaluator(p, fast=True, device="cpu", **CFG)
    monkeypatch.setenv("MULUT_PAIRED_KERNEL", "1")
    paired = NetEvaluator(p, fast=True, device="cpu", **CFG)
    assert paired.stacked[0]["w2t"].shape == (3, 16, 16)
    np.testing.assert_array_equal(paired.upscale_batch(imgs),
                                  base.upscale_batch(imgs))
    plain = tsn.init_srnets(np.random.default_rng(1), nf=8, arch="mxu",
                            **CFG)
    with pytest.raises(ValueError, match="dense"):
        NetEvaluator(plain, fast=True, device="cpu", **CFG)


@pytest.fixture
def interpret_unit_kernel(monkeypatch):
    """JAX `fused_unit_apply` (no interpret flag) with its pallas_call in
    interpret mode; its jit cache is cleared by `_pin_routes`."""
    monkeypatch.setattr(juk.pl, "pallas_call", functools.partial(
        juk.pl.pallas_call, interpret=True))


def _bf16_params(p):
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = {k: {n: torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16) for n, a in u.items()} for k, u in bf.items()}
    return bf, tp


@pytest.mark.parametrize("unit,out_dim", [("s1_s", 1), ("s2_y", 16)])
def test_fused_unit_plain_equals_jax(dense, interpret_unit_kernel, unit,
                                     out_dim):
    """K10's plain version against JAX `_kernel` (interpret mode) on
    3000 bf16 tap rows (not a tile multiple)."""
    p, _, _ = dense
    bf, tp = _bf16_params(p)
    taps = jnp.asarray(np.random.default_rng(3).random((3000, 4)),
                       jnp.bfloat16)
    want = np.asarray(jax.jit(lambda t: juk.fused_unit_apply(
        bf[unit], t, out_dim=out_dim))(taps)).astype(np.float32)
    got = tuk.fused_unit_apply(
        tp[unit], torch.as_tensor(np.asarray(taps, np.float32)).to(
            torch.bfloat16), out_dim=out_dim)
    assert got.dtype == torch.bfloat16 and got.shape == (3000, out_dim)
    _assert_close(got.float().numpy(), want, max_abs=2 / 127)


def test_srnets_predict_pallas_equals_jax(dense, interpret_unit_kernel,
                                          monkeypatch):
    """bf16 `srnets_predict(unit_impl="pallas")` end to end against JAX
    (phase "valid"), in the JAX dtype flow; plain units with
    unit_impl="pallas" take the non-kernel unit and never reach K10."""
    p, _, _ = dense
    bf, tp = _bf16_params(p)
    xb, xt = _image(4)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict(
        bf, a, phase="valid", unit_impl="pallas", **CFG))(xb))
    calls = []
    fused = tuk.fused_unit_apply
    monkeypatch.setattr(tuk, "fused_unit_apply",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    got = tsn.srnets_predict(tp, xt, unit_impl="pallas", **CFG)
    assert got.dtype == torch.bfloat16 and len(calls) == 6
    _u8_close(got.float().numpy(), want.astype(np.float32))
    plain = tsn.init_srnets(np.random.default_rng(5), nf=8, arch="mxu",
                            **CFG)
    _, tplain = _bf16_params(plain)
    calls.clear()
    out = tsn.srnets_predict(tplain, xt, unit_impl="pallas", **CFG)
    assert not calls and not any(tuk.LAUNCHES.values())
    assert torch.equal(out, tsn.srnets_predict(tplain, xt, **CFG))
    with pytest.raises(ValueError, match="unit_impl"):
        tsn.srnets_predict(tp, xt, unit_impl="mosaic", **CFG)


def test_cuda_refusals(dense):
    """What the CUDA kernels are not built for raises before any launch:
    another nf than 64, a paired stack off the site-major route."""
    _, _, tst = dense
    st = tst[1]
    plane = torch.zeros(300, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="nf=64"):
        tuk._launch_dense("dense_window", st, plane, plane, n=300, modes=3,
                          v=16, arg=0)
    paired = tuk.pair_stage_params(st)
    with pytest.raises(ValueError, match="site-major"):
        tuk.stage_ensemble_apply_w(paired, plane, modes=MODES, width=10)
    with pytest.raises(ValueError, match="site-major"):
        tuk.stage_ensemble_apply_t(paired, torch.zeros(
            (48, 5), dtype=torch.bfloat16), n_modes=3)


def test_srnets_predict_tiled_pallas(dense, monkeypatch):
    """`srnets_predict_tiled(unit_impl="pallas")` passes the unit route on
    and equals the untiled bf16 forward."""
    p, _, _ = dense
    _, tp = _bf16_params(p)
    _, xt = _image(6, (1, 1, 20, 9))
    calls = []
    fused = tuk.fused_unit_apply
    monkeypatch.setattr(tuk, "fused_unit_apply",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    got = tsn.srnets_predict_tiled(tp, xt, band=4, halo=4, unit_impl="pallas",
                                   **CFG)
    assert len(calls) == 6 * 5 and got.dtype == torch.bfloat16
    assert torch.equal(got, tsn.srnets_predict(tp, xt, unit_impl="pallas",
                                               **CFG))
