"""The port's plain-unit kernel routes of net mode against the JAX package.

K6 (`stage_ensemble_apply_t` on a plain stack: K3's function over the
feature-major tap matrix) and K8 (`stage_ensemble_apply` on a plain stack:
over the site-major tap matrix, with the head `PLAIN_HEAD` picks), each
through its plain torch version (CPU tensors), against the JAX Pallas
kernels in interpret mode through their jitted entries, under every JAX
schedule of the route (the schedules only reorder the TPU's instructions;
the port has one kernel per contract); the routes of `srnets_predict_fast`
under the JAX package's flags (`PLAIN_WINDOW`, `PLAIN_LAYOUT`,
`PLAIN_HEAD`); `NetEvaluator` under each route.  Plain (mxu-arch) units
nf=16, depth 2, x4 `sdy`, 2 stages, a 1x1x5x6 image from NumPy seeds.

Tolerances: the net-mode parity rule (ROADMAP.md): kernel outputs may
differ from JAX on at most 1e-3 of entries, by at most 2 output units,
and uint8 images end to end likewise (>= 99.9% equal, max |diff| <= 2).
K6's and K8's raw accumulators with the float32 head are byte-equal to
K3's (one pass body), and their routes' images to the K3 route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu.pipelines.evaluate import NetEvaluator as JaxNetEvaluator
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

MODES = "sdy"
CFG = dict(modes=MODES, stages=2, scale=4)
SHAPE = (1, 1, 5, 6)
_JAX_ENTRIES = (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w,
                juk.stage_ensemble_apply_t)
_MIXES = [None, "inner", "final", "final_u8", "final_pack"]


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
    """Both packages' default routes (window kernel, rs feature-major
    schedule, pass-major site schedule, mxu head) against environment
    overrides; the JAX flags are not jit keys, so its caches are cleared
    around each test."""
    monkeypatch.setattr(jsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(jsn, "PLAIN_LAYOUT", "feature")
    monkeypatch.setattr(jsn, "DENSE_LAYOUT", "site")
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", "rs")
    monkeypatch.setattr(juk, "PLAIN_SCHEDULE", "pass")
    monkeypatch.setattr(juk, "PLAIN_INTERLEAVE", False)
    monkeypatch.setattr(juk, "PLAIN_HEAD", "mxu")
    monkeypatch.setattr(tsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(tsn, "PLAIN_LAYOUT", "feature")
    monkeypatch.setattr(tsn, "DENSE_LAYOUT", "site")
    monkeypatch.setattr(tuk, "PLAIN_HEAD", "mxu")
    for f in _JAX_ENTRIES:
        f.clear_cache()
    yield
    for f in _JAX_ENTRIES:
        f.clear_cache()


@pytest.fixture(scope="module")
def plain():
    """Seed-0 plain params (JAX init -> NumPy float32), and per stage the
    JAX site-major stack and the port's stack in the kernels' layout."""
    p = jax.tree_util.tree_map(np.asarray, jsn.init_srnets(
        jax.random.PRNGKey(0), nf=16, arch="mxu", **CFG))
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    return (p, jsn.stack_srnets_for_fast(bf, **CFG),
            tsn.stack_srnets_for_fast(params_from_numpy(p, "cpu"), **CFG))


def _image(seed: int, shape=SHAPE):
    """A bf16 stage input for both packages."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.as_tensor(np.asarray(xb, np.float32)).to(torch.bfloat16)


def _close(got, want, *, frac=1e-3, max_abs=2.0):
    got = np.asarray(got).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


def _mix_close(got: torch.Tensor, want: np.ndarray, mix):
    """A mixed kernel output against JAX's, in output units (greylevels
    for the inner mix, bytes for the packed words)."""
    if mix == "final_pack":
        assert got.dtype == torch.int32
        _close(got.numpy().view(np.uint8), want.view(np.uint8))
    elif mix == "inner":
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy() * 255, want.astype(np.float32) * 255)
    else:
        assert got.dtype == (torch.bfloat16 if mix == "final_u8"
                             else torch.float32)
        _close(got.float().numpy(), want.astype(np.float32))


def _stages(mix):
    """The stages whose output an epilogue is: the inner mix is stage 1's,
    the final ones stage 2's, the raw accumulator both."""
    return (0, 1) if mix is None else (0,) if mix == "inner" else (1,)


def _site(js, ts, xb, xt, mix, v):
    """K8 on one stage: (JAX, port), both site-major, the port's inner
    column against JAX's lane 0."""
    jmix = None if mix is None else (mix, 3)
    want = np.asarray(jax.jit(lambda t: juk.stage_ensemble_apply(
        js, t, n_modes=3, interpret=True, mix=jmix))(
            jsn._ensemble_taps(xb, MODES)))
    got = tuk.stage_ensemble_apply(ts, tsn._ensemble_taps(xt, MODES),
                                   n_modes=3, v=v, mix=mix)
    if mix == "inner":
        assert got.shape == (want.shape[0], 1)
        want = want[:, :1]
    return got, want


@pytest.mark.parametrize("schedule", [
    "pass", "iv", "ivg2", "ivg3", "ivg4", "ivg6", "rs", "rsiv",
    "interleave"])
def test_site_plain_equals_jax_schedules(plain, monkeypatch, schedule):
    """K8's plain version (mxu head, raw accumulator) against every JAX
    site-major body: `PLAIN_SCHEDULE` and `PLAIN_INTERLEAVE=True`, on the
    x4 stage (all 16 lanes)."""
    _, jst, tst = plain
    if schedule == "interleave":
        monkeypatch.setattr(juk, "PLAIN_INTERLEAVE", True)
    else:
        monkeypatch.setattr(juk, "PLAIN_SCHEDULE", schedule)
    xb, xt = _image(10)
    got, want = _site(jst[1], tst[1], xb, xt, None, 16)
    _mix_close(got, want, None)
    assert not any(tuk.LAUNCHES.values())


@pytest.mark.parametrize("mix", _MIXES[:4])
def test_site_plain_vpu_head_equals_jax(plain, monkeypatch, mix):
    """K8's plain version with the bf16 broadcast-chain head
    (PLAIN_HEAD = "vpu" in both packages) under each site-major epilogue,
    on the stages whose output it is."""
    _, jst, tst = plain
    monkeypatch.setattr(juk, "PLAIN_HEAD", "vpu")
    monkeypatch.setattr(tuk, "PLAIN_HEAD", "vpu")
    for s in _stages(mix):
        xb, xt = _image(20 + s)
        got, want = _site(jst[s], tst[s], xb, xt, mix, 1 if s == 0 else 16)
        _mix_close(got, want, mix)


def test_vpu_head_is_another_function(plain, monkeypatch):
    """The two heads give different raw accumulators on the same input
    (the chain rounds every product and partial sum to bf16)."""
    _, _, tst = plain
    _, xt = _image(25, (2, 1, 12, 14))
    taps = tsn._ensemble_taps(xt, MODES)
    mxu = tuk.stage_ensemble_apply(tst[1], taps, n_modes=3)
    monkeypatch.setattr(tuk, "PLAIN_HEAD", "vpu")
    vpu = tuk.stage_ensemble_apply(tst[1], taps, n_modes=3)
    assert not torch.equal(mxu, vpu)


@pytest.mark.parametrize("schedule,mix", [
    ("pass", None), ("rs", None), ("rsiv", None)]
    + [("rs", m) for m in _MIXES[1:]])
def test_feature_plain_equals_jax(plain, monkeypatch, schedule, mix):
    """K6's plain version against JAX `stage_ensemble_apply_t` on the same
    feature-major tap matrix (byte-equal to JAX's), for each
    `PLAIN_T_SCHEDULE` body and each epilogue, on the stages whose output
    it is."""
    _, jst, tst = plain
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", schedule)
    jmix = None if mix is None else (mix, 3)
    rows = {None: 16, "inner": 1, "final": 16, "final_u8": 16,
            "final_pack": 4}[mix]
    for s in _stages(mix):
        js, ts = jst[s], tst[s]
        xb, xt = _image(30 + s)
        taps_j = jsn._ensemble_taps_t(xb, MODES)
        taps_t = tsn._ensemble_taps_t(xt, MODES)
        np.testing.assert_array_equal(taps_t.float().numpy(),
                                      np.asarray(taps_j).astype(np.float32))
        want = np.asarray(jax.jit(lambda t, j=js: juk.stage_ensemble_apply_t(
            juk.transpose_plain_stack(j), t, n_modes=3, interpret=True,
            mix=jmix))(taps_j))[:rows]
        got = tuk.stage_ensemble_apply_t(ts, taps_t, n_modes=3, mix=mix,
                                         v=1 if s == 0 else 16)
        assert tuple(got.shape) == want.shape
        _mix_close(got, want, mix)
    assert not any(tuk.LAUNCHES.values())


def _set_route(monkeypatch, route):
    """The same route flags in both packages."""
    window, layout, head = {"K6": (False, "feature", "mxu"),
                            "K8": (True, "site", "mxu"),
                            "K8 vpu": (True, "site", "vpu")}[route]
    for sn, uk in ((jsn, juk), (tsn, tuk)):
        monkeypatch.setattr(sn, "PLAIN_WINDOW", window)
        monkeypatch.setattr(sn, "PLAIN_LAYOUT", layout)
        monkeypatch.setattr(uk, "PLAIN_HEAD", head)


_ROUTE_WRAPPER = {"K6": "stage_ensemble_apply_t",
                  "K8": "stage_ensemble_apply",
                  "K8 vpu": "stage_ensemble_apply"}


@pytest.mark.parametrize("route", ["K6", "K8", "K8 vpu"])
@pytest.mark.parametrize("final_clip", [False, True, "pack"])
def test_predict_fast_routes_equal_jax(plain, monkeypatch, route,
                                       final_clip):
    """`srnets_predict_fast` end to end under each plain route's flags, the
    same flags set in both packages; each stage goes through the route's
    wrapper, and K8 takes "pack" as the bf16 clip, as JAX does."""
    p, jst, tst = plain
    _set_route(monkeypatch, route)
    x = np.random.default_rng(1).random(SHAPE).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict_fast(
        jst, a, interpret=True, final_clip=final_clip, **CFG))(
            jnp.asarray(x)))
    called = {}
    for name in ("stage_ensemble_apply", "stage_ensemble_apply_w",
                 "stage_ensemble_apply_t"):
        def spy(*a, _n=name, _f=getattr(tuk, name), **k):
            called[_n] = called.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(tuk, name, spy)
    got = tsn.srnets_predict_fast(tst, torch.as_tensor(x),
                                  final_clip=final_clip, **CFG)
    assert called == {_ROUTE_WRAPPER[route]: 2}
    assert got.shape == (1, 1, 20, 24)
    packed = final_clip == "pack" and route == "K6"
    assert got.dtype == (torch.uint8 if packed else torch.bfloat16
                         if final_clip else torch.float32)
    assert str(got.dtype)[6:] == str(want.dtype)
    _close(got.float().numpy(), want.astype(np.float32))
    assert not any(tuk.LAUNCHES.values())


def test_raw_accumulators_equal_k3(plain):
    """K6 and K8 with the float32 head (plain versions, raw accumulator)
    byte-equal K3's on the image sites of the same input: one pass body,
    three tap sources."""
    _, _, tst = plain
    _, xt = _image(40, (2, 1, 7, 9))
    B, C, H, W = xt.shape
    for s, st in enumerate(tst):
        v = 1 if s == 0 else 16
        k8 = tuk.stage_ensemble_apply(st, tsn._ensemble_taps(xt, MODES),
                                      n_modes=3, v=v)
        k6 = tuk.stage_ensemble_apply_t(st, tsn._ensemble_taps_t(xt, MODES),
                                        n_modes=3, v=v)
        plane, (Hp, Wp, P) = tsn._window_plane(xt, MODES)
        k3 = tuk.stage_ensemble_apply_w(st, plane, modes=MODES, width=Wp,
                                        v=v)
        k3 = k3.reshape(16, B, C, Hp, Wp)[..., P: P + H, P: P + W]
        k3 = k3.reshape(16, -1)
        assert torch.equal(k6, k3)
        assert torch.equal(k8.T, k3)


def _jax_evaluator(params):
    """JAX `NetEvaluator(fast=True)` as a TPU configures it (kernel runs,
    no tiling, the luma runner of plain stacks, whose clip follows
    PLAIN_LAYOUT at trace time), with the Pallas kernels in interpret
    mode."""
    ev = JaxNetEvaluator(params, **CFG)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    st = jsn.stack_srnets_for_fast(bf, **CFG)
    run = jax.jit(lambda x: jsn.srnets_predict_fast(
        st, x, interpret=True, **CFG).astype(jnp.float32))
    ev._run = run
    ev._run_tiled = lambda x, axis=2: run(x)
    clip = "pack" if jsn.PLAIN_LAYOUT == "feature" else True
    ev._luma_clip_run = jax.jit(lambda x: jsn.srnets_predict_fast(
        st, x, interpret=True, final_clip=clip, **CFG))
    return ev


@pytest.mark.parametrize("route", ["K6", "K8", "K8 vpu"])
def test_net_evaluator_routes(plain, monkeypatch, route):
    """`NetEvaluator(device="cpu")` under each plain route: RGB and YUV
    against JAX's evaluator under the same flags; K6 and K8 (float32
    head) give the K3 route's bytes; the YUV luma clip follows
    PLAIN_LAYOUT at the call ("pack" on the feature-major routes at x4)."""
    p, _, _ = plain
    imgs = np.random.default_rng(2).integers(0, 256, (2, 5, 6, 3)).astype(
        np.uint8)
    ev = NetEvaluator(p, fast=True, device="cpu", **CFG)
    base = ev.upscale_batch(imgs), ev.upscale_yuv_batch(imgs)
    assert ev._luma_clip == "pack"
    _set_route(monkeypatch, route)
    assert ev._luma_clip == ("pack" if route == "K6" else True)
    got = ev.upscale_batch(imgs), ev.upscale_yuv_batch(imgs)
    jax_ev = _jax_evaluator(p)
    for g, b, w in zip(got, base, (jax_ev.upscale_batch(imgs),
                                   jax_ev.upscale_yuv_batch(imgs))):
        assert g.dtype == np.uint8 and g.shape == (2, 20, 24, 3)
        _close(g, w)
        if route != "K8 vpu":
            np.testing.assert_array_equal(g, b)
    assert not any(tuk.LAUNCHES.values())


def test_error_surface(plain, monkeypatch):
    """A packed site-major epilogue, unknown flag values and another width
    than the CUDA kernels' raise before any launch."""
    _, _, tst = plain
    st = tst[1]
    taps = torch.zeros((5, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mix"):
        tuk.stage_ensemble_apply(st, taps, n_modes=3, mix="final_pack")
    x = torch.zeros(SHAPE)
    monkeypatch.setattr(tsn, "PLAIN_LAYOUT", "sites")
    with pytest.raises(ValueError, match="PLAIN_LAYOUT"):
        tsn.srnets_predict_fast(tst, x, **CFG)
    monkeypatch.setattr(tsn, "PLAIN_LAYOUT", "site")
    monkeypatch.setattr(tuk, "PLAIN_HEAD", "tpu")
    with pytest.raises(ValueError, match="PLAIN_HEAD"):
        tsn.srnets_predict_fast(tst, x, **CFG)
    with pytest.raises(ValueError, match="PLAIN_HEAD"):
        tuk.stage_ensemble_apply_plain(st, taps, n_modes=3)
    monkeypatch.setattr(tsn, "DENSE_LAYOUT", "featur")
    dense = tsn.stack_srnets_for_fast(params_from_numpy(
        tsn.init_srnets(np.random.default_rng(0), nf=8, arch="dense", **CFG),
        "cpu"), **CFG)
    with pytest.raises(ValueError, match="DENSE_LAYOUT"):
        tsn.srnets_predict_fast(dense, x, **CFG)
    for name, src in (("plain_window", torch.zeros(60, dtype=torch.bfloat16)),
                      ("plain_feature", taps.T.contiguous()),
                      ("plain_site", taps)):
        with pytest.raises(NotImplementedError, match="nf=128"):
            tuk._launch_plain(name, st, src, torch.zeros(16, 5), n=5,
                              modes=3, v=16, mix=None,
                              head="mxu" if name == "plain_site" else None)
    assert not any(tuk.LAUNCHES.values())
