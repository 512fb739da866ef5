"""The port's non-SR task pipelines (`mulut_tpu_torch.pipelines.tasks`)
against the JAX package's (`mulut_tpu.pipelines.tasks`) on the CPU.

Tolerances:

- The degradations (`add_gaussian_noise` from the same NumPy generator,
  `bayer_mosaic`, `jpeg_roundtrip` where PIL is installed) and
  `train_dn`'s default degradation (the noisy batches each step trains
  on, recorded in both packages): byte-equal.
- `dn_lut_apply` (the x1 cascade over expanded tables, K1's plain
  versions here) against JAX's raw-table cascade on the same random int8
  tables, interval 6 and 4, 1 and 2 stages, 2-D and 3-channel images:
  byte-equal; it runs the window contraction once per stage and mode.
  `dm_lut_apply` on even-sized mosaics: byte-equal, and JAX's ValueError
  on odd sizes.
- The dn and dm training steps (dense nf=8 x1 `sdy` cascade on 2 x 1 x
  16 x 16 uint8 batches; plain nf=8 demosaic unit on 2 x 12 x 12 x 3)
  against a JAX step of the same body (`dnnets_predict` / `dmnet_apply`,
  `jax.value_and_grad`): the loss within relative 1e-5, each gradient
  within 1e-4 of its largest magnitude (the x1 cascade's STE rounds may
  flip a tie, as in tests/test_torch_train.py; measured dn 1.1e-6, dm
  2.3e-7); then 4 steps of the port's `make_*_train_step` against JAX's
  (optax through its `make_optimizer`): each loss within relative 1e-5,
  each parameter after them within 1e-5 of its largest magnitude
  (measured dn 2.4e-7, dm 3.2e-7).
- `dn_transfer` and `dm_transfer` on the same params: at most 2e-5 of a
  table's entries off, each by one level (`cache_lut`'s gate,
  tests/test_torch_transfer.py; measured: 1 of the 83,521 entries of
  `s1_s`, 5 of the demosaic table's 1,002,252).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.models import srnet as jsn
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.ops import tail_kernel as ttk
from mulut_tpu_torch.pipelines.train import make_optimizer, param_leaves

jtasks = importlib.import_module("mulut_tpu.pipelines.tasks")
jtrain = importlib.import_module("mulut_tpu.pipelines.train")
ttasks = importlib.import_module("mulut_tpu_torch.pipelines.tasks")

MODES = "sdy"
LR0, LR1, ITERS = 1e-3, 1e-4, 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _smooth(rng, n, h, w):
    """(n, h, w) uint8 images of low-frequency structure."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    f = rng.uniform(1, 3, size=(n, 3, 1, 1))
    base = 127 + 90 * np.sin(2 * np.pi * (f[:, 0] * xx + f[:, 1] * yy
                                          + f[:, 2]))
    return np.clip(base, 0, 255).astype(np.uint8)


def _rgb(rng, n, h, w):
    """(n, h, w, 3) uint8: a smooth image, its green and blue channels
    shifted."""
    base = _smooth(rng, n, h, w)
    return np.stack([base, np.roll(base, 2, 1), np.roll(base, 2, 2)], -1)


# ---------------------------------------------------------------------------
# degradations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 20, 3), (2, 1, 12, 12)])
def test_gaussian_noise_draw_for_draw(shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    got = ttasks.add_gaussian_noise(img, 15.0, np.random.default_rng(3))
    want = jtasks.add_gaussian_noise(img, 15.0, np.random.default_rng(3))
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, img)


def test_bayer_mosaic_and_jpeg():
    img = np.random.default_rng(5).integers(0, 256, (10, 14, 3)).astype(
        np.uint8)
    got, want = ttasks.bayer_mosaic(img), jtasks.bayer_mosaic(img)
    assert got.shape == want.shape == (10, 14)
    assert got.tobytes() == want.tobytes()
    pytest.importorskip("PIL")
    for im in (img, img[..., 0]):
        got = ttasks.jpeg_roundtrip(im, 20)
        want = jtasks.jpeg_roundtrip(im, 20)
        assert got.shape == want.shape == im.shape
        assert got.tobytes() == want.tobytes()
        assert not np.array_equal(got, im)


# ---------------------------------------------------------------------------
# deployments
# ---------------------------------------------------------------------------

def _luts(rng, interval, stages, v=1):
    L4 = (2 ** (8 - interval) + 1) ** 4
    return {f"s{s + 1}_{m}": rng.integers(-127, 128, (L4, v)).astype(np.int8)
            for s in range(stages) for m in MODES}


@pytest.mark.parametrize("interval", [6, 4])
@pytest.mark.parametrize("stages", [1, 2])
def test_dn_lut_apply_byte_equal(interval, stages, monkeypatch):
    rng = np.random.default_rng(10 * interval + stages)
    luts = _luts(rng, interval, stages)
    calls = []
    wrapped = ttk.window_fold_contract

    def counted(tab, xp, **kw):
        calls.append((tuple(tab.shape), kw["u"]))
        return wrapped(tab, xp, **kw)

    monkeypatch.setattr(ttk, "window_fold_contract", counted)
    for shape in ((13, 17, 3), (9, 11)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        cfg = dict(modes=MODES, stages=stages, interval=interval)
        want = jtasks.dn_lut_apply(luts, img, **cfg)
        calls.clear()
        got = ttasks.dn_lut_apply(luts, img, device="cpu", **cfg)
        assert got.shape == want.shape == img.shape
        assert got.dtype == np.uint8
        assert got.tobytes() == want.tobytes(), (shape, int(
            (got != want).sum()))
        L4 = (2 ** (8 - interval) + 1) ** 4
        assert calls == [((L4, 64), 4), ((L4, 64), 4), ((L4, 16), 1)] * \
            stages


@pytest.mark.parametrize("interval", [4, 6])
def test_dm_lut_apply_byte_equal(interval):
    rng = np.random.default_rng(interval)
    L4 = (2 ** (8 - interval) + 1) ** 4
    lut = rng.integers(-127, 128, (L4, 12)).astype(np.int8)
    bayer = rng.integers(0, 256, (10, 14)).astype(np.uint8)
    want = jtasks.dm_lut_apply(lut, bayer, interval=interval)
    got = ttasks.dm_lut_apply(lut, bayer, interval=interval, device="cpu")
    assert got.shape == want.shape == (10, 14, 3)
    assert got.tobytes() == want.tobytes()
    for odd in (bayer[:9], bayer[:, :13]):
        with pytest.raises(ValueError):
            jtasks.dm_lut_apply(lut, odd, interval=interval)
        with pytest.raises(ValueError):
            ttasks.dm_lut_apply(lut, odd, interval=interval, device="cpu")


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def _dn_batches(seed, n=4):
    rng = np.random.default_rng(seed)
    clean = _smooth(rng, 2 * n, 16, 16)[:, None]
    noisy = [jtasks.add_gaussian_noise(clean[2 * i: 2 * i + 2], 15.0, rng)
             for i in range(n)]
    return [(noisy[i], clean[2 * i: 2 * i + 2]) for i in range(n)]


def _dm_batches(seed, n=4):
    rng = np.random.default_rng(seed)
    rgb = _rgb(rng, 2 * n, 12, 12)
    out = []
    for i in range(n):
        b = rgb[2 * i: 2 * i + 2]
        out.append((np.stack([jtasks.bayer_mosaic(im) for im in b]),
                    np.ascontiguousarray(b.transpose(0, 3, 1, 2))))
    return out


def _jax_dn_loss(p, im, lb):
    x = im.astype(jnp.float32) / 255.0
    y = lb.astype(jnp.float32) / 255.0
    pred = jsn.dnnets_predict(p, x, modes=MODES, stages=2, phase="train")
    return jnp.mean((pred - y) ** 2)


def _jax_dm_loss(p, bayer, rgb):
    x = bayer.astype(jnp.float32) / 255.0
    y = rgb.astype(jnp.float32) / 255.0
    pred = jsn.dmnet_apply(p, x[:, None])
    return jnp.mean((pred - (y * 2.0 - 1.0)) ** 2)


CASES = {
    "dn": dict(
        init=lambda: tsn.init_dnnets(np.random.default_rng(1), nf=8,
                                     modes=MODES, stages=2),
        batches=_dn_batches, jax_loss=_jax_dn_loss,
        jax_step=lambda o: jtasks.make_dn_train_step(o, modes=MODES,
                                                     stages=2),
        loss=lambda p, a, b: ttasks.dn_loss(p, a, b, modes=MODES, stages=2),
        step=lambda o: ttasks.make_dn_train_step(o, modes=MODES, stages=2)),
    "dm": dict(
        init=lambda: {"u": tsn.init_dmnet(np.random.default_rng(2), nf=8)},
        batches=_dm_batches, jax_loss=_jax_dm_loss,
        jax_step=jtasks.make_dm_train_step,
        loss=ttasks.dm_loss, step=ttasks.make_dm_train_step),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def step_case(request):
    """The JAX side of one task's training: the first batch's loss and
    gradients (the step's body, composed from public functions), then 4
    steps of JAX's own `make_*_train_step`."""
    name = request.param
    case = CASES[name]
    p = case["init"]()
    unwrap = (lambda t: t["u"]) if name == "dm" else (lambda t: t)
    batches = case["batches"](7)
    loss, grads = jax.jit(jax.value_and_grad(case["jax_loss"]))(
        _jax(unwrap(p)), *batches[0])
    optimizer = jtrain.make_optimizer(LR0, LR1, ITERS)
    jp = _jax(unwrap(p))
    st = optimizer.init(jp)
    step, losses = case["jax_step"](optimizer), []
    for a, b in batches:
        jp, st, l = step(jp, st, jnp.asarray(a), jnp.asarray(b))
        losses.append(float(l))
    return dict(name=name, case=case, params=p, unwrap=unwrap,
                batches=batches, loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                losses=losses, final=jax.tree_util.tree_map(np.asarray, jp))


def _trainable(p):
    return {u: {n: torch.tensor(v, requires_grad=True) for n, v in unit.items()}
            for u, unit in p.items()}


def test_step_loss_and_gradients(step_case):
    sc = step_case
    tp = _trainable(sc["params"])
    a, b = (torch.as_tensor(t) for t in sc["batches"][0])
    loss = sc["case"]["loss"](sc["unwrap"](tp), a, b)
    loss.backward()
    assert abs(loss.item() - sc["loss"]) <= 1e-5 * sc["loss"]
    got = {k: {n: t.grad.numpy() for n, t in u.items()} for k, u in tp.items()}
    for k, want in jax.tree_util.tree_leaves_with_path(sc["grads"]):
        keys = [q.key for q in k]
        g = sc["unwrap"](got)
        for q in keys:
            g = g[q]
        assert _rel(g, want) <= 1e-4, keys


def test_steps_follow_jax(step_case):
    sc = step_case
    tp = _trainable(sc["params"])
    step = sc["case"]["step"](make_optimizer(param_leaves(tp), LR0, LR1,
                                             ITERS))
    for (a, b), want in zip(sc["batches"], sc["losses"]):
        got = float(step(sc["unwrap"](tp), torch.as_tensor(a),
                         torch.as_tensor(b)))
        assert abs(got - want) <= 1e-5 * want
    got = sc["unwrap"](tp)
    for k, want in jax.tree_util.tree_leaves_with_path(sc["final"]):
        g = got
        for q in k:
            g = g[q.key]
        assert _rel(g.detach().numpy(), want) <= 1e-5, k


# ---------------------------------------------------------------------------
# train_dn / train_dm, transfer
# ---------------------------------------------------------------------------

def test_train_dn_default_degradation_draw_for_draw(monkeypatch):
    """The noisy batches `train_dn` trains on, recorded in both packages
    (the step factories wrapped): byte-equal; the port's returns."""
    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jtasks), ("torch", ttasks)):
        make = mod.make_dn_train_step

        def wrapped(*a, _make=make, _seen=seen[name], **kw):
            step = _make(*a, **kw)

            def rec(params, *args):
                _seen.append(np.asarray(args[-2]))   # the noisy batch
                return step(params, *args)

            return rec

        monkeypatch.setattr(mod, "make_dn_train_step", wrapped)
    clean = list(_smooth(np.random.default_rng(4), 6, 12, 12).reshape(
        3, 2, 1, 12, 12))
    kw = dict(modes="sd", stages=1, nf=4, iters=3, seed=9)
    jtasks.train_dn(iter(clean), **kw)
    params, losses = ttasks.train_dn(iter(clean), device="cpu", **kw)
    assert len(seen["jax"]) == len(seen["torch"]) == 3
    for g, w in zip(seen["torch"], seen["jax"]):
        assert g.dtype == w.dtype == np.uint8
        assert g.tobytes() == w.tobytes()
    assert len(losses) == 3 and all(np.isfinite(losses))
    want = jtasks.init_dnnets(jax.random.PRNGKey(0), nf=4, modes="sd",
                              stages=1)
    assert sorted(params) == sorted(want) == ["s1_d", "s1_s"]
    for k in params:
        assert {n: v.shape for n, v in params[k].items()} == \
            {n: v.shape for n, v in want[k].items()}
        assert all(v.dtype == np.float32 for v in params[k].values())


def test_train_dm_runs():
    batches = _rgb(np.random.default_rng(6), 6, 12, 12).reshape(
        3, 2, 12, 12, 3)
    params, losses = ttasks.train_dm(iter(batches), nf=4, iters=3,
                                     device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    want = jsn.init_dmnet(jax.random.PRNGKey(0), nf=4)
    assert {n: v.shape for n, v in params.items()} == \
        {n: v.shape for n, v in want.items()}


def _flips(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    assert d.max() <= 1
    assert (d > 0).sum() <= 2e-5 * d.size


def test_dn_and_dm_transfer():
    dn = tsn.init_dnnets(np.random.default_rng(3), nf=8, modes="sd",
                         stages=2)
    got = ttasks.dn_transfer(dn, modes="sd", stages=2, device="cpu")
    want = jtasks.dn_transfer(_jax(dn), modes="sd", stages=2)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == (17 ** 4, 1)
        _flips(got[k], np.asarray(want[k]))
    dm = tsn.init_dmnet(np.random.default_rng(4), nf=8)
    got = ttasks.dm_transfer(dm, device="cpu")
    assert got.shape == (17 ** 4, 12)
    _flips(got, np.asarray(jtasks.dm_transfer(_jax(dm))))
