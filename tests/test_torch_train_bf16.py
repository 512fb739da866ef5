"""The port's trainPrecision="bf16" and its optimizer-state checkpoints
across packages, against the JAX package on the CPU.

bf16: on a TPU the JAX step's Precision.DEFAULT dots round their inputs
to bf16 and keep float32 products, sums and outputs, in the backward's
transposed dots too; every other op stays float32.  XLA on the CPU
treats DEFAULT as float32, so the reference here is the JAX step with the
name `jnp` in `mulut_tpu.models.blocks` replaced, for the test's
duration, by a proxy of `jax.numpy` whose `dot` at DEFAULT rounds its
inputs (and, through a `jax.custom_vjp`, its backward's inputs, the
incoming gradient too) to bf16 with float32 output (`_Bf16Jnp`).  Both
of the train path's dots go through that name; no JAX file changes.

Tolerances (the CPU port's bf16 path: a float32 matmul of the bf16
values; the sums' order differs from XLA's):

- `Bf16Dot` on seeded matrices: forward and both input gradients within
  relative 1e-6 of the reference's largest magnitude (exact products,
  float32 sums in another order).
- The first step's loss within relative `LOSS_REL` = 1e-5 and each
  gradient within `GRAD_REL` = 1e-4 of its largest magnitude (the gates of
  tests/test_torch_train.py, which chip_smoke.py's phase 18 holds the
  card's bf16 step to): measured 5.3e-7 / 8.0e-7 (dense nf=8) and
  6.3e-7 / 3.1e-5 (mxu nf=16).  The float32 step departs from the bf16
  reference by 2.1e-3 / 1.3e-2 and 4.1e-3 / 8.7e-2: each test also holds
  that it departs by more than 10x the gates, so they tell the two apart.
- `train(opt)` with trainPrecision="bf16" in both packages from one
  `Model_000002.npz` (mxu nf=16, mode "s"): each step's loss within
  relative `LOSS_REL`.

Resume: on a training tree of one D4-symmetric gray image whose LR size
is the crop size, every batch is the same batch, so a resumed run (whose
batch stream starts anew) can follow an uninterrupted one step for step.

- `train(opt)` run by JAX to step 4, saving at 2, then resumed from its
  `Model_000002.npz` and `Opt_000002.npz` by the port: steps 3-4 within
  relative `LOSS_REL` of JAX's uninterrupted steps 3-4; and the reverse
  (the port saves, JAX's `load_opt_state_npz` restores).  A resume whose
  optimizer starts anew departs by more than 10x the gate.
- `finetune(opt)` the same with `LUTft_*` and `Opt_ft_*.npz`, its losses
  within relative 1e-5 (tests/test_torch_finetune.py's step gate).
- The optimizer file's leaves equal optax's state leaf for leaf after
  the same updates (Adam and AdamW): counts equal, moments within 1e-6
  relative; the port still reads the `state/...` files it wrote before.
"""

import importlib
import logging
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulut_tpu.models import blocks as jblocks
from mulut_tpu.models import srnet as jsn
from mulut_tpu.models import torch_import as jti
from mulut_tpu.utils.lut_io import lut_filename
from mulut_tpu_torch.models import blocks as tblocks
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models import torch_import as tti
from mulut_tpu_torch.utils.imgio import write_png

jtr = importlib.import_module("mulut_tpu.pipelines.train")
ttr = importlib.import_module("mulut_tpu_torch.pipelines.train")
jft = importlib.import_module("mulut_tpu.pipelines.finetune")
tft = importlib.import_module("mulut_tpu_torch.pipelines.finetune")

CFG = dict(modes="sdy", stages=2, scale=4)
LOSS_REL, GRAD_REL = 1e-5, 1e-4
FT_LOSS_REL = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r16(t):
    return t.astype(jnp.bfloat16).astype(jnp.float32)


@jax.custom_vjp
def _bf16_dot(a, b):
    return jnp.dot(_r16(a), _r16(b), precision=HIGHEST)


def _bf16_dot_fwd(a, b):
    return _bf16_dot(a, b), (_r16(a), _r16(b))


def _bf16_dot_bwd(res, g):
    a, b = res
    g = _r16(g)
    return (jnp.dot(g, b.T, precision=HIGHEST),
            jnp.dot(a.T, g, precision=HIGHEST))


_bf16_dot.defvjp(_bf16_dot_fwd, _bf16_dot_bwd)


class _Bf16Jnp:
    """`jax.numpy` with a `dot` that runs a Precision.DEFAULT dot as a
    TPU does (`_bf16_dot`)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, precision=None):
        if precision == jax.lax.Precision.DEFAULT:
            return _bf16_dot(a, b)
        return jnp.dot(a, b, precision=precision)


@pytest.fixture()
def bf16_jax(monkeypatch):
    monkeypatch.setattr(jblocks, "jnp", _Bf16Jnp())


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 1, 12, 12)).astype(np.uint8),
            rng.integers(0, 256, (2, 1, 48, 48)).astype(np.uint8))


def _worst(got: dict, want: dict) -> float:
    return max(float(np.abs(got[u][n] - want[u][n]).max()
                     / np.abs(want[u][n]).max())
               for u in want for n in want[u])


def test_bf16_dot_forward_and_backward(bf16_jax):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((37, 24)).astype(np.float32)
    b = rng.standard_normal((24, 11)).astype(np.float32)
    g = rng.standard_normal((37, 11)).astype(np.float32)
    out, vjp = jax.vjp(_bf16_dot, jnp.asarray(a), jnp.asarray(b))
    want = [np.asarray(x) for x in (out,) + vjp(jnp.asarray(g))]
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tout = tblocks.Bf16Dot.apply(ta, tb)
    tout.backward(torch.as_tensor(g))
    got = [t.detach().numpy() for t in (tout, ta.grad, tb.grad)]
    for x, y in zip(got, want):
        assert np.abs(x - y).max() <= 1e-6 * np.abs(y).max()
    # the float32 product is another function
    assert np.abs(a @ b - want[0]).max() > 1e-3 * np.abs(want[0]).max()
    with pytest.raises(ValueError):
        tblocks.apply_mulut_unit({"w1": ta, "b1": tb, "w6": tb, "b6": tb},
                                 ta, precision="fp8")


@pytest.mark.parametrize("arch,nf", [("dense", 8), ("mxu", 16)])
def test_bf16_first_step_matches_the_bf16_dot_reference(bf16_jax, arch, nf):
    params = tsn.init_srnets(np.random.default_rng(1), nf=nf, arch=arch,
                             **CFG)
    im, lb = _batch()

    def jloss(p, precision):
        x = im.astype(jnp.float32) / 255.0
        y = lb.astype(jnp.float32) / 255.0
        pred = jsn.srnets_predict(p, x, phase="train", precision=precision,
                                  **CFG)
        return jnp.mean((pred - y) ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jax.lax.Precision.DEFAULT)))(jp)
    want = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    got = {}
    for prec in ("bf16", "f32"):
        tp = ttr.trainable(params, "cpu")
        t_loss = ttr.train_loss(tp, torch.as_tensor(im), torch.as_tensor(lb),
                                precision=prec, **CFG)
        t_loss.backward()
        got[prec] = (t_loss.item(), {u: {n: t.grad.numpy()
                                          for n, t in tp[u].items()}
                                     for u in tp})
    (lg, gg), (lw, gw) = got["bf16"], want
    assert abs(lg - lw) <= LOSS_REL * lw, (lg, lw)
    assert _worst(gg, gw) <= GRAD_REL
    lf, gf = got["f32"]
    assert abs(lf - lw) > 10 * LOSS_REL * lw
    assert _worst(gf, gw) > 10 * GRAD_REL


def _opt(root, exp, **kw):
    base = dict(nf=8, arch="dense", unitDepth=0, modes="sdy", stages=2,
                scale=4, interval=4, batchSize=2, cropSize=8,
                trainDir=str(root / "DIV2K"), valDir=str(root / "none"),
                startIter=0, totalIter=4, lr0=1e-3, lr1=1e-4, weightDecay=0,
                displayStep=1, valStep=100, saveStep=2, workerNum=1,
                expDir=str(exp), valoutDir=str(exp / "val"), debug=False,
                trainPrecision="f32", gpuNum=1)
    base.update(kw)
    os.makedirs(base["expDir"], exist_ok=True)
    return types.SimpleNamespace(**base)


def _recording(monkeypatch, module, name):
    """Each step's loss, from a wrapped `module.<name>` step factory."""
    losses = []
    make = getattr(module, name)
    port = module in (ttr, tft)

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def rec(*args):
            out = step(*args)
            losses.append(float(out if port else out[-1]))
            return out

        return rec

    monkeypatch.setattr(module, name, wrapped)
    return losses


def _close(got, want, rel):
    assert len(got) == len(want) and len(got) > 0, (got, want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= rel * abs(w), (k, g, w)


def test_bf16_train_cli_follows_jax(tmp_path, monkeypatch, bf16_jax):
    """`train(opt)` with trainPrecision="bf16" in both packages from one
    JAX-written `Model_000002.npz`, 2 steps on a synthetic tree."""
    from mulut_tpu.data import create_synthetic_dataset

    create_synthetic_dataset(str(tmp_path), n_train=2, n_val=1, size=32,
                             scales=(4,))
    params = jsn.init_srnets(jax.random.PRNGKey(0), nf=16, arch="mxu",
                             modes="s", stages=2, scale=4)
    runs = {}
    for pkg, module in (("jax", jtr), ("torch", ttr)):
        exp = tmp_path / pkg
        exp.mkdir()
        jti.save_params_npz(str(exp / "Model_000002.npz"),
                            jax.device_get(params))
        runs[pkg] = _recording(monkeypatch, module, "make_train_step")
        opt = _opt(tmp_path, exp, nf=16, arch="mxu", modes="s", startIter=2,
                   saveStep=100, trainPrecision="bf16")
        if module is ttr:
            module.train(opt, device="cpu")
        else:
            module.train(opt)
    _close(runs["torch"], runs["jax"], LOSS_REL)
    logging.getLogger("train").handlers.clear()


def _symmetric_tree(root, hr: int = 32, scale: int = 4):
    """A DIV2K tree of one gray image invariant under flips and 90-degree
    rotations, its LR (a box average) `hr // scale` pixels wide."""
    y, x = np.mgrid[:hr, :hr] - (hr - 1) / 2
    r = np.sqrt(x * x + y * y)
    img = np.round(127 + 100 * np.sin(r / 2.3) * np.exp(-r / 40))
    img = np.clip(img, 0, 255).astype(np.uint8)
    lr = np.round(img.reshape(hr // scale, scale, hr // scale, scale)
                  .mean((1, 3))).astype(np.uint8)
    for arr, sub, name in ((img, "HR", "0001.png"),
                           (lr, f"LR/X{scale}", f"0001x{scale}.png")):
        os.makedirs(root / "DIV2K" / sub, exist_ok=True)
        write_png(str(root / "DIV2K" / sub / name), np.stack([arr] * 3, -1))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_resumes_across_packages(tmp_path, monkeypatch, writer):
    """One package trains 4 steps saving at 2; the other resumes from the
    step-2 files and follows the uninterrupted steps 3-4."""
    _symmetric_tree(tmp_path)
    cfg = dict(nf=4, modes="s", stages=2)
    pkgs = {"jax": jtr, "torch": ttr}
    reader = "torch" if writer == "jax" else "jax"

    def run(pkg, exp, **kw):
        losses = _recording(monkeypatch, pkgs[pkg], "make_train_step")
        opt = _opt(tmp_path, exp, **cfg, **kw)
        if pkg == "torch":
            ttr.train(opt, device="cpu")
        else:
            jtr.train(opt)
        return losses

    full = run(writer, tmp_path / "full")
    resumed = tmp_path / "resumed"
    fresh = tmp_path / "fresh"
    for exp in (resumed, fresh):
        exp.mkdir()
        shutil.copy(tmp_path / "full" / "Model_000002.npz", exp)
    shutil.copy(tmp_path / "full" / "Opt_000002.npz", resumed)
    got = run(reader, resumed, startIter=2, saveStep=100)
    _close(got, full[2:], LOSS_REL)
    # without Opt_000002.npz the optimizer starts anew: another trajectory
    other = run(reader, fresh, startIter=2, saveStep=100)
    assert abs(other[1] - full[3]) > 10 * LOSS_REL * full[3]
    logging.getLogger("train").handlers.clear()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_finetune_resumes_across_packages(tmp_path, monkeypatch, writer):
    _symmetric_tree(tmp_path)
    cfg = dict(modes="s", stages=2)
    rng = np.random.default_rng(11)
    full = tmp_path / "full"
    full.mkdir()
    for stage, v in ((1, 1), (2, 16)):
        np.save(full / lut_filename("LUT", 4, 4, stage, "s"),
                rng.integers(-127, 128, (17 ** 4, v)).astype(np.int8))
    pkgs = {"jax": jft, "torch": tft}
    reader = "torch" if writer == "jax" else "jax"

    def run(pkg, exp, **kw):
        losses = _recording(monkeypatch, pkgs[pkg], "make_finetune_step")
        opt = _opt(tmp_path, exp, **cfg, **kw)
        if pkg == "torch":
            tft.finetune(opt, device="cpu")
        else:
            jft.finetune(opt)
        return losses

    want = run(writer, full)
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    for f in os.listdir(full):
        if f.startswith("LUT_x") or f.endswith("_000002.npz"):
            shutil.copy(full / f, resumed)
    got = run(reader, resumed, startIter=2, saveStep=100)
    _close(got, want[2:], FT_LOSS_REL)
    logging.getLogger("lutft").handlers.clear()


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_opt_state_file_holds_optax_leaves(tmp_path, wd):
    """After 3 equal updates, the port's file and the JAX package's hold
    the same leaves; each package reads the other's file."""
    rng = np.random.default_rng(2)
    p = {"u": {"w": rng.standard_normal((5, 7)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32)},
         "a": {"w": rng.standard_normal((3, 2)).astype(np.float32)}}
    optimizer = jtr.make_optimizer(1e-3, 1e-4, 10, wd)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    st = optimizer.init(jp)
    tp = ttr.trainable(p, "cpu")
    topt = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 10, wd)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda v: rng.standard_normal(v.shape).astype(np.float32), p)
        u, st = optimizer.update(jax.tree_util.tree_map(jnp.asarray, g), st,
                                 jp)
        jp = optax.apply_updates(jp, u)
        for unit in p:
            for n in p[unit]:
                tp[unit][n].grad = torch.as_tensor(g[unit][n])
        topt.step()
    jti.save_opt_state_npz(str(tmp_path / "j.npz"), jax.device_get(st))
    tti.save_opt_state_npz(str(tmp_path / "t.npz"), topt)
    jf, tf = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(jf.files) == sorted(tf.files) == sorted(
        f"leaf_{k}" for k in range(2 * 3 + 2))
    for k in jf.files:
        assert jf[k].shape == tf[k].shape and jf[k].dtype == tf[k].dtype, k
        assert np.abs(jf[k] - tf[k]).max() <= 1e-6 * max(
            np.abs(jf[k]).max(), 1e-30), k
    # the port restores JAX's file, JAX restores the port's
    back = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 10, wd)
    tti.load_opt_state_npz(str(tmp_path / "j.npz"), back)
    for t in ttr.param_leaves(tp):
        a, b = back.state[t], topt.state[t]
        assert int(a["step"]) == int(b["step"]) == 3
        assert torch.allclose(a["mu"], b["mu"], rtol=1e-6, atol=0)
    restored = jti.load_opt_state_npz(str(tmp_path / "t.npz"),
                                      optimizer.init(jp))
    assert int(restored[0].count) == int(restored[-1].count) == 3
    # a file in the port's earlier layout still loads
    flat = {f"state/{i}/{name}": torch.as_tensor(val).numpy()
            for i, s_ in topt.state_dict()["state"].items()
            for name, val in s_.items()}
    np.savez(tmp_path / "old.npz", **flat)
    old = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 10, wd)
    tti.load_opt_state_npz(str(tmp_path / "old.npz"), old)
    assert int(old.state[ttr.param_leaves(tp)[0]]["step"]) == 3


def test_opt_state_mismatch_says_why(tmp_path):
    tp = ttr.trainable({"u": {"w": np.ones((2, 3), np.float32),
                              "b": np.ones(3, np.float32)}}, "cpu")
    opt = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 4)
    tti.save_opt_state_npz(str(tmp_path / "o.npz"), opt)
    small = ttr.make_optimizer(ttr.param_leaves(tp)[:1], 1e-3, 1e-4, 4)
    with pytest.raises(ValueError, match="has 6 leaves.*has 4"):
        tti.load_opt_state_npz(str(tmp_path / "o.npz"), small)
    other = ttr.trainable({"u": {"w": np.ones((3, 3), np.float32),
                                 "b": np.ones(3, np.float32)}}, "cpu")
    wrong = ttr.make_optimizer(ttr.param_leaves(other), 1e-3, 1e-4, 4)
    with pytest.raises(ValueError, match=r"parameter 1 is \(3, 3\)"):
        tti.load_opt_state_npz(str(tmp_path / "o.npz"), wrong)
