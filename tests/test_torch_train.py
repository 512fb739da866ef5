"""The port's step 1, training (`models/srnet.py`'s train phase,
`pipelines/train.py`, the optimizer-state checkpoints of
`models/torch_import.py`), against the JAX package on the CPU.

Tolerances:

- `cosine_lr` at steps 0, 1, total/2 and total: relative 1e-6 (the port
  evaluates it in float64 on the host, JAX in float32 on the device).
- `make_optimizer` (optax's Adam, and AdamW with weight decay): 5 updates
  of seeded params by seeded grads, each within relative 1e-6 of optax's
  params (measured: Adam equal, AdamW within 1.2e-10).
- `srnets_predict(phase="train")`, dense nf=8 units on a 2 x 1 x 12 x 12
  uint8 batch: at least 99.9% of values equal JAX's, none off by more
  than 1/255 (float32 sums and tanh differ in the last bits between
  XLA-CPU and torch and flip round(127 * tanh) ties; measured 99.98%).
- The gradients of the first step's loss: per tensor within 1e-4 of its
  largest magnitude (measured 1.5e-5); the loss within relative 1e-5.
- `train(opt)` resumed by both packages from one `Model_000002.npz`
  written by JAX from JAX's params, 4 more steps on a synthetic tree
  (workerNum=1): each step's loss within relative 1e-5 of JAX's (measured
  5.6e-7).
- The port's own resume with `Opt_*.npz` reproduces its uninterrupted
  run exactly (the same ops on identical state), and a resume without it
  does not.
- A `Model_*.npz` written by either package loads in the other, equal.

Every JAX function runs under `jax.jit`; the loss gradient is compiled
once per module (fixture `jax_grad`).
"""

import functools
import importlib
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulut_tpu.models import srnet as jsn
from mulut_tpu.models import torch_import as jti
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models import torch_import as tti
from mulut_tpu_torch.ops.unit_kernel import _INV255

jtr = importlib.import_module("mulut_tpu.pipelines.train")
ttr = importlib.import_module("mulut_tpu_torch.pipelines.train")

CFG = dict(modes="sdy", stages=2, scale=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _params(seed: int = 1) -> dict:
    return tsn.init_srnets(np.random.default_rng(seed), nf=8, arch="dense",
                           **CFG)


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    im = rng.integers(0, 256, (2, 1, 12, 12)).astype(np.uint8)
    lb = rng.integers(0, 256, (2, 1, 48, 48)).astype(np.uint8)
    return im, lb


def _jloss(p, im, lb):
    x = im.astype(jnp.float32) / 255.0
    y = lb.astype(jnp.float32) / 255.0
    pred = jsn.srnets_predict(p, x, phase="train", **CFG)
    return jnp.mean((pred - y) ** 2), pred


@pytest.fixture(scope="module")
def jax_grad():
    im, lb = _batch()
    jp = jax.tree_util.tree_map(jnp.asarray, _params())
    (loss, pred), grads = jax.jit(jax.value_and_grad(_jloss, has_aux=True))(
        jp, im, lb)
    return dict(im=im, lb=lb, loss=float(loss), pred=np.asarray(pred),
                grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("total", [1000, 200000])
def test_cosine_lr(total):
    want = jax.jit(jtr.cosine_lr(1e-3, 1e-4, total))
    got = ttr.cosine_lr(1e-3, 1e-4, total)
    for k in (0, 1, total // 2, total):
        w = float(want(np.int32(k)))
        assert abs(got(k) - w) <= 1e-6 * w, (k, got(k), w)
    neg = ttr.cosine_lr(1e-3, -1, total)
    assert abs(neg(total) - 2e-4) <= 1e-12


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_optimizer_updates_follow_optax(wd):
    rng = np.random.default_rng(int(wd * 1e5))
    p = {"u": {"w": rng.standard_normal((5, 7)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32)}}
    optimizer = jtr.make_optimizer(1e-3, 1e-4, 10, wd)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    st = optimizer.init(jp)
    update = jax.jit(optimizer.update)
    tp = ttr.trainable(p, "cpu")
    topt = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 10, wd)
    for _ in range(5):
        g = {"u": {k: rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in p["u"].items()}}
        u, st = update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        for k in ("w", "b"):
            tp["u"][k].grad = torch.as_tensor(g["u"][k])
        topt.step()
        for k in ("w", "b"):
            want = np.asarray(jp["u"][k])
            err = np.abs(tp["u"][k].detach().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (k, err)
    assert int(topt.state[tp["u"]["w"]]["step"]) == 5 == int(st[0].count)


def test_train_phase_forward(jax_grad):
    tp = tti.params_from_numpy(_params(), "cpu")
    x = torch.as_tensor(jax_grad["im"]).to(torch.float32) * _INV255
    got = tsn.srnets_predict(tp, x, phase="train", **CFG).numpy()
    want = jax_grad["pred"]
    assert got.shape == want.shape == (2, 1, 48, 48)
    assert (got == want).mean() >= 0.999
    assert np.abs(got - want).max() <= 1.0001 / 255
    with pytest.raises(ValueError):
        tsn.srnets_predict(tp, x, phase="test", **CFG)


def test_first_step_gradients(jax_grad):
    tp = ttr.trainable(_params(), "cpu")
    loss = ttr.train_loss(tp, torch.as_tensor(jax_grad["im"]),
                          torch.as_tensor(jax_grad["lb"]), **CFG)
    loss.backward()
    assert abs(loss.item() - jax_grad["loss"]) <= 1e-5 * jax_grad["loss"]
    for u, unit in jax_grad["grads"].items():
        for n, want in unit.items():
            err = np.abs(tp[u][n].grad.numpy() - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (u, n, err)


def _opt(root, exp, **kw):
    base = dict(nf=8, arch="dense", unitDepth=0, modes="sdy", stages=2,
                scale=4, interval=4, batchSize=2, cropSize=8,
                trainDir=str(root / "DIV2K"), valDir=str(root / "none"),
                startIter=2, totalIter=6, lr0=1e-3, lr1=1e-4, weightDecay=0,
                displayStep=1, valStep=100, saveStep=100, workerNum=1,
                expDir=str(exp), valoutDir=str(exp / "val"), debug=False,
                trainPrecision="f32", gpuNum=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _recording(module, monkeypatch):
    """Record each step's loss: wrap the module's `make_train_step`."""
    losses = []
    make = module.make_train_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def rec(*args):
            out = step(*args)
            losses.append(float(out if module is ttr else out[-1]))
            return out

        return rec

    monkeypatch.setattr(module, "make_train_step", wrapped)
    return losses


def test_train_resumed_from_a_jax_checkpoint(tmp_path, monkeypatch):
    """`train(opt)` in both packages from JAX's `Model_000002.npz` (JAX's
    own init, PRNGKey(0)), no `Opt_*.npz`: 4 steps, the losses; then the
    port's validation on a synthetic benchmark tree."""
    from mulut_tpu.data import create_synthetic_dataset

    create_synthetic_dataset(str(tmp_path), n_train=4, n_val=1, size=32,
                             scales=(4,))
    params = jsn.init_srnets(jax.random.PRNGKey(0), nf=8, **CFG)
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        jti.save_params_npz(str(tmp_path / pkg / "Model_000002.npz"),
                            jax.device_get(params))
    want = _recording(jtr, monkeypatch)
    jtr.train(_opt(tmp_path, tmp_path / "jax"))
    got = _recording(ttr, monkeypatch)
    out = ttr.train(_opt(tmp_path, tmp_path / "torch", totalIter=6,
                         valStep=6, saveStep=6,
                         valDir=str(tmp_path / "SRBenchmark")),
                    device="cpu")
    assert len(got) == len(want) == 4
    for k, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= 1e-5 * w, (k, g, w)
    assert (tmp_path / "torch" / "Model_000006.npz").exists()
    assert (tmp_path / "torch" / "Opt_000006.npz").exists()
    assert (tmp_path / "torch" / "val" / "Set5" / "alpha_net.png").exists()
    log = (tmp_path / "torch" / "train.log").read_text()
    assert "Iter:     6" in log and "AVG Val PSNR" in log
    assert out["s1_s"]["w1"].requires_grad
    logging.getLogger("train").handlers.clear()


def _resume_run(tmp_path, n, half, resume, opt_state=True):
    """n steps of the port's make_train_step, interrupted after `half`
    (params and, with `opt_state`, the optimizer saved and reloaded) when
    `resume`; returns the params and the optimizer."""
    rng = np.random.default_rng(3)
    batches = [(torch.as_tensor(rng.integers(0, 256, (2, 1, 8, 8),
                                             dtype=np.uint8)),
                torch.as_tensor(rng.integers(0, 256, (2, 1, 16, 16),
                                             dtype=np.uint8)))
               for _ in range(n)]
    cfg = dict(modes="s", stages=1, scale=2)

    def fresh(params):
        p = ttr.trainable(params, "cpu")
        return p, ttr.make_optimizer(ttr.param_leaves(p), 1e-3, 1e-4, n)

    p, optimizer = fresh(tsn.init_srnets(np.random.default_rng(0), nf=4,
                                         **cfg))
    step = ttr.make_train_step(optimizer, **cfg)
    for k, (im, lb) in enumerate(batches):
        if resume and k == half:
            tti.save_params_npz(str(tmp_path / "Model.npz"), p)
            tti.save_opt_state_npz(str(tmp_path / "Opt.npz"), optimizer)
            p, optimizer = fresh(tti.load_params_npz(str(tmp_path /
                                                         "Model.npz")))
            if opt_state:
                tti.load_opt_state_npz(str(tmp_path / "Opt.npz"), optimizer)
            step = ttr.make_train_step(optimizer, **cfg)
        step(p, im, lb)
    return p, optimizer


def test_port_resume_reproduces_uninterrupted_trajectory(tmp_path):
    pa, oa = _resume_run(tmp_path, 8, 4, resume=False)
    pc, oc = _resume_run(tmp_path, 8, 4, resume=True)
    for x, y in zip(ttr.param_leaves(pa), ttr.param_leaves(pc)):
        assert torch.equal(x, y)
    for x, y in zip(ttr.param_leaves(pa), ttr.param_leaves(pc)):
        sa, sc = oa.state[x], oc.state[y]
        assert int(sa["step"]) == int(sc["step"]) == 8
        assert torch.equal(sa["mu"], sc["mu"]) and torch.equal(sa["nu"],
                                                                sc["nu"])
    pb, _ = _resume_run(tmp_path, 8, 4, resume=True, opt_state=False)
    la = torch.cat([t.detach().ravel() for t in ttr.param_leaves(pa)])
    lb = torch.cat([t.detach().ravel() for t in ttr.param_leaves(pb)])
    assert not torch.allclose(la, lb)


def test_checkpoints_load_across_packages(tmp_path):
    jp = jsn.init_srnets(jax.random.PRNGKey(3), nf=8, arch="mxu", **CFG)
    jti.save_params_npz(str(tmp_path / "j.npz"), jax.device_get(jp))
    got = tti.load_params_npz(str(tmp_path / "j.npz"))
    tp = ttr.trainable(_params(), "cpu")
    tti.save_params_npz(str(tmp_path / "t.npz"), tp)
    back = jti.load_params_npz(str(tmp_path / "t.npz"))
    for u in jp:
        for n in jp[u]:
            np.testing.assert_array_equal(got[u][n], np.asarray(jp[u][n]))
            np.testing.assert_array_equal(np.asarray(back[u][n]),
                                          tp[u][n].detach().numpy())
    opt = ttr.make_optimizer(ttr.param_leaves(tp), 1e-3, 1e-4, 4)
    for t in ttr.param_leaves(tp):
        t.grad = torch.ones_like(t)
    opt.step()
    tti.save_opt_state_npz(str(tmp_path / "o.npz"), opt)
    small = ttr.make_optimizer(ttr.param_leaves(tp)[:3], 1e-3, 1e-4, 4)
    with pytest.raises(ValueError, match="mismatch"):
        tti.load_opt_state_npz(str(tmp_path / "o.npz"), small)


def test_unported_options_and_devices_raise():
    """bf16 training runs since the port's CLI slice
    (tests/test_torch_train_bf16.py) and a precision of neither kind
    raises; without CUDA the entry points raise unless device="cpu", with
    one card or several (gpuNum > 1 runs since the port's parallel slice:
    tests/test_torch_parallel.py), in either precision."""
    assert callable(ttr.make_train_step(None, precision="bf16", **CFG))
    with pytest.raises(ValueError, match="precision must be one of"):
        ttr.make_train_step(None, precision="fp8", **CFG)
    if torch.cuda.is_available():
        return
    for n, prec in ((1, "f32"), (2, "f32"), (1, "bf16")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.train(types.SimpleNamespace(trainPrecision=prec, gpuNum=n))
