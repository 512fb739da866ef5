"""The port's step 3, STE fine-tuning of the LUTs (`ops/simplex.py`'s
differentiable path, `models/lut_model.py`, `pipelines/finetune.py`),
against the JAX package on the CPU.

Tolerances:

- `expand_weight`: forward byte-equal to JAX's; its `autograd.Function`
  backward byte-equal to `jax.vjp` of `_expand_weight` on a seeded
  cotangent (the same slices and adds in the same order);
  `torch.autograd.gradcheck` in float64 (its default tolerances).
- `simplex_planes_expanded_diff` on integer-valued planes: values
  byte-equal to `simplex_planes_diff` and to JAX's (integer-valued
  summands below 2**24); gradients w.r.t. the table within 1e-6 of their
  largest magnitude; the same for `simplex_interp_diff` (one mode, its
  STE re-quantization of the float weights).
- `lut_model_forward` at x4 `sdy` on a 2 x 1 x 12 x 12 uint8 batch
  divided by 255: values byte-equal to JAX's in its fine-tune loss; the loss's gradient w.r.t. each table
  within 1e-6 of its largest magnitude (measured 1.5e-7: scatter-adds
  into the expanded rows sum in another order than XLA's); the loss
  within relative 1e-6.
- Three `make_finetune_step` steps: losses within relative 1e-5.
- `finetune(opt)` on a synthetic tree of 4 images at 32 px, 3 steps: the
  exported int8 tables equal JAX's on at least 99.99% of entries, none
  off by more than 1.

Every JAX function runs under `jax.jit`; the fine-tune loss and its
gradient are compiled once per module (fixture `jax_ft`).
"""

import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulut_tpu.models import lut_model as jlm
from mulut_tpu.ops import simplex as jsx
from mulut_tpu_torch.models import lut_model as tlm
from mulut_tpu_torch.ops import simplex as tsx

jft = importlib.import_module("mulut_tpu.pipelines.finetune")
jtr = importlib.import_module("mulut_tpu.pipelines.train")
tft = importlib.import_module("mulut_tpu_torch.pipelines.finetune")
ttr = importlib.import_module("mulut_tpu_torch.pipelines.train")

CFG = dict(stages=2, modes="sdy")
L = 17
GRAD_REL = 1e-6


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
def _luts(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    luts = {f"s1_{m}": rng.integers(-127, 128, (L ** 4, 1)) for m in "sdy"}
    luts.update({f"s2_{m}": rng.integers(-127, 128, (L ** 4, 16))
                 for m in "sdy"})
    return {k: v.astype(np.int8) for k, v in luts.items()}


def _batch(seed: int = 1):
    rng = np.random.default_rng(seed)
    im = rng.integers(0, 256, (2, 1, 12, 12)).astype(np.uint8)
    lb = rng.integers(0, 256, (2, 1, 48, 48)).astype(np.uint8)
    return im, lb


def _jloss(w, im, lb):
    im = im.astype(jnp.float32) / 255.0
    lb = lb.astype(jnp.float32) / 255.0
    pred = jlm.lut_model_forward(w, im, upscale=4, **CFG)
    return jnp.mean((pred - lb) ** 2), pred


@pytest.fixture(scope="module")
def jax_ft():
    """The JAX forward (as the fine-tune step runs it), the loss gradient
    and three fine-tune steps (JAX's `make_finetune_step`: that gradient
    and `optax.apply_updates` of the optimizer's update) on the shared
    tables and batches, one compile."""
    jw = jlm.init_lut_weights_from_arrays(_luts(), upscale=4, **CFG)
    im, lb = _batch()
    vg = jax.jit(jax.value_and_grad(_jloss, has_aux=True))
    (loss, fwd), grads = vg(jw, im, lb)
    optimizer = jtr.make_optimizer(1e-3, 1e-4, 10)
    w, st, losses = jw, optimizer.init(jw), []
    for s in range(3):
        (ls, _), g = vg(w, *_batch(10 + s))
        u, st = optimizer.update(g, st, w)
        w = optax.apply_updates(w, u)
        losses.append(float(ls))
    return dict(fwd=np.asarray(fwd), loss=float(loss), im=im, lb=lb,
                grads={k: np.asarray(v) for k, v in grads.items()},
                losses=losses)


@pytest.mark.parametrize("interval,v", [(4, 1), (4, 16), (6, 4)])
def test_expand_weight_forward_and_vjp_equal(interval, v):
    n = (2 ** (8 - interval) + 1) ** 4
    rng = np.random.default_rng(interval * 100 + v)
    w = rng.integers(-127, 128, (n, v)).astype(np.float32)
    ct = rng.standard_normal((n, 16 * v)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jsx._expand_weight(a, interval),
                        jnp.asarray(w))
    want_g = np.asarray(jax.jit(vjp)(jnp.asarray(ct))[0])
    wt = torch.tensor(w, requires_grad=True)
    got = tsx.expand_weight(wt, interval=interval)
    got.backward(torch.as_tensor(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(wt.grad.numpy(), want_g)


def test_expand_weight_is_an_autograd_function_and_gradchecks():
    """The backward is `_ExpandWeight.backward` (the shift fold), not
    autograd's gather/scatter, and it is the forward's exact adjoint."""
    w = torch.randn((3 ** 4, 2), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    out = tsx.expand_weight(w, interval=7)
    assert type(out.grad_fn).__name__ == "_ExpandWeightBackward"
    assert torch.autograd.gradcheck(
        lambda a: tsx.expand_weight(a, interval=7), (w,))


@pytest.mark.parametrize("v", [1, 4])
def test_expanded_diff_equals_diff_and_jax(v):
    rng = np.random.default_rng(v)
    w127 = rng.integers(-127, 128, (L ** 4, v)).astype(np.float32)
    planes = [rng.integers(0, 256, (2, 5, 7)).astype(np.float32)
              for _ in range(4)]
    ct = rng.standard_normal((2, 5, 7, v)).astype(np.float32)

    def jexp(w):
        return jsx.simplex_planes_expanded_diff(
            jsx.expand_weight(w), [jnp.asarray(p) for p in planes], v=v)

    want, vjp = jax.vjp(jax.jit(jexp), jnp.asarray(w127))
    want_g = np.asarray(vjp(jnp.asarray(ct))[0])
    want_d = np.asarray(jax.jit(lambda w: jsx.simplex_planes_diff(
        w, [jnp.asarray(p) for p in planes]))(w127))

    tp = [torch.as_tensor(p) for p in planes]
    we = torch.tensor(w127, requires_grad=True)
    got = tsx.simplex_planes_expanded_diff(tsx.expand_weight(we), tp, v=v)
    got.backward(torch.as_tensor(ct))
    got_d = tsx.simplex_planes_diff(torch.as_tensor(w127), tp)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_d.numpy(), got.detach().numpy())
    err = np.abs(we.grad.numpy() - want_g).max()
    assert err <= GRAD_REL * np.abs(want_g).max(), err


@pytest.mark.parametrize("mode,up", [("s", 1), ("y", 2)])
def test_simplex_interp_diff_equal(mode, up):
    """The single-mode STE interpolation (re-quantized weights, padded
    integer-valued image): values byte-equal, gradients w.r.t. the float
    weights within 1e-6 of their largest magnitude."""
    rng = np.random.default_rng(up)
    weight = (rng.standard_normal((L ** 4, up * up)) * 0.6).astype(
        np.float32)
    img = rng.integers(0, 256, (2, 9, 11)).astype(np.float32)
    pad = tsx.mode_pad(mode)
    h, w = 9 - pad, 11 - pad
    ct = rng.standard_normal((2, h * up, w * up)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(functools.partial(
        jsx.simplex_interp_diff, img=jnp.asarray(img), mode=mode,
        upscale=up)), jnp.asarray(weight))
    want_g = np.asarray(vjp(jnp.asarray(ct))[0])
    wt = torch.tensor(weight, requires_grad=True)
    got = tsx.simplex_interp_diff(wt, torch.as_tensor(img), mode=mode,
                                  upscale=up)
    got.backward(torch.as_tensor(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    err = np.abs(wt.grad.numpy() - want_g).max()
    assert err <= GRAD_REL * np.abs(want_g).max(), err


def test_lut_model_forward_values_equal(jax_ft):
    tw = tlm.init_lut_weights_from_arrays(_luts(), upscale=4, device="cpu",
                                          **CFG)
    x = tlm.unit_pixels(torch.as_tensor(jax_ft["im"]))
    px = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(tlm.unit_pixels(px) * 255.0, px.to(torch.float32))
    got = tlm.lut_model_forward(tw, x, upscale=4, device="cpu", **CFG)
    assert got.shape == (2, 1, 48, 48)
    np.testing.assert_array_equal(got.numpy(), jax_ft["fwd"])


def test_lut_model_forward_gradients(jax_ft):
    tw = tlm.init_lut_weights_from_arrays(_luts(), upscale=4, device="cpu",
                                          **CFG)
    for w in tw.values():
        w.requires_grad_(True)
    loss = tft.finetune_loss(tw, torch.as_tensor(jax_ft["im"]),
                             torch.as_tensor(jax_ft["lb"]), upscale=4,
                             interval=4, **CFG)
    loss.backward()
    assert abs(loss.item() - jax_ft["loss"]) <= 1e-6 * jax_ft["loss"]
    for k, want in jax_ft["grads"].items():
        err = np.abs(tw[k].grad.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (k, err)


def test_export_lut_weights_equal():
    rng = np.random.default_rng(5)
    w = {"s1_s": (rng.standard_normal((9, 4)) * 0.8).astype(np.float32)}
    want = jlm.export_lut_weights({k: jnp.asarray(v) for k, v in w.items()})
    got = tlm.export_lut_weights({k: torch.as_tensor(v)
                                  for k, v in w.items()})
    np.testing.assert_array_equal(got["s1_s"], want["s1_s"])
    assert got["s1_s"].dtype == np.int8


def test_three_finetune_steps(jax_ft):
    tw = tlm.init_lut_weights_from_arrays(_luts(), upscale=4, device="cpu",
                                          **CFG)
    for w in tw.values():
        w.requires_grad_(True)
    optimizer = ttr.make_optimizer([tw[k] for k in sorted(tw)], 1e-3, 1e-4,
                                   10)
    step = tft.make_finetune_step(optimizer, upscale=4, interval=4, **CFG)
    for s, want in enumerate(jax_ft["losses"]):
        im, lb = _batch(10 + s)
        got = step(tw, torch.as_tensor(im), torch.as_tensor(lb)).item()
        assert abs(got - want) <= 1e-5 * want, (s, got, want)


def _opt(root, exp, **kw):
    base = dict(nf=8, arch="dense", unitDepth=0, modes="sdy", stages=2,
                scale=4, interval=4, batchSize=2, cropSize=8,
                trainDir=str(root / "DIV2K"), valDir=str(root / "SRBenchmark"),
                startIter=0, totalIter=3, lr0=1e-3, lr1=1e-4, weightDecay=0,
                displayStep=1, valStep=100, saveStep=3, workerNum=1,
                expDir=str(exp), valoutDir=str(exp / "val"), debug=False,
                trainPrecision="f32", gpuNum=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_finetune_end_to_end(tmp_path):
    """`finetune(opt)` in both packages from the same transferred tables
    on a synthetic tree (validation included): the exported tables."""
    from mulut_tpu.data import create_synthetic_dataset
    from mulut_tpu_torch.utils.lut_io import load_luts, lut_filename

    create_synthetic_dataset(str(tmp_path), n_train=4, n_val=2, size=32,
                             scales=(4,))
    exps = {}
    for pkg in ("jax", "torch"):
        exp = tmp_path / pkg
        exp.mkdir()
        for key, arr in _luts(7).items():
            np.save(exp / lut_filename("LUT", 4, 4, int(key[1]), key[3]),
                    arr)
        exps[pkg] = exp
    # validation leaves the weights as they are: JAX's is skipped (an
    # empty benchmark tree), the port's runs
    jft.finetune(_opt(tmp_path, exps["jax"], valDir=str(tmp_path / "none")))
    got_w = tft.finetune(_opt(tmp_path, exps["torch"]), device="cpu")
    assert all(w.device.type == "cpu" for w in got_w.values())
    kw = dict(stages=2, modes="sdy", scale=4, interval=4, name="LUT_ft")
    want = load_luts(str(exps["jax"]), **kw)
    got = load_luts(str(exps["torch"]), **kw)
    for k in want:
        d = np.abs(got[k].astype(int) - want[k].astype(int))
        assert (d == 0).mean() >= 0.9999 and d.max() <= 1, (k, d.max())
    assert (exps["torch"] / "LUTft_000003.npz").exists()
    assert (exps["torch"] / "val" / "Set5").is_dir()


def test_finetune_entry_points_need_the_card_or_cpu():
    """Without CUDA the entry points raise unless device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    w = tlm.init_lut_weights_from_arrays(_luts(), upscale=4, device="cpu",
                                         **CFG)
    x = torch.zeros((1, 1, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.lut_model_forward(w, x, upscale=4, **CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lut_weights_from_arrays(_luts(), upscale=4, **CFG)
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tft.finetune(types.SimpleNamespace(gpuNum=n))
