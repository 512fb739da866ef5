"""The port's task models (`mulut_tpu_torch.models.blocks`' channel-wise
RGB unit, `models.srnet`'s `srnet_apply` and the DNNet and DMNet
families) against the JAX package on the CPU.

Tolerances:

- Forwards without rounding (`apply_mulut_c_unit`, `srnet_apply` at
  upscale 1 and 2 in every mode, `dnnet_apply`, `dmnet_apply`): within
  1e-5 (float32 sums in another order; measured up to 7.7e-7).
- `dnnets_predict` (the x1 cascade, both phases), dense nf=8 and 16 units
  on 2 x 1 x 24 x 24 images: every value within one level (1/255 in the
  train phase, 1 in the valid one), at most 0.5% of the values off.  Each
  unit pass rounds round(127 * tanh), and float32 sums in XLA's and
  torch's orders flip a tie now and then; one stage-1 flip moves a few
  outputs (measured: 3 of 36 param/image pairs show one, at most 3 of
  1,152 values, 0.26%).
- Init layouts: the same keys and shapes as JAX's inits (the random
  stream is NumPy's, not JAX's).

Every JAX function runs under `jax.jit`.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.models import blocks as jb
from mulut_tpu.models import srnet as jsn
from mulut_tpu.ops.taps import mode_pad
from mulut_tpu_torch.models import blocks as tb
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy

ATOL = 1e-5


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


def _unit(params):
    return params_from_numpy({"u": params}, "cpu")["u"]


def _layout(params):
    return {k: v.shape for k, v in params.items()}


def test_c_unit_forward_and_layout():
    p = tb.init_mulut_c_unit(np.random.default_rng(1), nf=8)
    assert _layout(p) == _layout(jb.init_mulut_c_unit(
        jax.random.PRNGKey(0), nf=8))
    assert all(v.dtype == np.float32 for v in p.values())
    x = np.random.default_rng(0).random((2, 5, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jb.apply_mulut_c_unit)(_jax(p), x))
    got = tb.apply_mulut_c_unit(_unit(p), torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["s", "d", "y"])
@pytest.mark.parametrize("upscale", [1, 2])
def test_srnet_apply(mode, upscale):
    p = tb.init_mulut_unit(np.random.default_rng(4), nf=8, upscale=upscale)
    pad = mode_pad(mode)
    x = np.random.default_rng(5).random(
        (2, 3, 9 + pad, 11 + pad)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, y: jsn.srnet_apply(
        q, y, mode=mode, upscale=upscale))(_jax(p), x))
    got = tsn.srnet_apply(_unit(p), torch.as_tensor(x), mode=mode,
                          upscale=upscale).numpy()
    assert got.shape == want.shape == (2, 3, 9 * upscale, 11 * upscale)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["s", "y"])
def test_dnnet_apply(mode):
    p = tb.init_mulut_unit(np.random.default_rng(6), nf=8, upscale=1)
    pad = mode_pad(mode)
    x = np.random.default_rng(7).random(
        (1, 3, 5 + pad, 7 + pad)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, y: jsn.dnnet_apply(
        q, y, mode=mode))(_jax(p), x))
    got = tsn.dnnet_apply(_unit(p), torch.as_tensor(x), mode=mode).numpy()
    assert got.shape == want.shape == (1, 3, 5, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dnnets_layout_and_default_phase():
    got = tsn.init_dnnets(np.random.default_rng(0), nf=4, modes="sd",
                          stages=2)
    want = jsn.init_dnnets(jax.random.PRNGKey(0), nf=4, modes="sd",
                           stages=2)
    assert sorted(got) == sorted(want) == ["s1_d", "s1_s", "s2_d", "s2_s"]
    for k in got:
        assert _layout(got[k]) == _layout(want[k])
    # JAX's default phase, not `srnets_predict`'s
    assert inspect.signature(tsn.dnnets_predict).parameters[
        "phase"].default == "train"
    x = torch.zeros((2, 1, 8, 8))
    out = tsn.dnnets_predict(params_from_numpy(got, "cpu"), x, modes="sd",
                             stages=2, phase="valid")
    assert out.shape == (2, 1, 8, 8)


@pytest.mark.parametrize("nf", [8, 16])
@pytest.mark.parametrize("phase", ["train", "valid"])
def test_dnnets_predict(nf, phase):
    fn = jax.jit(lambda q, y: jsn.dnnets_predict(q, y, modes="sdy",
                                                 stages=2, phase=phase))
    level = 1 / 255 if phase == "train" else 1.0
    for ps in range(3):
        p = tsn.init_dnnets(np.random.default_rng(ps), nf=nf, modes="sdy",
                            stages=2)
        tp = params_from_numpy(p, "cpu")
        for seed in range(2):
            x = np.random.default_rng(seed).integers(
                0, 256, (2, 1, 24, 24)).astype(np.float32) / 255
            want = np.asarray(fn(_jax(p), x))
            got = tsn.dnnets_predict(tp, torch.as_tensor(x), modes="sdy",
                                     stages=2, phase=phase).numpy()
            assert got.shape == want.shape == (2, 1, 24, 24)
            d = np.abs(got - want)
            assert d.max() <= level * 1.0001, (ps, seed, d.max())
            assert (d > 0).mean() <= 5e-3, (ps, seed, (d > 0).sum())


def test_dmnet_forward_and_layout():
    p = tsn.init_dmnet(np.random.default_rng(3), nf=8)
    assert _layout(p) == _layout(jsn.init_dmnet(jax.random.PRNGKey(0),
                                                nf=8))
    assert p["w6"].shape == (8, 12) and "w5" in p
    x = np.random.default_rng(8).random((2, 1, 12, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jsn.dmnet_apply)(_jax(p), x))
    got = tsn.dmnet_apply(_unit(p), torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 3, 12, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_init_srnets_per_stage_depth():
    got = tsn.init_srnets(np.random.default_rng(0), nf=8, scale=2,
                          modes="s", stages=2, arch="mxu", depth=(2, 3))
    want = jsn.init_srnets(jax.random.PRNGKey(0), nf=8, scale=2, modes="s",
                           stages=2, arch="mxu", depth=(2, 3))
    for k in ("s1_s", "s2_s"):
        assert _layout(got[k]) == _layout(want[k])
    assert "w4" in got["s2_s"] and "w4" not in got["s1_s"]
