"""The port's net-mode models, weight import and resize against JAX.

`mulut_tpu_torch.models.{blocks,torch_import,srnet}` and `ops.resize`
against their `mulut_tpu` twins on the CPU, fed the same NumPy params
through `params_from_numpy`.  Every JAX forward runs under `jax.jit`, as
`NetEvaluator` runs it.

Tolerances: weight conversions and tap builders are byte-equal.  Float32
unit outputs and the resize agree to float32 rounding (rtol 1e-5 / atol
1e-4 on [0, 255] values: XLA-CPU and torch sum matmuls in another order).
The float32 cascade's uint8-valued outputs may differ on at most 1e-3 of
entries, by at most 2, because a last-bit difference can flip a
round(127 * tanh) tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.models import blocks as jblocks
from mulut_tpu.models import srnet as jsn
from mulut_tpu.models import torch_import as jti
from mulut_tpu.ops import resize as jresize
from mulut_tpu_torch.models import blocks as tblocks
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models import torch_import as tti
from mulut_tpu_torch.ops import resize as tresize

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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_cascade_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()
    assert d.max() <= 2, d.max()


@pytest.mark.parametrize("dense,depth,nf", [(True, 4, 8), (False, 2, 16),
                                            (False, 3, 8)])
def test_unit_forward_and_layout(dense, depth, nf):
    p = _np(jblocks.init_mulut_unit(jax.random.PRNGKey(depth), nf=nf,
                                    upscale=4, dense=dense, depth=depth))
    assert tblocks.unit_layout(p) == jblocks.unit_layout(p)
    x = np.random.default_rng(nf).random((300, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jblocks.apply_mulut_unit)(p, jnp.asarray(x)))
    tp = tti.params_from_numpy({"u": p}, "cpu")["u"]
    got = tblocks.apply_mulut_unit(tp, torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dense,depth", [(True, 4), (False, 2)])
def test_init_unit_layout_equals_jax(dense, depth):
    want = jblocks.init_mulut_unit(jax.random.PRNGKey(0), nf=32, upscale=2,
                                   dense=dense, depth=depth)
    got = tblocks.init_mulut_unit(np.random.default_rng(0), nf=32,
                                  upscale=2, dense=dense, depth=depth)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    # Kaiming normal (fan_in), zero biases
    assert not got["b1"].any() and not got["b6"].any()
    std = got["w2"].std() * np.sqrt(got["w2"].shape[0] / 2)
    assert 0.85 < std < 1.15
    full = tsn.init_srnets(np.random.default_rng(1), nf=16, arch="mxu")
    ref = _np(jsn.init_srnets(jax.random.PRNGKey(1), nf=16, arch="mxu"))
    assert {k: {n: a.shape for n, a in u.items()} for k, u in full.items()} \
        == {k: {n: a.shape for n, a in u.items()} for k, u in ref.items()}


def test_npz_round_trip_and_artifact(tmp_path):
    path = "artifacts/mxu_distilled_x4sdy_nf128_d2_ftr2.npz"
    got = tti.load_params_npz(path)
    want = _np(jti.load_params_npz(path))
    assert got.keys() == want.keys()
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(got[k][n], want[k][n])
    tp = tti.params_from_numpy(got, "cpu")
    assert tp["s2_y"]["w6"].dtype == torch.float32
    out = tmp_path / "p.npz"
    tti.save_params_npz(str(out), tp)          # tensors in, NumPy on disk
    again = jti.load_params_npz(str(out))       # readable by the JAX package
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(np.asarray(again[k][n]), want[k][n])


def _synthetic_state(rng, dense: bool):
    """A reference-layout SRNets state_dict (stage 1 x1, stage 2 x4)."""
    nf, state = 8, {}
    for s, up in ((1, 1), (2, 4)):
        for m in MODES:
            pre = f"s{s}_{m}.model"
            kh = (1, 4) if m == "y" else (2, 2)
            state[f"{pre}.conv1.conv.weight"] = torch.randn(nf, 1, *kh)
            state[f"{pre}.conv1.conv.bias"] = torch.randn(nf)
            for i in range(2, 6):
                w_in = (i - 1) * nf if dense else nf
                key = f"{pre}.conv{i}.conv1.conv" if dense else \
                    f"{pre}.conv{i}.conv"
                state[f"{key}.weight"] = torch.randn(nf, w_in, 1, 1)
                state[f"{key}.bias"] = torch.randn(nf)
            head = 5 * nf if dense else nf
            state[f"{pre}.conv6.conv.weight"] = torch.randn(up * up, head,
                                                            1, 1)
            state[f"{pre}.conv6.conv.bias"] = torch.randn(up * up)
    return state


@pytest.mark.parametrize("dense", [True, False])
def test_params_from_torch_checkpoint(tmp_path, dense):
    torch.manual_seed(0)
    path = str(tmp_path / "Model.pth")
    torch.save(_synthetic_state(np.random.default_rng(0), dense), path)
    got = tti.srnets_params_from_torch(path, modes=MODES, stages=2)
    want = _np(jti.srnets_params_from_torch(path, modes=MODES, stages=2))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys()
        for n in want[k]:
            assert isinstance(got[k][n], np.ndarray)
            np.testing.assert_array_equal(got[k][n], want[k][n])


@pytest.mark.parametrize("shape,scale", [((2, 2, 9, 13), 4), ((1, 3, 5, 4),
                                                              2)])
def test_bicubic_upscale_equals_jax(shape, scale):
    x = (np.random.default_rng(1).random(shape) * 255).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jresize.bicubic_upscale(a, scale))(
        jnp.asarray(x)))
    got = tresize.bicubic_upscale(torch.as_tensor(x), scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    for n_in, n_out in ((9, 36), (270, 1080), (7, 3)):
        np.testing.assert_array_equal(tresize._bicubic_matrix_np(n_in, n_out),
                                      jresize._bicubic_matrix_np(n_in, n_out))


@pytest.mark.parametrize("mode", list(MODES))
def test_rotation_taps_equal_jax(mode):
    x = np.random.default_rng(2).random((2, 1, 5, 6)).astype(np.float32)
    want = np.asarray(jsn._rotation_taps_batch(jnp.asarray(x), mode))
    got = tsn._rotation_taps_batch(torch.as_tensor(x), mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,nf", [("mxu", 16), ("dense", 8)])
def test_srnets_predict_f32_equals_jax(arch, nf):
    p = _np(jsn.init_srnets(jax.random.PRNGKey(5), nf=nf, arch=arch))
    x = np.random.default_rng(5).random((2, 1, 7, 9)).astype(np.float32)
    kw = dict(modes=MODES, stages=2, scale=4)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict(
        p, a, phase="valid", **kw))(jnp.asarray(x)))
    tp = tti.params_from_numpy(p, "cpu")
    got = tsn.srnets_predict(tp, torch.as_tensor(x), **kw)
    assert got.shape == (2, 1, 28, 36)
    _assert_cascade_close(got.numpy(), want)


@pytest.mark.parametrize("axis", [2, 3])
def test_srnets_predict_tiled_equals_jax_and_untiled(axis):
    p = _np(jsn.init_srnets(jax.random.PRNGKey(6), nf=8, arch="mxu"))
    shape = (1, 1, 27, 10) if axis == 2 else (1, 1, 9, 27)
    x = np.random.default_rng(6).random(shape).astype(np.float32)
    kw = dict(modes=MODES, stages=2, scale=4)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict_tiled(
        p, a, band=8, halo=4, axis=axis, **kw))(jnp.asarray(x)))
    tp = tti.params_from_numpy(p, "cpu")
    got = tsn.srnets_predict_tiled(tp, torch.as_tensor(x), band=8, halo=4,
                                   axis=axis, **kw)
    _assert_cascade_close(got.numpy(), want)
    untiled = tsn.srnets_predict(tp, torch.as_tensor(x), **kw)
    np.testing.assert_array_equal(got.numpy(), untiled.numpy())
