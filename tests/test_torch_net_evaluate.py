"""The port's net-mode forward and `NetEvaluator` against the JAX package.

`srnets_predict_fast` (plain units through K3's plain version, dense units
through K4's) against JAX `srnets_predict_fast(..., interpret=True)`;
`NetEvaluator(device="cpu")` against JAX `NetEvaluator`: its float32 path
as it runs on the CPU, and its fast path as it is configured on a TPU (the
kernel route of evaluate.py:492-542, with the Pallas kernels in interpret
mode; off a TPU the JAX evaluator runs no kernel).  Every JAX forward runs
under `jax.jit`.  Params are the same NumPy arrays for both packages.

Tolerance, end to end on uint8 images: at least 99.9% of bytes equal, and
no byte off by more than 2 (float32 sums and tanh differ in the last bits
between XLA-CPU and torch, which can flip a round(127 * tanh) tie; the
flip then spreads through stage 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu.models.torch_import import save_params_npz
from mulut_tpu.pipelines.evaluate import NetEvaluator as JaxNetEvaluator
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

CFG = dict(stages=2, modes="sdy", scale=4)
ARTIFACT = "artifacts/mxu_distilled_x4sdy_nf128_d2_ftr2.npz"


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
    """The JAX package's default net-mode routes, pinned against
    environment overrides (the flags are not jit keys)."""
    monkeypatch.setattr(jsn, "PLAIN_WINDOW", True)
    monkeypatch.setattr(jsn, "PLAIN_LAYOUT", "feature")
    monkeypatch.setattr(jsn, "DENSE_LAYOUT", "site")
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", "rs")
    for f in (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w):
        f.clear_cache()
    yield
    for f in (juk.stage_ensemble_apply, juk.stage_ensemble_apply_w):
        f.clear_cache()


def _params(arch: str, nf: int, seed: int = 0):
    p = jsn.init_srnets(jax.random.PRNGKey(seed), nf=nf, arch=arch, **CFG)
    return jax.tree_util.tree_map(np.asarray, p)


def _u8_close(got, want, *, frac=1e-3, max_abs=2):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


def _jax_kernel_evaluator(params, **cfg):
    """JAX `NetEvaluator(fast=True)` as a TPU configures it (kernel runs,
    no tiling, the packed luma runner for plain stacks), with the Pallas
    kernels in interpret mode."""
    ev = JaxNetEvaluator(params, **cfg)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    st = jsn.stack_srnets_for_fast(bf, **cfg)
    run = jax.jit(lambda x: jsn.srnets_predict_fast(
        st, x, interpret=True, **cfg).astype(jnp.float32))
    ev._run = run
    ev._run_tiled = lambda x, axis=2: run(x)
    if any("hw" in s for s in st):
        clip = "pack" if cfg["scale"] == 4 else True
        ev._luma_clip_run = jax.jit(lambda x: jsn.srnets_predict_fast(
            st, x, interpret=True, final_clip=clip, **cfg))
    return ev


@pytest.mark.parametrize("arch,nf,final_clip", [
    ("mxu", 16, False), ("mxu", 16, True), ("mxu", 16, "pack"),
    ("dense", 8, False),
])
def test_predict_fast_equals_jax(arch, nf, final_clip):
    p = _params(arch, nf, 1)
    x = np.random.default_rng(1).random((2, 1, 7, 9)).astype(np.float32)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jst = jsn.stack_srnets_for_fast(bf, **CFG)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict_fast(
        jst, a, interpret=True, final_clip=final_clip, **CFG))(
            jnp.asarray(x)))
    tst = tsn.stack_srnets_for_fast(params_from_numpy(p, "cpu"), **CFG)
    got = tsn.srnets_predict_fast(tst, torch.as_tensor(x),
                                  final_clip=final_clip, **CFG)
    assert got.shape == (2, 1, 28, 36)
    if final_clip == "pack":
        assert got.dtype == torch.uint8 and want.dtype == np.uint8
    elif final_clip and arch == "mxu":
        assert got.dtype == torch.bfloat16
    _u8_close(got.float().numpy(), want.astype(np.float32))
    assert not any(tuk.LAUNCHES.values())


@pytest.fixture(scope="module")
def artifact_evaluators():
    from mulut_tpu.models.torch_import import load_params_npz

    params = jax.tree_util.tree_map(np.asarray, load_params_npz(ARTIFACT))
    return (_jax_kernel_evaluator(params, **CFG),
            NetEvaluator.from_checkpoint(ARTIFACT, fast=True, device="cpu",
                                         **CFG))


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_shipped_artifact_upscale_batch(artifact_evaluators, kind):
    """The shipped nf=128 depth-2 `_ftr2` weights on a 1x24x32x3 image
    (measured: 99.99% of bytes equal, max |diff| 1)."""
    jax_ev, port = artifact_evaluators
    if kind == "noise":
        img = np.random.default_rng(8).integers(0, 256, (1, 24, 32, 3))
    else:
        yy, xx = np.mgrid[0:24, 0:32]
        img = np.stack([128 + 100 * np.sin(yy / 5 + c) * np.cos(xx / 7)
                        for c in range(3)], axis=-1)[None]
    img = img.astype(np.uint8)
    want = jax_ev.upscale_batch(img)
    got = port.upscale_batch(img)
    assert got.dtype == np.uint8 and got.shape == (1, 96, 128, 3)
    _u8_close(got, want)


def test_shipped_artifact_yuv(artifact_evaluators):
    jax_ev, port = artifact_evaluators
    img = np.random.default_rng(9).integers(0, 256, (2, 12, 16, 3)).astype(
        np.uint8)
    want = jax_ev.upscale_yuv_batch(img)
    got = port.upscale_yuv_batch(img)
    assert got.dtype == np.uint8 and got.shape == (2, 48, 64, 3)
    _u8_close(got, want)
    np.testing.assert_array_equal(port.upscale_yuv(img[1]), got[1])


@pytest.mark.parametrize("arch,nf", [("mxu", 16), ("dense", 8)])
def test_net_evaluator_fast_equals_jax(arch, nf):
    p = _params(arch, nf, 2)
    jax_ev = _jax_kernel_evaluator(p, **CFG)
    port = NetEvaluator(p, fast=True, device="cpu", **CFG)
    assert (port._luma_clip == "pack") == (arch == "mxu")
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    got = port.upscale_batch(imgs)
    _u8_close(got, jax_ev.upscale_batch(imgs))
    np.testing.assert_array_equal(port.upscale(imgs[0]), got[0])
    _u8_close(port.upscale_yuv_batch(imgs), jax_ev.upscale_yuv_batch(imgs))


def test_net_evaluator_f32_equals_jax():
    """The float32 path, untiled and band-tiled (h*w above
    TILE_THRESHOLD), RGB and YUV."""
    p = _params("mxu", 8, 3)
    jax_ev = JaxNetEvaluator(p, **CFG)
    port = NetEvaluator(p, device="cpu", **CFG)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    _u8_close(port.upscale_batch(imgs), jax_ev.upscale_batch(imgs))
    _u8_close(port.upscale_yuv_batch(imgs), jax_ev.upscale_yuv_batch(imgs))
    big = rng.integers(0, 256, (98, 97, 3)).astype(np.uint8)
    assert 98 * 97 > NetEvaluator.TILE_THRESHOLD
    _u8_close(port.upscale(big), jax_ev.upscale(big))


def test_from_checkpoint_npz(tmp_path):
    p = _params("mxu", 8, 4)
    path = str(tmp_path / "p.npz")
    save_params_npz(path, p)
    ev = NetEvaluator.from_checkpoint(path, device="cpu", **CFG)
    for k in p:
        for n in p[k]:
            np.testing.assert_array_equal(ev.params[k][n].numpy(), p[k][n])


def test_no_cpu_fallback(monkeypatch):
    """Without a device argument the evaluator runs on the card, and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NetEvaluator(_params("mxu", 8), fast=True, **CFG)


@pytest.mark.parametrize("kw,what", [
    # quant (K11) is ported; tests/test_torch_quant.py holds it
    pytest.param(dict(n_devices=2), "n_devices", id="kw1-n_devices")])
def test_later_slices_raise(kw, what):
    """n_devices > 1, refused until the port's parallel slice, shards the
    batch over CPU shards with one device's bytes
    (tests/test_torch_parallel.py holds it against JAX's)."""
    params = _params("mxu", 8)
    imgs = np.random.default_rng(3).integers(0, 256, (3, 10, 12, 3),
                                             dtype=np.uint8)
    one = NetEvaluator(params, fast=True, device="cpu", **CFG)
    many = NetEvaluator(params, fast=True, device="cpu", **kw, **CFG)
    assert many.n_devices == kw[what]
    np.testing.assert_array_equal(many.upscale_batch(imgs),
                                  one.upscale_batch(imgs))


def parity_report(shape=(1, 3, 48, 64), seed=0):
    """Flip rates of the port (torch, CPU) against JAX (CPU, Pallas in
    interpret mode) on the shipped `_ftr2` weights: raw accumulators per
    stage from the same stage input, and uint8 end to end; then end to end
    again with the inner mix computed as an exact division."""
    from mulut_tpu.models.torch_import import load_params_npz

    params = jax.tree_util.tree_map(np.asarray, load_params_npz(ARTIFACT))
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    jst = jsn.stack_srnets_for_fast(bf, **CFG)
    tst = tsn.stack_srnets_for_fast(params_from_numpy(params, "cpu"), **CFG)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[2], 0:shape[3]]
    images = {
        "noise": rng.integers(0, 256, shape),
        "smooth": np.stack([128 + 100 * np.sin(yy / 5 + c) * np.cos(xx / 7)
                            for c in range(shape[1])])[None],
    }
    P, offs = juk.window_offsets(CFG["modes"])
    H, W = shape[2:]
    Wp, tile = W + 2 * P, 2048
    lanes = tuple(P * Wp + P + dy * Wp + dx for dy, dx in offs)
    for name, img in images.items():
        x = jnp.asarray(img.astype(np.float32) / 255.0).astype(jnp.bfloat16)
        for s in range(2):
            win, (n, _, _, _) = jsn._window_inputs(x, CFG["modes"], tile)
            st_t = juk.transpose_plain_stack(jst[s])
            w1e = juk.scatter_window_heads(jst[s], CFG["modes"])

            def jrun(mix, st_t=st_t, w1e=w1e, win=win):
                return np.asarray(jax.jit(
                    lambda w: juk.stage_ensemble_apply_w(
                        st_t, w1e, w, n_modes=3, offs=lanes, tile=tile,
                        interpret=True, mix=mix))(win))

            want = jrun(None)[:, :n]
            plane, _ = tsn._window_plane(
                torch.as_tensor(np.array(x.astype(jnp.float32))).to(
                    torch.bfloat16), CFG["modes"])
            got = tuk.stage_ensemble_apply_w(
                tst[s], plane, modes=CFG["modes"], width=Wp).numpy()
            rows = 1 if s == 0 else 16
            d = np.abs(got[:rows] - want[:rows])
            print(f"{name} stage {s + 1} acc: {(d > 0).mean():.3e} of "
                  f"{d.size} entries differ, max |diff| {d.max():g}")
            if s == 0:
                x = jnp.asarray(jrun(("inner", 3))[0, :n]).reshape(
                    shape[0], shape[1], H + 2 * P, Wp)[
                        :, :, P: P + H, P: P + W]
        u8 = img.astype(np.uint8).transpose(0, 2, 3, 1)
        want = _jax_kernel_evaluator(params, **CFG).upscale_batch(u8)
        port = NetEvaluator(params, fast=True, device="cpu", **CFG)
        got = port.upscale_batch(u8)
        d = np.abs(got.astype(int) - want)
        print(f"{name} end to end: {(d == 0).mean():.5%} of bytes equal, "
              f"max |diff| {d.max()}")
        exact = tuk.inner_mix

        def divide(acc, n_modes, dtype=torch.bfloat16):
            y = acc / (4 * n_modes) + 127.0
            return (torch.clamp(torch.round(y), 0, 255) / 255.0).to(dtype)

        tuk.inner_mix = divide
        try:
            got = port.upscale_batch(u8)
        finally:
            tuk.inner_mix = exact
        d = np.abs(got.astype(int) - want)
        print(f"{name} end to end, exact-division inner mix: "
              f"{(d == 0).mean():.5%} of bytes equal, max |diff| {d.max()}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_net_evaluate.py  (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    parity_report()
