"""The port's data and host utilities (`data/`, `utils/metrics.py`,
`utils/imgio.py`) against the JAX package's.

These are the same NumPy (and PIL) code in both packages, so the
tolerance is exact equality throughout: the synthetic trees' files byte
for byte, `DIV2K.sample_batch` for seeds 0 and 3, the first three
batches of `Provider(workerNum=1)`, `SRBenchmark.pairs`, the bicubic LR
pyramid and the metrics (PSNR, SSIM and their Y-channel pair equal as
floats).
"""

import os

import numpy as np
import pytest
import torch

from mulut_tpu import data as jdata
from mulut_tpu.utils import imgio as jio
from mulut_tpu.utils import metrics as jm
from mulut_tpu_torch import data as tdata
from mulut_tpu_torch.utils import imgio as tio
from mulut_tpu_torch.utils import metrics as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for pkg, mod in (("jax", jdata), ("torch", tdata)):
        root = tmp_path_factory.mktemp(pkg)
        out[pkg] = mod.create_synthetic_dataset(str(root), n_train=4,
                                                n_val=2, size=32,
                                                scales=(2, 4))
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


def test_synthetic_trees_equal(trees):
    for key in ("train_dir", "val_dir"):
        a, b = trees["jax"][key], trees["torch"][key]
        assert _files(a) == _files(b) and len(_files(a)) > 3
        for f in _files(a):
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f
    assert trees["jax"]["files"] == trees["torch"]["files"]


@pytest.mark.parametrize("seed", [0, 3])
def test_div2k_batches_equal(trees, seed):
    want = jdata.DIV2K(4, trees["jax"]["train_dir"], 8, seed=seed)
    got = tdata.DIV2K(4, trees["torch"]["train_dir"], 8, seed=seed)
    assert got.file_list == want.file_list
    for _ in range(2):
        (gi, gl), (wi, wl) = got.sample_batch(5), want.sample_batch(5)
        assert gi.dtype == np.uint8 and gi.shape == (5, 1, 8, 8)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_provider_batches_equal(trees):
    want = jdata.Provider(3, 1, 4, trees["jax"]["train_dir"], 8)
    got = tdata.Provider(3, 1, 4, trees["torch"]["train_dir"], 8)
    try:
        for _ in range(3):
            (gi, gl), (wi, wl) = got.next(), want.next()
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    finally:
        got.close()
        want.close()


def test_benchmark_pairs_and_degrade_equal(trees, tmp_path):
    want = jdata.SRBenchmark(trees["jax"]["val_dir"], scale=4)
    got = tdata.SRBenchmark(trees["torch"]["val_dir"], scale=4)
    assert got.datasets == want.datasets == ["Set5"]
    for g, w in zip(got.pairs("Set5"), want.pairs("Set5"), strict=True):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    hr_dir = os.path.join(trees["jax"]["train_dir"], "HR")
    n = tdata.generate_lr_pyramid(hr_dir, str(tmp_path / "t"), scales=(3,),
                                  workers=2, name_suffix=True)
    assert n == jdata.generate_lr_pyramid(hr_dir, str(tmp_path / "j"),
                                          scales=(3,), workers=2,
                                          name_suffix=True) == 4
    for f in _files(str(tmp_path / "j")):
        np.testing.assert_array_equal(tio.load_image(str(tmp_path / "t" / f)),
                                      jio.load_image(str(tmp_path / "j" / f)))
    hr = jio.load_image(os.path.join(hr_dir, "0001.png"))
    np.testing.assert_array_equal(tdata.bicubic_lr(hr, 3),
                                  jdata.bicubic_lr(hr, 3))


def test_metrics_equal():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (30, 34, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255
                ).astype(np.uint8)
    for f in ("rgb2ycbcr",):
        np.testing.assert_array_equal(getattr(tm, f)(a), getattr(jm, f)(a))
    np.testing.assert_array_equal(tm.rgb2ycbcr(a / 255.0, max_val=1),
                                  jm.rgb2ycbcr(a / 255.0, max_val=1))
    for m in (3, 4):
        np.testing.assert_array_equal(tm.modcrop(a, m), jm.modcrop(a, m))
        np.testing.assert_array_equal(tm.modcrop(a[..., 0], m),
                                      jm.modcrop(a[..., 0], m))
    ya, yb = jm.rgb2ycbcr(a)[..., 0], jm.rgb2ycbcr(b)[..., 0]
    assert tm.psnr(ya, yb, 4) == jm.psnr(ya, yb, 4)
    assert tm.ssim(ya, yb) == jm.ssim(ya, yb)
    assert tm.psnr_ssim_y(a, b, 4) == jm.psnr_ssim_y(a, b, 4)


def test_imgio_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    tio.save_image(str(tmp_path / "sub" / "t.png"), img)
    jio.save_image(str(tmp_path / "sub" / "j.png"), img)
    assert (tmp_path / "sub" / "t.png").read_bytes() == (
        tmp_path / "sub" / "j.png").read_bytes()
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "sub" /
                                                     "j.png")), img)
    tio.save_image(str(tmp_path / "g.png"), img[..., 0])
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "g.png")),
                                  jio.load_image(str(tmp_path / "g.png")))
