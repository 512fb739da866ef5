"""The port's step 2, LUT transfer (`pipelines/transfer.py`), against the
JAX package on the CPU, and the deployment of what it caches.

Tolerances:

- `lut_grid`: equal (the same NumPy arithmetic).
- `cache_lut`, for the six units of the shipped plain `_ftr2` weights
  (nf=128, depth 2) and six seeded dense nf=8 units: byte-equal to JAX's
  except for round(127 * x) ties that float32 sums flip between XLA-CPU
  and torch: at most 2e-5 of a table's entries may differ, by 1
  (measured: 0 in every stage-1 table but one, 8-15 of the 1,336,336
  entries of each stage-2 table; ROADMAP Queue C).
- `transfer_to_luts` feeding `LutEvaluator(device="cpu").upscale_batch`:
  byte-equal to JAX's `LutEvaluator` on the same tables (the LUT path
  allows no difference).

JAX's `cache_lut` jits its unit forward at Precision.HIGHEST; the port's
runs float32 with TF32 off.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.pipelines.evaluate import LutEvaluator as JaxEvaluator
from mulut_tpu_torch.models.srnet import init_srnets
from mulut_tpu_torch.models.torch_import import load_params_npz
from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

jtf = importlib.import_module("mulut_tpu.pipelines.transfer")
ttf = importlib.import_module("mulut_tpu_torch.pipelines.transfer")

ARTIFACT = "artifacts/mxu_distilled_x4sdy_nf128_d2_ftr2.npz"
CFG = dict(stages=2, modes="sdy")
FLIP_SHARE = 2e-5


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
def _params(which: str) -> dict:
    if which == "ftr2":
        return load_params_npz(ARTIFACT)
    return init_srnets(np.random.default_rng(3), nf=8, arch="dense", **CFG)


@functools.cache
def _jax_luts(which: str) -> dict:
    p = jax.tree_util.tree_map(jnp.asarray, _params(which))
    return {k: jtf.cache_lut(p[k]) for k in sorted(p)}


def test_lut_grid_equal():
    for interval in (4, 5):
        np.testing.assert_array_equal(ttf.lut_grid(interval),
                                      jtf.lut_grid(interval))


@pytest.mark.parametrize("which", ["ftr2", "dense8"])
def test_cache_lut_matches_jax(which):
    want = _jax_luts(which)
    for key, w in want.items():
        got = ttf.cache_lut(_params(which)[key], device="cpu")
        assert got.dtype == np.int8 and got.shape == w.shape
        d = np.abs(got.astype(int) - w.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= FLIP_SHARE, (
            key, int((d > 0).sum()))


def test_transferred_tables_deploy_like_jax():
    """The port's tables through the port's `LutEvaluator` on the CPU and
    JAX's evaluator on the same tables: bytes equal."""
    luts = ttf.transfer_to_luts(_params("ftr2"), device="cpu", **CFG)
    assert sorted(luts) == sorted(_jax_luts("ftr2"))
    imgs = np.random.default_rng(9).integers(0, 256, (2, 11, 20, 3)).astype(
        np.uint8)
    want = JaxEvaluator(luts, scale=4, **CFG).upscale_batch(imgs)
    got = LutEvaluator(luts, scale=4, device="cpu", **CFG).upscale_batch(imgs)
    assert got.shape == (2, 44, 80, 3)
    np.testing.assert_array_equal(got, want)


def test_transfer_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.transfer_to_luts(_params("dense8"), **CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.cache_lut(_params("dense8")["s1_s"])
