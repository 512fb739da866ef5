"""The port's W8A8 path at nf=256 (`artifacts/mxu_distilled_x4sdy_nf256_d2_
ftr2.npz`, the width K11's nf=256 instance serves) against the JAX package
on the CPU, with the JAX side run as tests/test_torch_quant.py runs it
(Pallas `interpret=True`, under `jax.jit`):

- the port's quantized stacks byte-equal to the JAX package's, "int" and
  "f32";
- K11's plain version (`stage_ensemble_apply_q`, given CPU tensors)
  against `_plain_q2_kernel` ("int") and `_plain_q_kernel` ("f32") on a
  small seeded tap matrix, both stages, within test_torch_quant.py's rule
  (at most 1e-3 of raw entries differing, by at most 2);
- `NetEvaluator(quant=..., device="cpu")` on a small image against JAX's
  `srnets_predict_fast` on the JAX stacks, within the same rule on bytes.

Each unit is calibrated once per package across the module
(`calibrate_once`), and each JAX stack is built once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
from mulut_tpu.models.torch_import import load_params_npz as jax_load_npz
from mulut_tpu.ops import quant as jq
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import quant as tq
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator
from tests.test_torch_quant import (CFG, _assert_stack_equal, _close,
                                    _jax_fast, _jax_stage, _jax_u8,
                                    calibrate_once)

ARTIFACT = "artifacts/mxu_distilled_x4sdy_nf256_d2_ftr2.npz"
_ = calibrate_once  # the module-scoped fixture, shared from test_torch_quant


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
def _weights():
    return jax.tree_util.tree_map(np.asarray, jax_load_npz(ARTIFACT))


@functools.cache
def _jax_stacks(requant):
    return jq.quantize_srnets_for_fast(_weights(), requant=requant, **CFG)


@functools.cache
def _port_stacks(requant):
    return tq.quantize_srnets_for_fast(params_from_numpy(_weights(), "cpu"),
                                       requant=requant, **CFG)


@pytest.mark.parametrize("requant", ["int", "f32"])
def test_nf256_stacks_equal_jax(requant, calibrate_once):
    want = _jax_stacks(requant)
    got = _port_stacks(requant)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_stack_equal(g, w, requant)
        assert g["hwqt"].shape == (2, 3, 256, 256)
        assert g["w6qt"].shape == (3, 64, 256)


@pytest.mark.parametrize("requant,body", [("int", "_plain_q2_kernel"),
                                          ("f32", "_plain_q_kernel")])
def test_nf256_k11_plain_equals_jax_kernel(requant, body, calibrate_once):
    """Both stages from the same bf16 tap matrix (2x1x7x9)."""
    jst = _jax_stacks(requant)
    picked = "_plain_q2_kernel" if "hmq" in jst[0] else "_plain_q_kernel"
    assert picked == body and jst[0]["w6q"].ndim == (4 if "hmq" in jst[0]
                                                    else 3)
    tst = _port_stacks(requant)
    x = np.random.default_rng(18).random((2, 1, 7, 9)).astype(np.float32)
    taps_j = jsn._ensemble_taps(jnp.asarray(x).astype(jnp.bfloat16), "sdy")
    taps_t = tsn._ensemble_taps(torch.as_tensor(x).to(torch.bfloat16), "sdy")
    for s in range(2):
        want = np.asarray(_jax_stage(jst[s], taps_j))
        got = tuk.stage_ensemble_apply(tst[s], taps_t, n_modes=3,
                                       v=1 if s == 0 else 16)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got.numpy(), want)
    assert not any(tuk.LAUNCHES.values())


@pytest.mark.parametrize("quant", [True, "f32"])
def test_nf256_net_evaluator_quant_equals_jax(quant, calibrate_once):
    """1x24x32x3 random image: uint8 bytes within the net-mode CPU rule."""
    requant = "int" if quant is True else quant
    imgs = np.random.default_rng(19).integers(0, 256, (1, 24, 32, 3)).astype(
        np.uint8)
    port = NetEvaluator(_weights(), quant=quant, device="cpu", **CFG)
    assert port.stacked[1]["hwqt"].shape[-1] == 256
    got = port.upscale_batch(imgs)
    assert got.dtype == np.uint8 and got.shape == (1, 96, 128, 3)
    want = _jax_u8(functools.partial(_jax_fast, _jax_stacks(requant)), imgs)
    _close(got, want)
    assert not any(tuk.LAUNCHES.values())
