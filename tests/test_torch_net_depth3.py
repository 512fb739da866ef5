"""The depth-3 plain weights (`artifacts/mxu_distilled_x4sdy_nf128_d3_ftr2
.npz`): the port on the CPU against the JAX package on the CPU (its kernel
route, Pallas in interpret mode), beside the shipped depth-2 weights.

The net-mode parity rule's card gates (`chip_smoke.py`: raw accumulator
share ACC_FRAC, crop bytes equal U8_EQUAL) were set on the depth-2
weights.  One more hidden layer flips more bf16 ties between any two
summation orders, so `chip_smoke.py` holds depth 3 to gates scaled by the
rate at which the port's CPU path departs from JAX at depth 3 over the
rate at depth 2, both measured here on chip_smoke's own 135 x 240 crop:

- `flip_rates(depth)`: stage 2's raw accumulator from the same stage
  input (share of differing entries) and the uint8 output (share of bytes
  not equal), port against JAX;
- `test_depth3_gates_follow_the_cpu_rates` holds chip_smoke's depth-3
  gates to at most the depth-2 gates times that ratio;
- `test_depth3_cpu_rates_meet_the_card_gates` holds the depth-3 rates
  themselves to those gates: the CPU suite's depth-3 parity check.

`PYTHONPATH=. python tests/test_torch_net_depth3.py` prints the rates,
and also the end-to-end bytes on test_torch_net_evaluate.py's 1x24x32
smooth image (`smooth_rates`), where at depth 3 one flipped stage-1 value
spreads over ~160 bytes of the x4 output, more than the depth-2 CPU rule
(1e-3 of bytes, max 2) allows on so small an image.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu.models.torch_import import load_params_npz
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator
from tests.test_torch_net_evaluate import (CFG, _jax_kernel_evaluator,
                                           _pin_jax_routes)

ARTIFACTS = {2: cs.NET_WEIGHTS, 3: cs.NET_WEIGHTS_D3}
_ = _pin_jax_routes  # the JAX package's default routes, pinned here too


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(depth):
    return jax.tree_util.tree_map(np.asarray,
                                  load_params_npz(ARTIFACTS[depth]))


@functools.cache
def smoke_crop():
    """chip_smoke.py's crop: frame 0 of its seed-0 batch, 135 x 240."""
    rng = np.random.default_rng(0)
    cs._random_luts(rng)   # the batch is drawn after the LUTs
    imgs = rng.integers(0, 256, (cs.BATCH, cs.H, cs.W, 3),
                        dtype=np.int64).astype(np.uint8)
    return np.ascontiguousarray(imgs[:1, :cs.CROP_H, :cs.CROP_W])


def _stage2_raw(params, img):
    """Stage 2's raw accumulator (16 lanes, image and pad-band sites), JAX
    and port, both from JAX's stage-1 output."""
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    jst = jsn.stack_srnets_for_fast(bf, **CFG)
    tst = tsn.stack_srnets_for_fast(params_from_numpy(params, "cpu"), **CFG)
    P, offs = juk.window_offsets(CFG["modes"])
    _, C, H, W = img.shape
    Wp, tile = W + 2 * P, 2048
    lanes = tuple(P * Wp + P + dy * Wp + dx for dy, dx in offs)
    x = jnp.asarray(img.astype(np.float32) / 255.0).astype(jnp.bfloat16)
    for s in range(2):
        win, (n, _, _, _) = jsn._window_inputs(x, CFG["modes"], tile)
        st_t = juk.transpose_plain_stack(jst[s])
        w1e = juk.scatter_window_heads(jst[s], CFG["modes"])
        mix = None if s else ("inner", 3)
        out = np.asarray(jax.jit(lambda w: juk.stage_ensemble_apply_w(
            st_t, w1e, w, n_modes=3, offs=lanes, tile=tile, interpret=True,
            mix=mix))(win))
        if s == 0:
            x = jnp.asarray(out[0, :n]).reshape(
                1, C, H + 2 * P, Wp)[:, :, P: P + H, P: P + W]
    plane, _ = tsn._window_plane(
        torch.as_tensor(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        CFG["modes"])
    got = tuk.stage_ensemble_apply_w(tst[1], plane, modes=CFG["modes"],
                                     width=Wp).numpy()
    return out[:, :n], got


@functools.cache
def flip_rates(depth):
    """Port against JAX on the CPU, on chip_smoke's crop: (share of stage
    2's raw entries differing, share of output bytes not equal, share of
    output bytes off by more than 2, max |diff| of a byte)."""
    params = _params(depth)
    img = smoke_crop()
    want, got = _stage2_raw(params, img.transpose(0, 3, 1, 2))
    raw = float((got != want).mean())
    u8_want = _jax_kernel_evaluator(params, **CFG).upscale_batch(img)
    u8_got = NetEvaluator(params, fast=True, device="cpu",
                          **CFG).upscale_batch(img)
    d = np.abs(u8_got.astype(np.int64) - u8_want)
    return raw, float((d > 0).mean()), float((d > 2).mean()), int(d.max())


def test_depth3_gates_follow_the_cpu_rates():
    """chip_smoke's depth-3 share gates are at most its depth-2 gates
    times the ratio of the port's departure from JAX at depth 3 to that
    at depth 2; the other gates are the depth-2 ones."""
    r2, r3 = flip_rates(2), flip_rates(3)
    assert r3[0] > r2[0] > 0 and r3[1] > r2[1] > 0
    assert cs.ACC_FRAC_D3 <= cs.ACC_FRAC * r3[0] / r2[0]
    assert 1 - cs.U8_EQUAL_D3 <= (1 - cs.U8_EQUAL) * r3[1] / r2[1]
    assert cs.ACC_FRAC_D3 >= cs.ACC_FRAC and cs.U8_EQUAL_D3 <= cs.U8_EQUAL


def test_depth3_cpu_rates_meet_the_card_gates():
    """The depth-3 CPU parity check: on chip_smoke's crop the port departs
    from JAX within the depth-3 rule chip_smoke applies on the card
    (stage 2's raw share at most ACC_FRAC_D3, bytes equal at least
    U8_EQUAL_D3, within 2 at least U8_NEAR, none off by more than
    U8_ABS)."""
    raw, neq, far, top = flip_rates(3)
    assert raw <= cs.ACC_FRAC_D3
    assert 1 - neq >= cs.U8_EQUAL_D3
    assert 1 - far >= cs.U8_NEAR and top <= cs.U8_ABS


def smooth_rates(depth):
    """Port against JAX on the CPU, end to end on the 1x24x32 smooth image
    of test_torch_net_evaluate.py: (share of bytes not equal, max
    |diff|)."""
    params = _params(depth)
    yy, xx = np.mgrid[0:24, 0:32]
    img = np.stack([128 + 100 * np.sin(yy / 5 + c) * np.cos(xx / 7)
                    for c in range(3)], axis=-1)[None].astype(np.uint8)
    want = _jax_kernel_evaluator(params, **CFG).upscale_batch(img)
    got = NetEvaluator(params, fast=True, device="cpu",
                       **CFG).upscale_batch(img)
    d = np.abs(got.astype(np.int64) - want)
    return float((d > 0).mean()), int(d.max())


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_net_depth3.py  (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    for depth in (2, 3):
        raw, neq, far, top = flip_rates(depth)
        print(f"depth {depth}, {cs.CROP_H}x{cs.CROP_W} crop, port vs JAX "
              f"on the CPU: stage 2 raw {raw:.4e} of entries differ; "
              f"bytes not equal {neq:.4e}, off by more than 2 {far:.4e}, "
              f"max |diff| {top}")
    r2, r3 = flip_rates(2), flip_rates(3)
    print(f"ratio depth 3 / depth 2: raw {r3[0] / r2[0]:.4f}, bytes not "
          f"equal {r3[1] / r2[1]:.4f}")
    for depth in (2, 3):
        neq, top = smooth_rates(depth)
        print(f"depth {depth}, 24x32 smooth image, port vs JAX on the CPU: "
              f"bytes not equal {neq:.4e}, max |diff| {top}")
