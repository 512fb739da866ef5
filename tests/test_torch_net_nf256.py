"""The port's plain net mode at nf=256 (the shipped `artifacts/mxu_distilled_
x4sdy_nf256_d2_ftr2.npz`, which the plain kernels' nf=256 instances serve)
against the JAX package on the CPU, the JAX side run as
tests/test_torch_net_kernels.py runs it (Pallas `interpret=True`, under
`jax.jit`, the routes pinned by test_torch_plain_routes.py's fixture):

- the port's stage stacks and their transposes byte-equal to JAX's;
- K3's plain version (`stage_ensemble_apply_w`, CPU tensors) against the
  JAX window kernel, both stages, mixes None, "inner" and "final_pack";
  K6's against the `_plain_t_*` schedules; K8's against the site-major
  bodies with the "mxu" and the "vpu" head; on 2x1x24x32 inputs;
- `NetEvaluator.from_checkpoint(..., fast=True, device="cpu")`
  `upscale_batch` and `upscale_yuv_batch` on 1x24x32x3 against the JAX
  evaluator (kernel route, interpret mode);
- on chip_smoke's crop, the port's departure from JAX at nf=256 within
  the nf=128 rule (`flip_rates_nf256`), and the card's raw share gate at
  nf=256 (chip_smoke.py ACC_FRAC_NF256) scaled from the nf=128 one by how
  much more often a float32 sum in another order flips a tie at nf=256
  (`sum_flip_rate`: the port's plain version against the same arithmetic
  with float64 sums), as tests/test_torch_net_depth3.py scales the
  depth-3 gates.  The departure from JAX grows less (x1.477 against
  x1.588): both packages sum in float32 FMAs on the CPU, the card's
  tensor cores do not.

Tolerances: the net-mode parity rule (ROADMAP.md): at most 1e-3 of
entries differing, by at most 2 output units; on the CPU no launch.  At
nf=256 the port departs from JAX on 4.3e-4 to 9.9e-4 of stage 2's raw
entries on random 2x1x24x32 inputs (8 seeds; 6.8e-4 on chip_smoke's
crop), so the kernels' inputs are that large: on a 2x1x7x9 input (4,576
entries a stage) one tie flip in a corner of the edge-padded band, whose
sites read the same replicated taps, flips ~8 sites at once (seed 3:
8.1e-3 of stage 2's raw entries).

`PYTHONPATH=. python tests/test_torch_net_nf256.py` prints the rates.
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
from mulut_tpu_torch.ops.resize import full_f32_matmul
from tests.test_torch_net_depth3 import _stage2_raw, flip_rates, smoke_crop
from tests.test_torch_net_evaluate import _jax_kernel_evaluator
from tests.test_torch_plain_routes import _close, _mix_close, _pin_routes

MODES = "sdy"
CFG = dict(stages=2, modes=MODES, scale=4)
_ = _pin_routes  # both packages' default routes, pinned here too


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
    return jax.tree_util.tree_map(np.asarray,
                                  load_params_npz(cs.NET_WEIGHTS_NF256))


@functools.cache
def _stacks():
    """Per stage the JAX site-major stack (bf16) and the port's stack in
    the kernels' layout."""
    p = _weights()
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    return (jsn.stack_srnets_for_fast(bf, **CFG),
            tsn.stack_srnets_for_fast(params_from_numpy(p, "cpu"), **CFG))


def _image(seed: int, shape=(2, 1, 24, 32)):
    """A bf16 stage input for both packages."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.as_tensor(np.asarray(xb, np.float32)).to(torch.bfloat16)


def test_nf256_stacks_equal_jax():
    p = _weights()
    tp = params_from_numpy(p, "cpu")
    for s in (1, 2):
        kw = dict(stage=s, modes=MODES, upscale=4 if s == 2 else 1)
        js, ts = juk.stack_stage_params(p, **kw), tuk.stack_stage_params(
            tp, **kw)
        assert ts["hw"].shape == (2, 3, 256, 256)
        for jd, td in ((js, ts), (juk.transpose_plain_stack(js),
                                  tuk.transpose_plain_stack(ts))):
            assert set(jd) == set(td)
            for k in jd:
                assert td[k].dtype == torch.bfloat16 and td[k].is_contiguous()
                np.testing.assert_array_equal(
                    td[k].float().numpy(),
                    np.asarray(jd[k]).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("mix", [None, "inner", "final_pack"])
def test_nf256_window_plain_equals_jax(mix):
    """K3's plain version against the JAX window kernel, stage by stage;
    stage 2 reads JAX's stage-1 inner output."""
    jst, tst = _stacks()
    xb, _ = _image(3)
    _, _, H, W = xb.shape
    P, offs = juk.window_offsets(MODES)
    Wp, tile = W + 2 * P, 256
    lanes = tuple(P * Wp + P + dy * Wp + dx for dy, dx in offs)
    rows = {None: 16, "inner": 1, "final_pack": 4}[mix]
    for s in range(2):
        jst_t = juk.transpose_plain_stack(jst[s])
        w1e = juk.scatter_window_heads(jst[s], MODES)
        win, (n, _, _, _) = jsn._window_inputs(xb, MODES, tile)

        def run(w, m, j=jst_t, e=w1e):
            return juk.stage_ensemble_apply_w(
                j, e, w, n_modes=3, offs=lanes, tile=tile, interpret=True,
                mix=m)

        if mix is None or (mix == "inner") == (s == 0):
            want = np.asarray(jax.jit(functools.partial(
                run, m=None if mix is None else (mix, 3)))(win))
            plane, _ = tsn._window_plane(torch.as_tensor(np.array(
                xb.astype(jnp.float32))).to(torch.bfloat16), MODES)
            got = tuk.stage_ensemble_apply_w(
                tst[s], plane, modes=MODES, width=Wp, mix=mix,
                v=1 if s == 0 else 16)
            _mix_close(got, want[:rows, :n], mix)
        xb = jax.jit(functools.partial(run, m=("inner", 3)))(win)[
            0, :n].reshape(2, 1, H + 2 * P, Wp)[:, :, P: P + H, P: P + W]
    assert not any(tuk.LAUNCHES.values())


@pytest.mark.parametrize("schedule", ["pass", "rs", "rsiv"])
def test_nf256_feature_plain_equals_jax(monkeypatch, schedule):
    """K6's plain version (raw accumulator) against each
    `PLAIN_T_SCHEDULE` body, both stages."""
    jst, tst = _stacks()
    monkeypatch.setattr(juk, "PLAIN_T_SCHEDULE", schedule)
    for s in range(2):
        xb, xt = _image(30 + s)
        jt = juk.transpose_plain_stack(jst[s])
        want = np.asarray(jax.jit(lambda t, j=jt: juk.stage_ensemble_apply_t(
            j, t, n_modes=3, interpret=True))(jsn._ensemble_taps_t(xb, MODES)))
        got = tuk.stage_ensemble_apply_t(tst[s], tsn._ensemble_taps_t(
            xt, MODES), n_modes=3, v=1 if s == 0 else 16)
        _mix_close(got, want, None)
    assert not any(tuk.LAUNCHES.values())


@pytest.mark.parametrize("head,schedule", [
    ("mxu", "pass"), ("mxu", "iv"), ("mxu", "ivg3"), ("mxu", "rsiv"),
    ("vpu", "pass"), ("vpu", "rs")])
def test_nf256_site_plain_equals_jax(monkeypatch, head, schedule):
    """K8's plain version (raw accumulator) with either head against the
    JAX site-major bodies (`PLAIN_SCHEDULE`), both stages."""
    jst, tst = _stacks()
    monkeypatch.setattr(juk, "PLAIN_SCHEDULE", schedule)
    monkeypatch.setattr(juk, "PLAIN_HEAD", head)
    monkeypatch.setattr(tuk, "PLAIN_HEAD", head)
    for s in range(2):
        xb, xt = _image(20 + s)
        want = np.asarray(jax.jit(lambda t, j=jst[s]: juk.stage_ensemble_apply(
            j, t, n_modes=3, interpret=True))(jsn._ensemble_taps(xb, MODES)))
        got = tuk.stage_ensemble_apply(tst[s], tsn._ensemble_taps(xt, MODES),
                                       n_modes=3, v=1 if s == 0 else 16)
        _mix_close(got, want, None)
    assert not any(tuk.LAUNCHES.values())


@pytest.fixture(scope="module")
def evaluators():
    return (_jax_kernel_evaluator(_weights(), **CFG),
            NetEvaluator.from_checkpoint(cs.NET_WEIGHTS_NF256, fast=True,
                                         device="cpu", **CFG))


@pytest.mark.parametrize("entry", ["upscale_batch", "upscale_yuv_batch"])
def test_nf256_net_evaluator_equals_jax(evaluators, entry):
    """1x24x32x3 random image, uint8 bytes within the CPU rule; the
    port's stacks are nf=256 and nothing launches."""
    jax_ev, port = evaluators
    assert port.stacked[1]["hwt"].shape == (2, 3, 256, 256)
    img = np.random.default_rng(19).integers(0, 256, (1, 24, 32, 3)).astype(
        np.uint8)
    got = getattr(port, entry)(img)
    assert got.dtype == np.uint8 and got.shape == (1, 96, 128, 3)
    _close(got, getattr(jax_ev, entry)(img))
    assert not any(tuk.LAUNCHES.values())


@functools.cache
def flip_rates_nf256():
    """`test_torch_net_depth3.flip_rates` for the nf=256 weights: port
    against JAX on the CPU on chip_smoke's crop (stage 2's raw share
    differing, bytes not equal, bytes off by more than 2, max |diff|)."""
    params, img = _weights(), smoke_crop()
    want, got = _stage2_raw(params, img.transpose(0, 3, 1, 2))
    raw = float((got != want).mean())
    u8_want = _jax_kernel_evaluator(params, **CFG).upscale_batch(img)
    u8_got = NetEvaluator(params, fast=True, device="cpu",
                          **CFG).upscale_batch(img)
    d = np.abs(u8_got.astype(np.int64) - u8_want)
    return raw, float((d > 0).mean()), float((d > 2).mean()), int(d.max())


def test_nf256_cpu_departure_meets_the_rule():
    """On chip_smoke's crop the port departs from JAX at nf=256 within the
    nf=128 rule: stage 2's raw share at most ACC_FRAC, bytes equal at
    least U8_EQUAL, within 2 at least U8_NEAR, none off by more than
    U8_ABS."""
    raw, neq, far, top = flip_rates_nf256()
    assert 0 < raw <= cs.ACC_FRAC and 1 - neq >= cs.U8_EQUAL
    assert 1 - far >= cs.U8_NEAR and top <= cs.U8_ABS


def _acc(st, taps, dtype):
    """`_plain_acc` (float32 head) with its sums in `dtype`, the bf16
    roundings of the activations and the float32 tanh kept."""
    f = {k: v.to(dtype) for k, v in st.items()}
    acc = torch.zeros((taps.shape[0], 16))
    for mi in range(f["w1t"].shape[0]):
        for r in range(4):
            t = taps[:, (mi * 4 + r) * 4: (mi * 4 + r) * 4 + 4].to(dtype)
            x = torch.relu(t @ f["w1t"][mi].T + f["b1"][mi])
            for d in range(f["hwt"].shape[0]):
                x = torch.relu(x.to(torch.bfloat16).to(dtype)
                               @ f["hwt"][d, mi].T + f["hb"][d, mi])
            sl = slice(16 * r, 16 * r + 16)
            o = x.to(torch.bfloat16).to(dtype) @ f["w6t"][mi, sl].T
            acc += torch.round(torch.tanh((o + f["b6"][mi, sl]).float())
                               * 127.0)
    return acc


@functools.cache
def sum_flip_rate(weights):
    """Share of stage 2's raw accumulator entries that the port's plain
    version (float32 sums) and the same arithmetic with float64 sums give
    differently, on chip_smoke's crop from the port's own stage-1 output."""
    st = tsn.stack_srnets_for_fast(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, load_params_npz(weights)), "cpu"), **CFG)
    img = smoke_crop()
    _, _, H, W = img.transpose(0, 3, 1, 2).shape
    x = torch.as_tensor(img.transpose(0, 3, 1, 2).astype(np.float32)
                        / 255).to(torch.bfloat16)
    plane, (Hp, Wp, P) = tsn._window_plane(x, MODES)
    inner = tuk.stage_ensemble_apply_w(st[0], plane, modes=MODES, width=Wp,
                                       mix="inner", v=1)
    x2 = inner[0].reshape(1, 3, Hp, Wp)[:, :, P: P + H, P: P + W]
    taps = tsn._ensemble_taps(x2, MODES)
    with full_f32_matmul():
        a32 = _acc(st[1], taps, torch.float32)
        np.testing.assert_array_equal(
            a32.numpy(), tuk._plain_acc(st[1], taps, 3).numpy())
    return float((a32 != _acc(st[1], taps, torch.float64)).float().mean())


def test_nf256_gate_follows_the_sum_flip_rates():
    """chip_smoke's nf=256 raw share gate is at least its nf=128 gate and
    at most that gate times the ratio of `sum_flip_rate` at nf=256 to that
    at nf=128."""
    r128 = sum_flip_rate(cs.NET_WEIGHTS)
    r256 = sum_flip_rate(cs.NET_WEIGHTS_NF256)
    assert r256 > r128 > 0
    assert cs.ACC_FRAC <= cs.ACC_FRAC_NF256 <= cs.ACC_FRAC * r256 / r128


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_net_nf256.py  (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    for what, (raw, neq, far, top) in (("nf=128", flip_rates(2)),
                                       ("nf=256", flip_rates_nf256())):
        print(f"{what} depth 2, {cs.CROP_H}x{cs.CROP_W} crop, port vs JAX "
              f"on the CPU: stage 2 raw {raw:.4e} of entries differ; bytes "
              f"not equal {neq:.4e}, off by more than 2 {far:.4e}, max "
              f"|diff| {top}")
    r1, r2 = flip_rates(2), flip_rates_nf256()
    print(f"ratio nf=256 / nf=128: raw {r2[0] / r1[0]:.4f}, bytes not equal "
          f"{r2[1] / r1[1]:.4f}")
    s1 = sum_flip_rate(cs.NET_WEIGHTS)
    s2 = sum_flip_rate(cs.NET_WEIGHTS_NF256)
    print(f"float32 against float64 sums, stage 2 raw: nf=128 {s1:.4e}, "
          f"nf=256 {s2:.4e}, ratio {s2 / s1:.4f}")
