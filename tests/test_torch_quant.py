"""The port's W8A8 net-mode path (`ops/quant.py`, kernel K11) against the
JAX package.

- Quantization (calibration, fixed-point constants, the stacks) is the
  same NumPy arithmetic in both packages: byte-equal, for every key and
  every requant form, with the port's stack turned back into the JAX
  layout by `quant.jax_stack`.
- K11's plain version (`stage_ensemble_apply_q`, given CPU tensors)
  against each JAX body, `_plain_q_kernel` ("f32"), `_plain_qw6_kernel`
  ("f32w6") and `_plain_q2_kernel` ("int"), through JAX
  `stage_ensemble_apply(..., interpret=True)` on the same bf16 tap matrix:
  raw accumulators may differ on at most 1e-3 of entries, by at most 2
  (float32 tanh differs in the last bits between XLA-CPU and torch and can
  flip a round(127 * tanh) tie; the int8 products are exact and the head
  and the fused multiply-adds bit-faithful).
- The slice end to end: `NetEvaluator(quant=..., device="cpu")` against
  JAX `srnets_predict_fast` on the JAX quantized stacks: at least 99.9% of
  uint8 bytes equal, none off by more than 2.
- The kernel's register dataflow: a NumPy model of `mma.sync.m16n8k32`'s
  fragment layouts (per warp, those of the int8 `wgmma` m64nNk32 that
  csrc/plain_w8a8.cu runs; tests/test_torch_w8a8_wgmma.py models the
  warpgroup and the staged B), fed with the kernel's packing from the
  stack's permuted input axis, gives the plain matrix product.

Every JAX forward runs under `jax.jit`.  Params are the same NumPy arrays
for both packages.  Each unit is calibrated once per package (fixture
`calibrate_once`), each JAX stack is built once (`_jax_stacks`) and each
JAX forward compiled once per shape, shared across the tests below.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mulut_tpu.models.srnet as jsn
import mulut_tpu.ops.unit_kernel as juk
from mulut_tpu.models.blocks import init_mulut_unit as jax_init_unit
from mulut_tpu.models.torch_import import load_params_npz as jax_load_npz
from mulut_tpu.ops import quant as jq
from mulut_tpu.pipelines.evaluate import NetEvaluator as JaxNetEvaluator
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import quant as tq
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

CFG = dict(stages=2, modes="sdy", scale=4)
ARTIFACT = "artifacts/mxu_distilled_x4sdy_nf128_d2_ftr2.npz"
FORMS = ["int", "f32", "f32w6"]


#: the nf=16 and nf=32 param sets most tests share: (nf, depth, seed, dead)
NF16 = (16, 2, 10, False)
NF32 = (32, 2, 34, True)


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
def _params(nf: int, depth: int = 2, seed: int = 0, dead: bool = False):
    """Plain-unit float32 NumPy params for both packages (shared: never
    written to), with small random biases; `dead` makes hidden channel 3
    of every unit's first hidden layer negative on the whole input box (a
    dead channel)."""
    rng = np.random.default_rng(seed)
    p = tsn.init_srnets(rng, nf=nf, arch="mxu", depth=depth, **CFG)
    for unit in p.values():
        for k in unit:
            if k.startswith("b"):
                unit[k] = (0.1 * rng.standard_normal(unit[k].shape)).astype(
                    np.float32)
    if dead:
        for unit in p.values():
            unit["w2"][:, 3] = -np.abs(unit["w2"][:, 3])
            unit["b2"][3] = -0.5
    return p


@functools.cache
def _artifact():
    return jax.tree_util.tree_map(np.asarray, jax_load_npz(ARTIFACT))


def _weights(key):
    """Params by key: "ftr2" (the shipped nf=128 weights) or `_params`'
    argument tuple."""
    return _artifact() if key == "ftr2" else _params(*key)


@functools.cache
def _jax_stacks(key, requant):
    return jq.quantize_srnets_for_fast(_weights(key), requant=requant, **CFG)


def _port_stacks(key, requant):
    return tq.quantize_srnets_for_fast(params_from_numpy(_weights(key), "cpu"),
                                       requant=requant, **CFG)


def _memo_calibration(calibrate):
    """`calibrate` run once per unit, keyed by its weights' bytes."""
    cache = {}

    def run(unit, **kw):
        digest = hashlib.sha1(b"".join(tq._np32(unit[k]).tobytes()
                                       for k in sorted(unit))).hexdigest()
        key = (digest, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = calibrate(unit, **kw)
        return cache[key]

    return run


@pytest.fixture(scope="module")
def calibrate_once():
    """Each package calibrates each unit once across this module.  The
    calibration is a pure function of the unit, compared on its own in (a)
    and in tests/test_torch_copies.py; each package keeps its own cache, so
    its stacks still come from its own calibration."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jq, tq):
            mp.setattr(mod, "calibrate_plain_unit",
                       _memo_calibration(mod.calibrate_plain_unit))
        yield


#: JAX `stage_ensemble_apply` (raw accumulators) and `srnets_predict_fast`,
#: the stack a traced argument, so one compile serves every stage and call
_jax_stage = jax.jit(functools.partial(juk.stage_ensemble_apply, n_modes=3,
                                       interpret=True))
_jax_fast = jax.jit(lambda st, x: jsn.srnets_predict_fast(
    st, x, interpret=True, **CFG).astype(jnp.float32))


def _as_np(t):
    """Port tensor -> NumPy, bf16 as float32 (compared with JAX bf16 cast
    to float32: equal float32 values are equal bf16 bytes)."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_stack_equal(port_st: dict, jax_st: dict, requant: str):
    got = tq.jax_stack(port_st, requant)
    assert set(got) == set(jax_st)
    for k, want in jax_st.items():
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert got[k].dtype == torch.bfloat16, k
            want = want.astype(np.float32)
        g = _as_np(got[k])
        assert g.dtype == want.dtype and g.shape == want.shape, k
        np.testing.assert_array_equal(g, want, err_msg=k)


def _close(got, want, *, frac=1e-3, max_abs=2):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 0).mean() <= frac, (d > 0).mean()
    assert d.max() <= max_abs, d.max()


# ---------------------------------------------------------------------------
# (a) calibration and fixed point
# ---------------------------------------------------------------------------


def test_calibration_equals_jax_with_dead_channel():
    unit = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax_init_unit(jax.random.PRNGKey(3), nf=16, upscale=4, dense=False,
                      depth=3))
    unit["w3"][:, 5] = -np.abs(unit["w3"][:, 5])
    unit["b3"][5] = -1.0
    want = jq.calibrate_plain_unit(unit)
    got = tq.calibrate_plain_unit(params_from_numpy({"u": unit}, "cpu")["u"])
    assert got.keys() == want.keys()
    assert got["hidden"][1, 5] == 0.0            # the dead channel
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_fixed_point_equals_jax_at_the_edges():
    """Random columns, dead ones (hcq = 0), a bias past the +-2^29 clamp,
    tiny and large multipliers."""
    rng = np.random.default_rng(4)
    hcq = (rng.random((2, 3, 32)) * 1e-3).astype(np.float32)
    hbq = (rng.standard_normal((2, 3, 32)) * 60).astype(np.float32)
    hcq[0, 0, :4] = 0.0
    hbq[0, 0, :4] = 0.0
    hbq[1, 2, 7], hbq[1, 2, 8] = 3e9, -3e9       # clamped to +-2^29
    hcq[1, 1, 9], hcq[1, 1, 10] = 1e-12, 40.0
    for nf in (32, 128):
        want = jq._fixed_point(hcq, hbq, nf)
        got = tq._fixed_point(hcq, hbq, nf)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert got[3][1, 2, 7] == 2 ** 29 and got[3][1, 2, 8] == -(2 ** 29)
    assert not got[0][0, 0, :4].any()


# ---------------------------------------------------------------------------
# (b) quantized stacks: the weights carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("requant", FORMS)
@pytest.mark.parametrize("nf,depth", [(16, 1), (32, 2), (16, 3)])
def test_quantized_stacks_equal_jax(requant, nf, depth, calibrate_once):
    key = (nf, depth, nf + depth, depth >= 2)
    want = _jax_stacks(key, requant)
    got = _port_stacks(key, requant)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_stack_equal(g, w, requant)
        assert all(t.is_contiguous() for t in g.values())
        assert g["hwqt"].shape == (depth, 3, nf, nf)
        assert g["w6qt"].shape == (3, 64, nf)


def test_f32_forms_share_one_stack(calibrate_once):
    p = _params(*NF16)
    a, b = (tq.quantize_srnets_for_fast(p, requant=r, **CFG)
            for r in ("f32", "f32w6"))
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_k32_feature_order_and_round_trip(calibrate_once):
    order = tq.k32_feature_order(40)
    assert sorted(order) == list(range(40))
    # logical k = 4t + i of a 16-wide half reads 8*(i >> 1) + 2t + (i & 1)
    assert list(order[:16]) == [0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6,
                                7, 14, 15]
    assert list(order[32:]) == list(range(32, 40))
    p = _params(*NF16)
    st = tuk.stack_stage_params(params_from_numpy(p, "cpu"), stage=2,
                                upscale=4, modes="sdy")
    for requant in FORMS:
        q = tq.quantize_plain_stack(st, p, stage=2, modes="sdy",
                                    requant=requant)
        back = tq.jax_stack(tq.kernel_stack(q), requant)
        assert back.keys() == q.keys()
        for k in q:
            assert torch.equal(back[k], q[k]), k


# ---------------------------------------------------------------------------
# (c) K11's plain version against each JAX kernel body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("requant,body", [
    ("f32", "_plain_q_kernel"), ("f32w6", "_plain_qw6_kernel"),
    ("int", "_plain_q2_kernel")])
def test_k11_plain_equals_jax_kernel(requant, body, calibrate_once):
    """Both stages from the same bf16 tap matrix (nf=32 depth 2 with a
    dead channel, 2x1x7x9)."""
    jst = _jax_stacks(NF32, requant)
    tst = _port_stacks(NF32, requant)
    # the JAX entry's dispatch (unit_kernel.py:1316-1337) picks `body`
    picked = ("_plain_q2_kernel" if "hmq" in jst[0] else
              "_plain_qw6_kernel" if jst[0]["w6q"].ndim == 4 else
              "_plain_q_kernel")
    assert picked == body
    x = np.random.default_rng(8).random((2, 1, 7, 9)).astype(np.float32)
    taps_j = jsn._ensemble_taps(jnp.asarray(x).astype(jnp.bfloat16), "sdy")
    taps_t = tsn._ensemble_taps(torch.as_tensor(x).to(torch.bfloat16), "sdy")
    for s in range(2):
        want = np.asarray(_jax_stage(jst[s], taps_j))
        got = tuk.stage_ensemble_apply(tst[s], taps_t, n_modes=3,
                                       v=1 if s == 0 else 16)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got.numpy(), want)
    assert not any(tuk.LAUNCHES.values())


def test_k11_wrapper_checks_inputs(calibrate_once):
    st = _port_stacks(NF16, "int")[1]
    taps = torch.zeros((5, 48), dtype=torch.bfloat16)
    assert tuk.stage_ensemble_apply_q(st, taps, n_modes=3).shape == (5, 16)
    with pytest.raises(ValueError, match="taps"):
        tuk.stage_ensemble_apply_q(st, taps[:, :40], n_modes=3)
    with pytest.raises(ValueError, match="modes"):
        tuk.stage_ensemble_apply_q(st, taps[:, :32], n_modes=2)
    with pytest.raises(ValueError, match="int8"):
        tuk.stage_ensemble_apply_q(dict(st, hwqt=st["hwqt"].float()), taps,
                                   n_modes=3)
    with pytest.raises(ValueError, match="lacks 'hbi'"):
        tuk.stage_ensemble_apply_q({k: v for k, v in st.items()
                                    if k != "hbi"}, taps, n_modes=3)
    with pytest.raises(ValueError, match="device"):
        tuk.stage_ensemble_apply_q(st, taps.to("meta"), n_modes=3)


# ---------------------------------------------------------------------------
# (d) the slice end to end
# ---------------------------------------------------------------------------


def _jax_quant_run(key, requant):
    return functools.partial(_jax_fast, _jax_stacks(key, requant))


def _jax_u8(run, imgs):
    """JAX `NetEvaluator.upscale_batch`'s rounding of a forward."""
    x = jnp.asarray(imgs.astype(np.float32).transpose(0, 3, 1, 2) / 255.0)
    out = np.asarray(run(x)).transpose(0, 2, 3, 1)
    return np.round(np.clip(out, 0, 255)).astype(np.uint8)


@pytest.mark.parametrize("quant", [True, "f32"])
@pytest.mark.parametrize("weights", ["nf16", "ftr2"])
def test_net_evaluator_quant_equals_jax(quant, weights, calibrate_once):
    """nf=16 depth 2 on 2x24x32x3, the shipped nf=128 `_ftr2` weights on
    a 1x24x32x3 crop (measured: 100% and 99.995% of bytes equal, max
    |diff| 1).  One flipped stage-1 tie moves up to ~50 output bytes, so
    the images are large enough that the equal share means something."""
    key, shape = (("ftr2", (1, 24, 32, 3)) if weights == "ftr2" else
                  (NF16, (2, 24, 32, 3)))
    requant = "int" if quant is True else quant
    imgs = np.random.default_rng(11).integers(0, 256, shape).astype(np.uint8)
    port = NetEvaluator(_weights(key), quant=quant, device="cpu", **CFG)
    got = port.upscale_batch(imgs)
    assert got.dtype == np.uint8
    assert got.shape == (shape[0], shape[1] * 4, shape[2] * 4, 3)
    _close(got, _jax_u8(_jax_quant_run(key, requant), imgs))
    assert not any(tuk.LAUNCHES.values())


def test_net_evaluator_quant_yuv_equals_jax(calibrate_once):
    """The fused YUV pipeline with quantized stacks: JAX's evaluator as a
    TPU configures it for quant (no packed luma runner, evaluate.py:524),
    the Pallas kernels in interpret mode."""
    p = _params(*NF16)
    jax_ev = JaxNetEvaluator(p, **CFG)
    run = _jax_quant_run(NF16, "int")
    jax_ev._run = run
    jax_ev._run_tiled = lambda x, axis=2: run(x)
    port = NetEvaluator(p, quant=True, device="cpu", **CFG)
    assert port._luma_clip is None
    imgs = np.random.default_rng(12).integers(0, 256, (2, 9, 11, 3)).astype(
        np.uint8)
    got = port.upscale_yuv_batch(imgs)
    _close(got, jax_ev.upscale_yuv_batch(imgs))
    np.testing.assert_array_equal(port.upscale_yuv(imgs[1]), got[1])
    np.testing.assert_array_equal(port.upscale(imgs[0]),
                                  port.upscale_batch(imgs)[0])


# ---------------------------------------------------------------------------
# (e) gating
# ---------------------------------------------------------------------------


def test_quant_gating(monkeypatch, calibrate_once):
    p = _params(*NF16)
    ev = NetEvaluator(p, quant="f32w6", fast=False, device="cpu", **CFG)
    assert ev.fast and all("hwqt" in st and "hcq" in st for st in ev.stacked)
    with pytest.raises(ValueError, match="unknown requant form"):
        NetEvaluator(p, quant="int4", device="cpu", **CFG)
    with pytest.raises(ValueError, match="unknown requant form"):
        tq.quantize_srnets_for_fast(p, requant="i8", **CFG)
    dense = tsn.init_srnets(np.random.default_rng(14), nf=8, arch="dense",
                            **CFG)
    with pytest.raises(ValueError, match="plain-unit stack"):
        NetEvaluator(dense, quant=True, device="cpu", **CFG)
    st = tuk.stack_stage_params(params_from_numpy(dense, "cpu"), stage=1,
                                modes="sdy", upscale=1)
    with pytest.raises(ValueError, match="plain-unit stack"):
        tq.quantize_plain_stack(st, dense, stage=1, modes="sdy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NetEvaluator(p, quant=True, **CFG)


# ---------------------------------------------------------------------------
# the kernel's fragment dataflow (csrc/plain_w8a8.cu), modelled in NumPy:
# one warp's slice of its int8 wgmma, mma.sync m16n8k32's layouts
# ---------------------------------------------------------------------------


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3                   # group g, thread t


def _mma_m16n8k32(a, b0, b1):
    """One warp's `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` by
    the PTX fragment layouts.  a: (32, 4, 4) bytes of registers a0..a3
    per lane; b0, b1: (32, 4).  Returns (32, 4) int32 c0..c3."""
    g, t = _lanes()
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for reg in range(4):
        row = g + 8 * (reg & 1)                  # a0, a2: row g; a1, a3: g+8
        for i in range(4):
            A[row, 4 * t + i + 16 * (reg >> 1)] = a[:, reg, i]
    for i in range(4):
        B[4 * t + i, g] = b0[:, i]
        B[16 + 4 * t + i, g] = b1[:, i]
    C = A @ B
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], axis=1)


def _kernel_a_fragments(codes):
    """a[j] (32, 4, 4) as the kernel packs a (16, nf) code matrix in
    feature order: a[j][2h] (row g) and a[j][2h + 1] (row g + 8) hold
    features f, f+1, f+8, f+9 with f = 32j + 16h + 2t."""
    g, t = _lanes()
    frags = []
    for j in range(codes.shape[1] // 32):
        a = np.zeros((32, 4, 4), np.int64)
        for h in range(2):
            f = 32 * j + 16 * h + 2 * t
            for i, df in enumerate((0, 1, 8, 9)):
                a[:, 2 * h, i] = codes[g, f + df]
                a[:, 2 * h + 1, i] = codes[g + 8, f + df]
        frags.append(a)
    return frags


@pytest.mark.parametrize("nf", [32, 64])
def test_fragment_dataflow_gives_the_product(nf):
    """Two chained layers of one warp (16 sites): the A fragments built
    from the head codes, then from the previous layer's accumulator
    fragments by the kernel's repacking, times B fragments loaded from
    `kernel_stack`'s permuted input axis, give codes @ W."""
    rng = np.random.default_rng(nf)
    codes = rng.integers(0, 128, (16, nf))
    w = [rng.integers(-127, 128, (nf, nf)).astype(np.int8) for _ in range(2)]
    M = 1
    q = {"w1": torch.zeros((M, 4, nf), dtype=torch.bfloat16),
         "b1": torch.zeros((M, nf), dtype=torch.bfloat16),
         "hwq": torch.as_tensor(np.stack(w)[:, None]),        # (D, M, in, out)
         "w6q": torch.zeros((M, nf, 64), dtype=torch.int8),
         "c6": torch.zeros((M, 64)), "b6": torch.zeros((M, 64)),
         "hcq": torch.zeros((2, M, nf)), "hbq": torch.zeros((2, M, nf))}
    hwqt = tq.kernel_stack(q)["hwqt"].numpy().astype(np.int64)  # [out][in']
    g, t = _lanes()
    a = _kernel_a_fragments(codes)
    x = codes
    for d in range(2):
        c = []
        for nt in range(nf // 8):
            acc = np.zeros((32, 4), np.int64)
            for j, aj in enumerate(a):
                rows = hwqt[d, 0, nt * 8 + g]                # (32, nf)
                k = 32 * j + 4 * t
                b0 = np.stack([rows[np.arange(32), k + i]
                               for i in range(4)], 1)
                b1 = np.stack([rows[np.arange(32), k + 16 + i]
                               for i in range(4)], 1)
                acc += _mma_m16n8k32(aj, b0, b1)
            c.append(acc)
        want = x @ w[d].astype(np.int64)                      # (16, nf)
        for nt in range(nf // 8):
            cols = nt * 8 + 2 * t
            np.testing.assert_array_equal(c[nt][:, 0], want[g, cols])
            np.testing.assert_array_equal(c[nt][:, 1], want[g, cols + 1])
            np.testing.assert_array_equal(c[nt][:, 2], want[g + 8, cols])
            np.testing.assert_array_equal(c[nt][:, 3], want[g + 8, cols + 1])
        # requant stand-in (any per-column map) and the kernel's repacking:
        # tile n0 = 4j + 2h -> bytes 0, 1; tile n0 + 1 -> bytes 2, 3
        y = np.clip(want // 997, 0, 127)
        a = []
        for j in range(nf // 32):
            aj = np.zeros((32, 4, 4), np.int64)
            for h in range(2):
                n0 = 4 * j + 2 * h
                for reg, (r0, r1) in ((2 * h, (0, 1)), (2 * h + 1, (2, 3))):
                    vals = [c[n0][:, r0], c[n0][:, r1], c[n0 + 1][:, r0],
                            c[n0 + 1][:, r1]]
                    for i, v in enumerate(vals):
                        aj[:, reg, i] = np.clip(v // 997, 0, 127)
            a.append(aj)
        np.testing.assert_array_equal(
            np.concatenate([f for f in _kernel_a_fragments(y)]),
            np.concatenate(a))
        x = y


def parity_report(shape=(1, 3, 48, 64), seed=0):
    """Flip rates of the port's W8A8 path (torch, CPU) against the JAX
    package's (CPU, Pallas in interpret mode) on the shipped `_ftr2`
    weights, per requant form: K11's raw accumulators per stage from the
    same tap matrix, and uint8 bytes end to end."""
    params = _artifact()
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[2], 0:shape[3]]
    images = {
        "noise": rng.integers(0, 256, shape),
        "smooth": np.stack([128 + 100 * np.sin(yy / 5 + c) * np.cos(xx / 7)
                            for c in range(shape[1])])[None],
    }
    for requant in FORMS:
        jst = _jax_stacks("ftr2", requant)
        tst = _port_stacks("ftr2", requant)
        port = NetEvaluator(params, quant=requant, device="cpu", **CFG)
        for name, img in images.items():
            x = img.astype(np.float32) / 255.0
            for s in range(2):
                xb = jnp.asarray(x).astype(jnp.bfloat16)
                taps_j = jsn._ensemble_taps(xb, "sdy")
                taps_t = tsn._ensemble_taps(
                    torch.as_tensor(np.array(xb.astype(jnp.float32))).to(
                        torch.bfloat16), "sdy")
                want = np.asarray(_jax_stage(jst[s], taps_j))
                got = tuk.stage_ensemble_apply(tst[s], taps_t, n_modes=3,
                                               v=1 if s == 0 else 16).numpy()
                rows = 1 if s == 0 else 16
                d = np.abs(got[:, :rows] - want[:, :rows])
                print(f"{requant} {name} stage {s + 1} acc: "
                      f"{(d > 0).mean():.3e} of {d.size} entries differ, "
                      f"max |diff| {d.max():g}")
                x = np.asarray(jax.jit(lambda a: jnp.clip(jnp.round(
                    a[:, 0] / 12 + 127.0), 0, 255) / 255.0)(want)).reshape(
                        x.shape)
            u8 = img.astype(np.uint8).transpose(0, 2, 3, 1)
            d = np.abs(port.upscale_batch(u8).astype(int)
                       - _jax_u8(_jax_quant_run("ftr2", requant), u8))
            print(f"{requant} {name} end to end: {(d == 0).mean():.5%} of "
                  f"bytes equal, max |diff| {d.max()}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_quant.py  (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    parity_report()
