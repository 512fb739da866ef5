"""The port's multi-device paths against the JAX package's meshed ones.

JAX runs on the 8 virtual CPU devices that tests/conftest.py makes; the
port on meshes of CPU shards (`make_mesh(n, ["cpu"] * n)`): each entry a
shard of its own, with its own copy of what is replicated.  Tolerances:
LUT paths byte-equal to JAX and to the port's unsharded path; net mode
byte-equal to the port's unsharded path and, against JAX, within the
net-mode parity rule (at least 99.9% of bytes equal, none off by more
than 2; float32 sums and tanh differ in the last bits between XLA and
torch); a data-parallel step within 1e-6 of JAX's meshed step and of the
port's one-device step (the JAX package's tests/test_parallel.py), its
gradients within GRAD_REL of one device's.
"""

import functools
import importlib
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulut_tpu.models import srnet as jsn
from mulut_tpu.ops import ensemble as jens
from mulut_tpu.parallel import mesh as jmesh
from mulut_tpu.parallel import spatial as jsp
from mulut_tpu.pipelines import evaluate as jev
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.ops import ensemble as tens
from mulut_tpu_torch.parallel import mesh as tmesh
from mulut_tpu_torch.parallel import spatial as tsp
from mulut_tpu_torch.pipelines import evaluate as tev

jtr = importlib.import_module("mulut_tpu.pipelines.train")
jft = importlib.import_module("mulut_tpu.pipelines.finetune")
ttr = importlib.import_module("mulut_tpu_torch.pipelines.train")
tft = importlib.import_module("mulut_tpu_torch.pipelines.finetune")
REPO = Path(__file__).resolve().parents[1]
#: a data-parallel step's gradients against one device's, relative to each
#: tensor's max (float32 sums in another order; read here 3.2e-07 for the
#: train step, 4.5e-08 for the fine-tune step; a wrong shard weight or a
#: lost shard is off by O(1))
GRAD_REL = 1e-5


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
def jmesh8():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


def _cpu_mesh(n):
    return tmesh.make_mesh(n, ["cpu"] * n)


def _u8(x):
    return np.round(np.clip(np.asarray(x, np.float32), 0, 255)).astype(
        np.uint8)


def _parity(got, want, *, frac=1e-3, max_abs=2):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    assert (d > 0).mean() <= frac and d.max() <= max_abs, (
        (d > 0).mean(), d.max())


def test_mesh_helpers():
    """make_mesh, mesh_for, shard_batch, replicate_tree, tree_to,
    pad_batch and shard_image_rows on CPU shards."""
    mesh = _cpu_mesh(8)
    assert mesh == [torch.device("cpu")] * 8
    assert tmesh.make_mesh(3, mesh) == mesh[:3]
    assert tmesh.mesh_for("cpu", 4, "test") == [torch.device("cpu")] * 4
    # a list means all of it; a count that names another is refused
    assert tmesh.mesh_for(mesh, None, "test") == mesh
    assert tmesh.mesh_for(mesh, 8, "test") == mesh
    for n in (1, 4, 20):
        with pytest.raises(ValueError, match="mesh of 8"):
            tmesh.mesh_for(mesh, n, "test")
    assert tmesh.mesh_for("cpu", None, "test") == [torch.device("cpu")]
    a = np.arange(8 * 3).reshape(8, 3)
    b = torch.arange(8)
    shards = tmesh.shard_batch(mesh, a, b)
    assert len(shards) == 8
    for d, (sa, sb) in enumerate(shards):
        np.testing.assert_array_equal(sa.numpy(), a[d:d + 1])
        assert sb.tolist() == [d]
    odd = tmesh.shard_batch(mesh[:3], np.arange(7))
    assert [s.tolist() for s in odd] == [[0, 1, 2], [3, 4], [5, 6]]
    tree = {"u": {"w": torch.ones(2, requires_grad=True)},
            "t": [np.zeros(3, np.int8)]}
    reps = tmesh.replicate_tree(mesh, tree)
    assert len(reps) == 8
    ptrs = {r["u"]["w"].data_ptr() for r in reps}
    assert len(ptrs) == 8                   # one copy per shard
    assert all(r["u"]["w"].requires_grad for r in reps)
    assert reps[3]["t"][0].dtype == torch.int8
    assert [t.shape for t in tmesh.tree_leaves(reps[0])] == [(3,), (2,)]
    padded = tmesh.pad_batch(np.arange(5), 8)
    assert padded.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    bands = tsp.shard_image_rows(mesh[:4], np.arange(10)[:, None])
    assert [b[:, 0].tolist() for b in bands] == [[0, 1, 2], [3, 4, 5],
                                                 [6, 7, 8], [7, 8, 9]]
    same = tmesh.tree_to(tree["u"], "cpu")
    assert same["w"] is tree["u"]["w"]      # already there: no copy


@functools.cache
def _luts(interval: int = 4, scale: int = 2) -> dict:
    rng = np.random.default_rng(0)
    L = 2 ** (8 - interval) + 1
    return {f"s{s}_{m}": rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
            for s, v in ((1, 1), (2, scale * scale)) for m in "sdy"}


@pytest.mark.parametrize("h", [16, 19])
def test_cascade_row_sharded(jmesh8, h):
    """Row-sharded cascade at an even and an uneven H over 8 shards, on
    raw int32 tables and on expanded ones (`lut_cascade_int` per slab)
    at x2, and at x4 on the packed path's formats (`lut_cascade_packed`
    per slab), against JAX's meshed `cascade_row_sharded` (expanded; the
    JAX package's tests hold its raw and expanded forms to the same
    bytes) and against the port's unsharded cascade."""
    from mulut_tpu_torch.ops import tail_kernel as ttk

    img = np.random.default_rng(h).integers(0, 256, (3, h, 10))
    timg = torch.as_tensor(img)
    mesh = _cpu_mesh(8)
    for scale in (2, 4):
        luts = _luts(6, scale)
        cfg = dict(stages=2, modes="sdy", scale=scale, interval=6)
        want = np.asarray(jsp.cascade_row_sharded(
            jmesh8, jens.prepare_expanded_luts(luts, interval=6),
            jnp.asarray(img, jnp.int32), expanded=True, **cfg))
        if scale == 4:
            tt = tens.prepare_expanded_luts(luts, interval=6, device="cpu",
                                            **tens.KERNEL_FORMATS)
            routes = [(tt, True, ttk.lut_cascade_u8(tt, timg, **cfg))]
            # the packed route refuses the default (per-rotation) formats
            other = tens.prepare_expanded_luts(luts, interval=6,
                                               device="cpu")
            with pytest.raises(ValueError, match="per-rotation"):
                tsp.cascade_row_sharded(mesh, other, timg, expanded=True,
                                        **cfg)
        else:
            raw = {k: torch.as_tensor(v, dtype=torch.int32)
                   for k, v in luts.items()}
            tt = tens.prepare_expanded_luts(luts, interval=6, device="cpu")
            routes = [(t, e, tens.lut_cascade_int(t, timg, expanded=e, **cfg))
                      for t, e in ((raw, False), (tt, True))]
        for tabs, expanded, single in routes:
            got = tsp.cascade_row_sharded(mesh, tabs, timg,
                                          expanded=expanded, **cfg)
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"x{scale} {expanded}")
            np.testing.assert_array_equal(got.numpy(), single.numpy())


@functools.cache
def _net_params(nf: int, seed: int, scale: int = 4, modes: str = "sdy"):
    p = jsn.init_srnets(jax.random.PRNGKey(seed), nf=nf, scale=scale,
                        modes=modes, stages=2, arch="mxu")
    return jax.tree_util.tree_map(np.asarray, p)


def test_net_row_sharded_uneven(jmesh8):
    """H=37 over 8 shards (band 5, the last overlapping): the float32
    forward and the fast forward (K3's plain version) within the parity
    rule of JAX's unsharded forwards (`srnets_predict`, and
    `srnets_predict_fast` with Pallas in interpret mode), which
    tests/test_parallel.py holds byte-equal to JAX's meshed
    `net_row_sharded` (whose float32 form takes ~30 s to compile on the
    CPU), and byte-equal to the port's unsharded forward."""
    cfg = dict(modes="sdy", stages=2, scale=4)
    params = _net_params(16, 5)
    x = np.random.default_rng(5).random((1, 1, 37, 12)).astype(np.float32)
    tp = params_from_numpy(params, "cpu")
    xt = torch.as_tensor(x)
    mesh = _cpu_mesh(8)
    want = np.asarray(jax.jit(lambda a: jsn.srnets_predict(
        params, a, phase="valid", **cfg))(jnp.asarray(x)))
    got = tsp.net_row_sharded(mesh, tp, xt, **cfg)
    assert got.shape == want.shape
    _parity(_u8(got), _u8(want))
    np.testing.assert_array_equal(
        got.numpy(), tsn.srnets_predict(tp, xt, **cfg).numpy())

    jst = jsn.stack_srnets_for_fast(params, **cfg)
    want_f = np.asarray(jax.jit(lambda a: jsn.srnets_predict_fast(
        jst, a, interpret=True, **cfg))(jnp.asarray(x)))
    tst = tsn.stack_srnets_for_fast(tp, **cfg)
    got_f = tsp.net_row_sharded(mesh, tp, xt, fast_stacked=tst, **cfg)
    _parity(_u8(got_f), _u8(want_f))
    np.testing.assert_array_equal(
        got_f.numpy(), tsn.srnets_predict_fast(tst, xt, **cfg).numpy())
    with pytest.raises(ValueError, match="halo"):
        tsp.net_row_sharded(mesh, tp, xt[:, :, :9], **cfg)


def test_lut_evaluator_sharded():
    """`LutEvaluator(n_devices=4, bucket=16)` over mixed sizes (a group
    that is not a device multiple): JAX's sharded evaluator's bytes and
    the port's one-device ones."""
    luts = _luts(6, 4)
    cfg = dict(stages=2, modes="sdy", scale=4, interval=6, bucket=16)
    rng = np.random.default_rng(9)
    sizes = [(13, 18), (16, 32), (9, 25), (16, 18), (5, 7), (12, 12)]
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8) for hw in sizes]
    port4 = tev.LutEvaluator(luts, n_devices=4, device="cpu", **cfg)
    assert port4.n_devices == 4 and len(port4._replicas) == 4
    want = jev.LutEvaluator(luts, n_devices=4, **cfg).upscale_many(imgs)
    one = tev.LutEvaluator(luts, device="cpu", **cfg).upscale_many(imgs)
    for g, w, o, hw in zip(port4.upscale_many(imgs), want, one, sizes):
        np.testing.assert_array_equal(g, w, err_msg=str(hw))
        np.testing.assert_array_equal(g, o, err_msg=str(hw))


def test_net_evaluator_sharded(jmesh8):
    """`NetEvaluator(n_devices=8)` at B=5 (padded with replicas): RGB and
    YUV byte-equal to one device, and within the parity rule of JAX's
    sharded evaluator; the fast route too, against one device."""
    params = _net_params(8, 11, scale=2, modes="s")
    cfg = dict(stages=2, modes="s", scale=2)
    imgs = np.random.default_rng(11).integers(0, 256, (5, 12, 14, 3),
                                              dtype=np.uint8)
    jax8 = jev.NetEvaluator(params, n_devices=8, **cfg)
    assert jax8.mesh is not None
    for fast in (False, True):
        one = tev.NetEvaluator(params, fast=fast, device="cpu", **cfg)
        eight = tev.NetEvaluator(params, fast=fast, n_devices=8,
                                 device="cpu", **cfg)
        assert eight.n_devices == 8
        rgb, yuv = eight.upscale_batch(imgs), eight.upscale_yuv_batch(imgs)
        assert rgb.shape == (5, 24, 28, 3)
        np.testing.assert_array_equal(rgb, one.upscale_batch(imgs))
        np.testing.assert_array_equal(yuv, one.upscale_yuv_batch(imgs))
        if not fast:
            _parity(rgb, jax8.upscale_batch(imgs))
            _parity(yuv, jax8.upscale_yuv_batch(imgs))


def _jax_step_pair(jstep, jopt, params, im, lb, mesh):
    one = jstep(params, jopt.init(params), jnp.asarray(im), jnp.asarray(lb))
    im_s, lb_s = jmesh.shard_batch(mesh, im, lb)
    many = jstep(jmesh.replicate_tree(mesh, params),
                 jmesh.replicate_tree(mesh, jopt.init(params)), im_s, lb_s)
    return one, many


def _port_steps(make_step, tree, im, lb):
    """The port's step on one CPU device and data-parallel over 8 CPU
    shards, from copies of `tree`: [(loss, leaves, grads)] for both."""
    out = []
    for mesh in (None, _cpu_mesh(8)):
        reps = tmesh.replicate_tree(mesh or ["cpu"], tree)
        leaves = tmesh.tree_leaves(reps[0])
        step = make_step(ttr.make_optimizer(leaves, 1e-3, 1e-4, 10), mesh)
        loss = step(reps if mesh else reps[0], torch.as_tensor(im),
                    torch.as_tensor(lb))
        out.append((float(loss), [t.detach().numpy() for t in leaves],
                    [t.grad.numpy() for t in leaves]))
    return out


def _grads_close(got, want, rel):
    """Each gradient within `rel` of its one-device twin's max."""
    for a, b in zip(got, want, strict=True):
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (
            np.abs(a - b).max() / np.abs(b).max())


def test_dp_train_step(jmesh8):
    """Data-parallel train step over 8 shards against JAX's meshed step
    and the port's one-device step (tests/test_parallel.py's sizes)."""

    cfg = dict(modes="s", stages=1, scale=2)
    params = jax.tree_util.tree_map(np.asarray, jsn.init_srnets(
        jax.random.PRNGKey(0), nf=4, **cfg))
    rng = np.random.default_rng(0)
    im = rng.random((8, 1, 6, 6), dtype=np.float32)
    lb = rng.random((8, 1, 12, 12), dtype=np.float32)
    jopt = jtr.make_optimizer(1e-3, 1e-4, 10)
    (_, _, jl1), (jp8, _, jl8) = _jax_step_pair(
        jtr.make_train_step(jopt, **cfg), jopt, params, im, lb, jmesh8)
    tree = ttr.trainable(params, "cpu")
    (l1, p1, g1), (l8, p8, g8) = _port_steps(
        lambda o, m: ttr.make_train_step(o, mesh=m, **cfg), tree, im, lb)
    want = [np.asarray(jp8[u][n]) for u in sorted(jp8)
            for n in sorted(jp8[u])]
    assert abs(l8 - float(jl8)) <= 1e-6 and abs(l8 - l1) <= 1e-6
    assert abs(float(jl1) - float(jl8)) <= 1e-6
    for a, b, c in zip(p8, want, p1):
        np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(a, c, atol=1e-6)
    _grads_close(g8, g1, GRAD_REL)


def test_dp_finetune_step(jmesh8):
    """Data-parallel LUT fine-tune step over 8 shards against JAX's meshed
    step and the port's one-device step."""

    cfg = dict(modes="s", stages=1, upscale=2, interval=4)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((17 ** 4, 4)).astype(np.float32) * 0.3
    im = rng.integers(0, 256, (8, 1, 6, 6)).astype(np.float32)
    lb = rng.integers(0, 256, (8, 1, 12, 12)).astype(np.float32)
    jopt = jtr.make_optimizer(1e-3, 1e-4, 10)
    (_, _, jl1), (jw8, _, jl8) = _jax_step_pair(
        jft.make_finetune_step(jopt, **cfg), jopt, {"s1_s": jnp.asarray(w)},
        im, lb, jmesh8)
    tree = {"s1_s": torch.tensor(w, requires_grad=True)}
    (l1, p1, g1), (l8, p8, g8) = _port_steps(
        lambda o, m: tft.make_finetune_step(o, mesh=m, **cfg), tree, im, lb)
    assert abs(l8 - float(jl8)) <= 1e-6 and abs(l8 - l1) <= 1e-6
    np.testing.assert_allclose(p8[0], np.asarray(jw8["s1_s"]), atol=1e-6)
    np.testing.assert_allclose(p8[0], p1[0], atol=1e-6)
    _grads_close(g8, g1, GRAD_REL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dp_finetune_split_in_float64(dtype):
    """What moves a data-parallel fine-tune gradient off one device's is
    the order of the float32 sums, not the split: with every value in
    float64 (tables, pixels, loss) `data_parallel_grads` over 8 shards
    gives one device's loss and gradients to 1e-12 of their max, on a
    2-stage x4 cascade whose stage-2 tables sum over every site; in
    float32 they stay within GRAD_REL."""
    from mulut_tpu_torch.models.lut_model import lut_model_forward

    cfg = dict(modes="sdy", stages=2, upscale=4, interval=6)
    rng = np.random.default_rng(2)
    tree = {f"s{s}_{m}": torch.tensor(
        rng.standard_normal((5 ** 4, v)) * 0.3, dtype=dtype,
        requires_grad=True) for s, v in ((1, 1), (2, 16)) for m in "sdy"}
    im = torch.as_tensor(rng.integers(0, 256, (8, 1, 6, 6)))
    lb = torch.as_tensor(rng.integers(0, 256, (8, 1, 24, 24)))

    def loss_fn(w, im, lb):
        pred = lut_model_forward(w, im.to(dtype) / 255.0, device="cpu",
                                 **cfg)
        return torch.mean((pred - lb.to(dtype) / 255.0) ** 2)

    out = []
    for n in (1, 8):
        mesh = _cpu_mesh(n)
        reps = tmesh.replicate_tree(mesh, tree)
        loss = tmesh.data_parallel_grads(mesh, reps, loss_fn, im, lb)
        out.append((float(loss), [t.grad.numpy()
                                  for t in tmesh.tree_leaves(reps[0])]))
    (l1, g1), (l8, g8) = out
    rel = 1e-12 if dtype == torch.float64 else GRAD_REL
    assert abs(l8 - l1) <= rel * abs(l1)
    _grads_close(g8, g1, rel)


def test_train_and_finetune_take_gpunum(tmp_path):
    """`train(opt)` and `finetune(opt)` with gpuNum=2 on CPU shards: the
    same params, tables and loss log as gpuNum=1, to within 1e-6."""
    from mulut_tpu_torch.data import create_synthetic_dataset
    from mulut_tpu_torch.pipelines import transfer as ttf
    from mulut_tpu_torch.utils.lut_io import lut_filename, parse_stage_key

    pytest.importorskip("PIL")
    d = create_synthetic_dataset(str(tmp_path / "data"), n_train=4, size=32,
                                 scales=(4,))
    out = {}
    for n in (1, 2):
        exp = tmp_path / f"exp{n}"
        opt = types.SimpleNamespace(
            nf=4, arch="dense", unitDepth=0, modes="s", stages=1, scale=4,
            interval=6, batchSize=4, cropSize=8, trainDir=d["train_dir"],
            valDir=str(tmp_path / "none"), startIter=0, totalIter=2,
            lr0=1e-3, lr1=1e-4, weightDecay=0, displayStep=1,
            valStep=100, saveStep=100, workerNum=1, expDir=str(exp),
            valoutDir=str(exp / "val"), debug=False, trainPrecision="f32",
            gpuNum=n)
        exp.mkdir()
        params = ttr.train(opt, device="cpu")
        for key, arr in ttf.transfer_to_luts(
                params, modes="s", stages=1, interval=6,
                device="cpu").items():
            stage, mode = parse_stage_key(key)
            np.save(exp / lut_filename("LUT", 4, 6, stage, mode), arr)
        weights = tft.finetune(opt, device="cpu")
        out[n] = (tmesh.tree_leaves(params), tmesh.tree_leaves(weights))
    for a, b in zip(out[1][0] + out[1][1], out[2][0] + out[2][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_dryrun_multidevice():
    from mulut_tpu_torch.dryrun import dryrun_multidevice

    done = dryrun_multidevice(4, ["cpu"] * 4)
    assert len(done) == 8, done


def test_parallel_and_dryrun_import_no_jax():
    """`mulut_tpu_torch.parallel` and `mulut_tpu_torch.dryrun` import
    neither `jax` nor `mulut_tpu` (their import statements;
    tests/test_torch_copies.py imports every module of the port in a
    fresh process and checks sys.modules)."""
    files = [REPO / "mulut_tpu_torch" / "dryrun.py",
             *(REPO / "mulut_tpu_torch" / "parallel").glob("*.py")]
    assert len(files) == 4
    for f in files:
        for line in f.read_text().splitlines():
            words = line.strip().replace(",", " ").split()
            if words[:1] not in (["import"], ["from"]):
                continue
            assert not any(w.split(".")[0] in ("jax", "mulut_tpu")
                           for w in words[1:]), (f, line)
