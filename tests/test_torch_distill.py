"""The port's distillation (`mulut_tpu_torch.pipelines.distill`) against the
JAX package's (`mulut_tpu.pipelines.distill`) on the CPU.

JAX's PRNG streams cannot be reproduced in torch, so the draws on the
device (the students' init, `sample_taps`) are held to their contract
and the arithmetic to JAX's on the same NumPy-made inputs and initial
parameters.  Tolerances:

- `transfer_lattice` at intervals 3-6: byte-equal.
- `sample_taps`: the contract (shape, domain, the three blocks' sizes,
  the lattice block made of lattice rows, the correlated block's coin).
- One distillation step (`distill_loss` / `make_distill_step`, a plain
  nf=16 student on a dense nf=8 x2 teacher, 2,048 taps) against the
  same body composed from JAX's `apply_mulut_unit`, `jax.value_and_grad`
  and `optax.adam(optax.cosine_decay_schedule(...))` (the step inside
  `distill_unit` is a closure): the loss within relative 1e-5, each
  gradient within 1e-5 of its largest magnitude (measured 2.4e-7); after
  6 steps each parameter within 1e-5 of its largest magnitude (measured
  2.9e-7), each step's loss within relative 1e-5.  Adam's first
  update is about lr times the sign of the gradient, so the gradients
  are gated before it.
- `distill_finetune_cascade`: 3 iterations on the same initial students
  and teacher, noise and an extra image (the same host draws: the same
  crops): each loss within relative 1e-5 of JAX's, the students after
  them within 1e-5 of each tensor's largest magnitude (measured over
  three seeds of the initial params: losses up to 2.3e-6, students up to
  1.2e-6).
- `cosine_lr(lr0, lr1, iters)` is `optax.cosine_decay_schedule(lr0,
  iters, alpha=lr1 / lr0)` (the schedule `distill_unit` takes) within
  1e-6 of lr0 (optax sums terms of lr0's size in float32; measured
  1.3e-8).
- `distill_unit` and `distill_srnets`: the contract of
  tests/test_distill.py (keys, head shapes, the plain layout, per-stage
  depths, the metrics), the lattice metrics recomputed through JAX's
  unit within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulut_tpu.models import blocks as jb
from mulut_tpu.models import srnet as jsn
from mulut_tpu.pipelines import distill as jd
from mulut_tpu_torch.models import blocks as tb
from mulut_tpu_torch.models import srnet as tsn
from mulut_tpu_torch.models.torch_import import params_from_numpy
from mulut_tpu_torch.pipelines import distill as td
from mulut_tpu_torch.pipelines.train import make_optimizer

LR0, LR1, ITERS = 2e-3, 1e-5, 10


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


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("interval", [3, 4, 5, 6])
def test_transfer_lattice_byte_equal(interval):
    got = td.transfer_lattice(interval)
    want = jd.transfer_lattice(interval)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((2 ** (8 - interval) + 1) ** 4, 4)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("with_lattice", [True, False])
def test_sample_taps_contract(with_lattice):
    n = 4099
    lat = torch.as_tensor(td.transfer_lattice(6))
    gen = torch.Generator().manual_seed(0)
    x = td.sample_taps(gen, n, lattice=lat if with_lattice else None)
    again = td.sample_taps(torch.Generator().manual_seed(0), n,
                           lattice=lat if with_lattice else None)
    assert torch.equal(x, again)
    assert x.shape == (n, 4) and x.dtype == torch.float32
    assert x.device == gen.device
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    x = x.numpy()
    n_uni, n_nat = n // 4, n // 2
    uni, nat, rest = x[:n_uni], x[n_uni: n_uni + n_nat], x[n_uni + n_nat:]
    assert len(rest) == n - n_uni - n_nat
    rows = {r.tobytes() for r in lat.numpy()}
    on_lattice = np.array([r.tobytes() in rows for r in rest])
    assert on_lattice.all() if with_lattice else not on_lattice.any()
    assert not any(r.tobytes() in rows for r in uni)
    # the correlated block: a fair coin between spreads 0.03 and 0.15 (4
    # draws of spread 0.03 span < 0.15 but for ~1e-5 of rows; of 0.15,
    # ~10% of rows); the uniform block spans more
    tight = float(np.mean(np.ptp(nat, axis=1) < 0.15))
    assert 0.45 < tight < 0.65, tight
    assert float(np.mean(np.ptp(uni, axis=1) < 0.15)) < 0.05


@pytest.fixture(scope="module")
def step_case():
    teacher = tb.init_mulut_unit(np.random.default_rng(0), nf=8, upscale=2)
    student = tb.init_mulut_unit(np.random.default_rng(1), nf=16,
                                 upscale=2, dense=False, depth=2)
    gen = torch.Generator().manual_seed(0)
    lat = torch.as_tensor(td.transfer_lattice(6))
    xs = [td.sample_taps(gen, 2048, lattice=lat).numpy() for _ in range(6)]
    jt = _jax(teacher)
    opt = optax.adam(optax.cosine_decay_schedule(LR0, ITERS,
                                                 alpha=LR1 / LR0))

    @jax.jit
    def value_and_grad(p, x):
        y = jb.apply_mulut_unit(jt, x)
        return jax.value_and_grad(
            lambda q: jnp.mean((jb.apply_mulut_unit(q, x) - y) ** 2))(p)

    @jax.jit
    def update(p, st, g):
        u, st = opt.update(g, st)
        return optax.apply_updates(p, u), st

    jp, st = _jax(student), opt.init(_jax(student))
    out = []
    for x in xs:
        loss, g = value_and_grad(jp, x)
        out.append((float(loss), jax.tree_util.tree_map(np.asarray, g)))
        jp, st = update(jp, st, g)
    return dict(teacher=teacher, student=student, xs=xs, steps=out,
                final=jax.tree_util.tree_map(np.asarray, jp))


def test_distill_loss_and_gradients(step_case):
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in step_case["student"].items()}
    tt = params_from_numpy({"u": step_case["teacher"]}, "cpu")["u"]
    loss = td.distill_loss(tp, tt, torch.as_tensor(step_case["xs"][0]))
    loss.backward()
    want_loss, want_grads = step_case["steps"][0]
    assert abs(loss.item() - want_loss) <= 1e-5 * want_loss
    assert all(t.grad is None for t in tt.values())
    for k, want in want_grads.items():
        assert _rel(tp[k].grad.numpy(), want) <= 1e-5, k


def test_distill_steps_follow_optax(step_case):
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in step_case["student"].items()}
    tt = params_from_numpy({"u": step_case["teacher"]}, "cpu")["u"]
    step = td.make_distill_step(
        make_optimizer([tp[k] for k in sorted(tp)], LR0, LR1, ITERS), tt)
    for x, (want, _) in zip(step_case["xs"], step_case["steps"]):
        got = float(step(tp, torch.as_tensor(x)))
        assert abs(got - want) <= 1e-5 * want
    for k, want in step_case["final"].items():
        assert _rel(tp[k].detach().numpy(), want) <= 1e-5, k


def test_cosine_lr_is_optax_cosine_decay():
    sched = optax.cosine_decay_schedule(LR0, 400, alpha=LR1 / LR0)
    from mulut_tpu_torch.pipelines.train import cosine_lr

    got = cosine_lr(LR0, LR1, 400)
    for k in (0, 1, 137, 200, 399):
        # optax sums terms of lr0's size in float32
        assert abs(got(k) - float(sched(k))) <= 1e-6 * LR0, k


def test_distill_unit_contract():
    teacher = tb.init_mulut_unit(np.random.default_rng(1), nf=8, upscale=2)
    kw = dict(nf=16, depth=2, upscale=2, iters=12, batch=512, lr0=5e-3,
              interval=6, device="cpu")
    student, metrics = td.distill_unit(np.random.default_rng(2), teacher,
                                       **kw)
    again, _ = td.distill_unit(np.random.default_rng(2), teacher, **kw)
    assert all(np.array_equal(student[k], again[k]) for k in student)
    assert sorted(student) == ["b1", "b2", "b3", "b6", "w1", "w2", "w3",
                               "w6"]
    assert student["w6"].shape == (16, 4)
    assert all(v.dtype == np.float32 for v in student.values())
    assert sorted(metrics) == ["final_batch_mse", "lattice_max_abs",
                               "lattice_max_levels", "lattice_mse"]
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["lattice_max_levels"] == metrics["lattice_max_abs"] * 127
    # the lattice metrics, through JAX's unit on the same lattice
    lat = jd.transfer_lattice(6)
    err = np.asarray(jax.jit(jb.apply_mulut_unit)(_jax(student), lat)
                     - jax.jit(jb.apply_mulut_unit)(_jax(teacher), lat))
    assert abs(float(np.mean(err ** 2)) - metrics["lattice_mse"]) <= \
        1e-5 * metrics["lattice_mse"]
    assert abs(float(np.abs(err).max()) - metrics["lattice_max_abs"]) <= \
        1e-5 * metrics["lattice_max_abs"]
    # the student moved toward the teacher
    init = tb.init_mulut_unit(np.random.default_rng(2), nf=16, upscale=2,
                              dense=False, depth=2)
    err0 = np.asarray(jax.jit(jb.apply_mulut_unit)(_jax(init), lat)
                      - jax.jit(jb.apply_mulut_unit)(_jax(teacher), lat))
    assert metrics["lattice_mse"] < float(np.mean(err0 ** 2))
    with pytest.raises(ValueError):
        td.distill_unit(np.random.default_rng(2), teacher,
                        **dict(kw, upscale=4))


def test_distill_finetune_cascade_matches_jax():
    cfg = dict(modes="sd", stages=2, scale=2)
    dense = tsn.init_srnets(np.random.default_rng(0), nf=8, **cfg)
    students = tsn.init_srnets(np.random.default_rng(1), nf=16, arch="mxu",
                               **cfg)
    extra = [np.random.default_rng(2).integers(0, 256, (20, 22, 3)).astype(
        np.uint8), np.zeros((10, 30, 3), np.uint8)]     # the second: too small
    kw = dict(iters=3, batch=2, crop=16, seed=5, sigma=10.0,
              extra_images=extra, extra_weight=0.5, **cfg)
    want_p, want = jd.distill_finetune_cascade(_jax(students), _jax(dense),
                                               **kw)
    got_p, got = td.distill_finetune_cascade(students, dense, device="cpu",
                                             **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * w, (got, want)
    for u, unit in want_p.items():
        for n, w in unit.items():
            assert _rel(got_p[u][n], np.asarray(w)) <= 1e-5, (u, n)


def test_distill_srnets_contract():
    dense = tsn.init_srnets(np.random.default_rng(0), nf=8, scale=2,
                            modes="sd", stages=2)
    students, metrics = td.distill_srnets(
        dense, modes="sd", stages=2, scale=2, nf=16, depth=(2, 3), iters=3,
        batch=256, interval=6, device="cpu")
    assert set(students) == set(metrics) == {"s1_s", "s1_d", "s2_s", "s2_d"}
    assert students["s1_s"]["w6"].shape == (16, 1)
    assert students["s2_s"]["w6"].shape == (16, 4)
    assert "w4" in students["s2_d"] and "w4" not in students["s1_d"]
    assert tb.unit_layout(students["s2_s"])[0] is False
    assert jb.unit_layout(_jax(students["s2_s"]))[0] is False
    assert all("lattice_mse" in m for m in metrics.values())
    # the same layout as JAX's students of the same call
    jst = jsn.init_srnets(jax.random.PRNGKey(0), nf=16, scale=2, modes="sd",
                          stages=2, arch="mxu", depth=(2, 3))
    for k, unit in students.items():
        assert {n: v.shape for n, v in unit.items()} == \
            {n: v.shape for n, v in jst[k].items()}
