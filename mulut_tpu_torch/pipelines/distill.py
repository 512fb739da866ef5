"""Checkpoint distillation: fit plain (mxu-arch) units to dense teacher
units.

Torch twin of `mulut_tpu.pipelines.distill`.  The unit contract is 4 taps
in, upscale**2 lanes out (ref: common/network.py:62-105), so a dense unit
defines its student's target function on the whole input domain [0, 1]^4.
`distill_unit` regresses a plain student on the teacher's outputs over
the step-2 transfer lattice (ref: sr/2_transfer_to_lut.py:12-42),
densified with uniform and correlated tap vectors drawn on the device;
`distill_finetune_cascade` then fits the whole student cascade onto the
teacher cascade's outputs on image crops.  This is how the plain weights
that net mode serves were made (`artifacts/README.md`).

Float32 with TF32 off, optax's Adam (`pipelines.train.OptaxAdam`) over
the cosine schedule.  Random draws: a `numpy.random.Generator` where the
JAX package takes a PRNG key (the students' init, and the seed of a
`torch.Generator` on the device for the tap batches); the crops of
`distill_finetune_cascade` come from the host `numpy.random.default_rng(
seed)` in the JAX package's call order, so both packages draw the same
crops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import _synth_image
from ..models.blocks import apply_mulut_unit, init_mulut_unit
from ..models.srnet import srnets_predict
from ..models.torch_import import params_from_numpy, params_to_numpy
from ..utils.device import resolve_device
from .train import loss_step, make_optimizer, param_leaves, trainable
from .transfer import lut_grid


def transfer_lattice(interval: int = 4) -> np.ndarray:
    """(L**4, 4) float32 lattice in [0, 1], the step-2 transfer grid:
    base = arange(0, 257, 2**interval) with base[-1] -= 1 (ref:
    sr/2_transfer_to_lut.py:13-15), all 4-tuples in lexicographic order,
    / 255 (a copy of `transfer.lut_grid`)."""
    return lut_grid(interval).copy()


def sample_taps(generator: torch.Generator, n: int, *,
                lattice: torch.Tensor | None = None) -> torch.Tensor:
    """(n, 4) float32 training inputs on the generator's device, in three
    blocks: n // 4 rows uniform over [0, 1]^4; n // 2 correlated rows, a
    uniform base plus Gaussian noise of spread 0.03 or 0.15 (a fair coin
    per row), clipped to [0, 1]; the rest random rows of `lattice` (the
    points step-2 caching will evaluate), or uniform without one."""
    kw = dict(generator=generator, device=generator.device)
    n_nat = n // 2
    n_uni = n // 4
    n_lat = n - n_nat - n_uni
    uni = torch.rand((n_uni, 4), **kw)
    base = torch.rand((n_nat, 1), **kw)
    spread = torch.where(torch.rand((n_nat, 1), **kw) < 0.5, 0.03, 0.15)
    nat = torch.clamp(base + spread * torch.randn((n_nat, 4), **kw), 0.0,
                      1.0)
    if lattice is None:
        lat = torch.rand((n_lat, 4), **kw)
    else:
        lat = lattice[torch.randint(0, lattice.shape[0], (n_lat,), **kw)]
    return torch.cat([uni, nat, lat])


def distill_loss(student: dict, teacher: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the student unit against the teacher unit on
    the (n, 4) taps `x`; the teacher runs without gradients."""
    with torch.no_grad():
        y = apply_mulut_unit(teacher, x)
    return torch.mean((apply_mulut_unit(student, x) - y) ** 2)


def make_distill_step(optimizer, teacher: dict):
    """One step of `distill_unit`, `step(student, x) -> loss`
    (`distill_loss`; `train.loss_step`)."""
    return loss_step(optimizer, lambda p, x: distill_loss(p, teacher, x))


def distill_unit(rng: np.random.Generator, teacher: dict, *, nf: int = 128,
                 depth: int = 2, upscale: int = 1, iters: int = 4000,
                 batch: int = 65536, lr0: float = 2e-3, lr1: float = 1e-5,
                 interval: int = 4, log_every: int = 0, device=None):
    """Fit one plain unit (`init_mulut_unit(rng, dense=False)`) to a dense
    teacher unit on `device` (None: the card): `iters` steps of
    `sample_taps` batches (from a `torch.Generator` seeded from `rng`),
    Adam over the cosine schedule from lr0 to lr1.

    Returns (student params as float32 NumPy arrays, metrics): the last
    batch's MSE, and the MSE and max |error| over the whole transfer
    lattice (the points step-2 caching evaluates), the latter also in
    int8 LUT levels (x127)."""
    out_dim = teacher["w6"].shape[1]
    if out_dim != upscale * upscale:
        raise ValueError(f"the teacher has {out_dim} output lanes; upscale "
                         f"{upscale} needs {upscale * upscale}")
    dev = resolve_device(device, "distill_unit")
    student = trainable({"u": init_mulut_unit(
        rng, nf=nf, upscale=upscale, dense=False, depth=depth)}, dev)["u"]
    teacher = params_from_numpy({"u": teacher}, dev)["u"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    lattice = torch.as_tensor(transfer_lattice(interval), device=dev)
    optimizer = make_optimizer([student[k] for k in sorted(student)], lr0,
                               lr1, iters)
    step = make_distill_step(optimizer, teacher)
    loss = torch.zeros((), device=dev)
    for i in range(iters):
        loss = step(student, sample_taps(gen, batch, lattice=lattice))
        if log_every and (i + 1) % log_every == 0:
            print(f"  it {i + 1}/{iters} loss {float(loss):.3e}", flush=True)
    with torch.no_grad():
        err = (apply_mulut_unit(student, lattice)
               - apply_mulut_unit(teacher, lattice))
        mse, max_abs = float(torch.mean(err ** 2)), float(err.abs().max())
    metrics = {
        "final_batch_mse": float(loss),
        "lattice_mse": mse,
        "lattice_max_abs": max_abs,
        # in int8 LUT levels (the artifact quantum, 2/254 per level)
        "lattice_max_levels": max_abs * 127.0,
    }
    return params_to_numpy({"u": student})["u"], metrics


def cascade_distill_loss(params: dict, teacher: dict, x: torch.Tensor, *,
                         modes: str, stages: int,
                         scale: int) -> torch.Tensor:
    """MSE of the students' train-phase cascade on the crops `x` against
    the teacher cascade's train-phase output (no gradients)."""
    cfg = dict(modes=modes, stages=stages, scale=scale, phase="train")
    with torch.no_grad():
        target = srnets_predict(teacher, x, **cfg)
    return torch.mean((srnets_predict(params, x, **cfg) - target) ** 2)


def make_cascade_distill_step(optimizer, teacher: dict, *, modes: str,
                              stages: int, scale: int):
    """One step of `distill_finetune_cascade`, `step(params, x) -> loss`
    (`cascade_distill_loss`; `train.loss_step`)."""
    return loss_step(optimizer, lambda p, x: cascade_distill_loss(
        p, teacher, x, modes=modes, stages=stages, scale=scale))


def distill_finetune_cascade(students: dict, dense_params: dict, *,
                             modes: str = "sdy", stages: int = 2,
                             scale: int = 4, iters: int = 2000,
                             batch: int = 16, crop: int = 48,
                             lr0: float = 2e-4, lr1: float = 1e-6,
                             seed: int = 0, sigma: float = 0.0,
                             extra_images=None, extra_weight: float = 0.7,
                             verbose: bool = False, device=None):
    """Image-space distillation on `device` (None: the card): fine-tune the
    whole student cascade onto the frozen dense cascade's outputs
    (`make_cascade_distill_step`).

    Crops of `batch` x `crop` x `crop` pixels, one random channel each,
    come from 24 procedurally generated 192^2 images
    (`data.synthetic._synth_image`) or, with probability `extra_weight`,
    from `extra_images` (HWC uint8; those smaller than the crop are
    dropped), each flipped and rotated at random; `sigma > 0` adds
    Gaussian noise in 8-bit units.  Every draw is the host
    `numpy.random.default_rng(seed)`'s, in the JAX package's order.
    Returns (students as float32 NumPy arrays, per-step losses)."""
    dev = resolve_device(device, "distill_finetune_cascade")
    rng = np.random.default_rng(seed)
    pool = [np.asarray(_synth_image(rng, 192), np.float32) / 255.0
            for _ in range(24)]
    extra = [np.asarray(im, np.float32) / 255.0
             for im in (extra_images or [])
             if im.shape[0] >= crop and im.shape[1] >= crop]
    params = trainable(students, dev)
    optimizer = make_optimizer(param_leaves(params), lr0, lr1, iters)
    step = make_cascade_distill_step(
        optimizer, params_from_numpy(dense_params, dev), modes=modes,
        stages=stages, scale=scale)
    losses = []
    for i in range(iters):
        crops = []
        for _ in range(batch):
            src = (extra[rng.integers(len(extra))]
                   if extra and rng.random() < extra_weight
                   else pool[rng.integers(len(pool))])
            y = rng.integers(0, src.shape[0] - crop + 1)
            x = rng.integers(0, src.shape[1] - crop + 1)
            c = rng.integers(0, src.shape[2])
            patch = src[y: y + crop, x: x + crop, c]
            # rigid augmentation (ref: sr/data.py:105-116)
            if rng.random() < 0.5:
                patch = patch[::-1]
            if rng.random() < 0.5:
                patch = patch[:, ::-1]
            patch = np.rot90(patch, rng.integers(4))
            crops.append(np.ascontiguousarray(patch))
        # (B, 1, crop, crop): one random channel, as the reference's
        # training crops (ref: sr/data.py:99)
        crops = np.stack(crops)[:, None]
        if sigma > 0:
            crops = np.clip(
                crops + rng.normal(0, sigma / 255.0, crops.shape), 0, 1)
        losses.append(step(params, torch.from_numpy(
            crops.astype(np.float32)).to(dev)))
        if verbose and (i + 1) % max(1, iters // 8) == 0:
            print(f"  e2e it {i + 1}/{iters} loss {float(losses[-1]):.3e}",
                  flush=True)
    return params_to_numpy(params), [float(x) for x in losses]


def distill_srnets(dense_params: dict, *, modes: str = "sdy",
                   stages: int = 2, scale: int = 4, nf: int = 128,
                   depth: int = 2, iters: int = 4000, batch: int = 65536,
                   lr0: float = 2e-3, lr1: float = 1e-5, seed: int = 0,
                   interval: int = 4, verbose: bool = False, device=None):
    """Distill every unit of an SRNets registry ("s{stage}_{mode}" keys,
    ref: sr/model.py:15-36) into plain students with `distill_unit`, one
    `numpy.random.default_rng(seed)` drawn in turn by every unit.  `depth`
    may be a tuple or list, one per stage, as `init_srnets` takes it.
    Returns (students, metrics) with matching keys."""
    dev = resolve_device(device, "distill_srnets")
    rng = np.random.default_rng(seed)
    students, metrics = {}, {}
    for s in range(stages):
        upscale = scale if s + 1 == stages else 1
        d_s = depth[s] if isinstance(depth, (tuple, list)) else depth
        for mode in modes:
            name = f"s{s + 1}_{mode}"
            if verbose:
                print(f"distilling {name} (upscale {upscale}, "
                      f"depth {d_s}) ...", flush=True)
            students[name], metrics[name] = distill_unit(
                rng, dense_params[name], nf=nf, depth=d_s, upscale=upscale,
                iters=iters, batch=batch, lr0=lr0, lr1=lr1,
                interval=interval, log_every=iters // 4 if verbose else 0,
                device=dev)
            if verbose:
                m = metrics[name]
                print(f"  {name}: lattice mse {m['lattice_mse']:.3e}, "
                      f"max |err| {m['lattice_max_levels']:.2f} LUT levels",
                      flush=True)
    return students, metrics
