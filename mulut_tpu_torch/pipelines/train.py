"""Step 1: train the MuLUT network (ref: sr/1_train_model.py).

Torch twin of `mulut_tpu.pipelines.train`: one training step (forward
cascade in its train phase, MSE, Adam) on one card, float32 with TF32 off
(the JAX package trains at Precision.HIGHEST).  The cosine LR schedule,
the optimizer's arithmetic (optax's Adam / AdamW), STE rounding, loss and
log formats match the JAX package.  `gpuNum > 1` runs data-parallel steps
over several devices (`parallel.mesh.data_parallel_step`);
`trainPrecision="bf16"` is the JAX package's mixed-precision step: the
units' matmuls take bf16-rounded inputs with float32 products, sums and
outputs, forward and backward (`models.blocks.Bf16Dot`), and every other
tensor (params, activations, STE rounds, loss, grads, Adam state) stays
float32.
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch

from ..data import Provider, SRBenchmark
from ..models.blocks import PRECISIONS
from ..models.srnet import init_srnets, srnets_predict
from ..models.torch_import import (
    load_opt_state_npz,
    load_params_npz,
    params_from_numpy,
    save_opt_state_npz,
    save_params_npz,
)
from ..ops.resize import full_f32_matmul
from ..ops.unit_kernel import _INV255
from ..parallel.mesh import data_parallel_step, mesh_for, replicate_tree
from ..utils.imgio import save_image
from ..utils.logging_utils import logger_info
from ..utils.metrics import psnr, rgb2ycbcr


def cosine_lr(lr0: float, lr1: float, total_iter: int):
    """The reference's cosine schedule (ref: sr/1_train_model.py:149-155),
    a function of the 0-based update count.  Host float64 arithmetic; the
    JAX package evaluates it in float32 on the device (within an ulp)."""
    if lr1 < 0:
        lr_a, lr_b = 0.8, 0.2
    else:
        lr_b = lr1 / lr0
        lr_a = 1 - lr_b

    def schedule(step):
        cos = (1 + math.cos(step * math.pi / total_iter)) / 2
        return lr0 * (cos * lr_a + lr_b)

    return schedule


class OptaxAdam(torch.optim.Optimizer):
    """`optax.adam(schedule, b1, b2, eps)` as a torch optimizer, and with
    `weight_decay > 0` `optax.adamw`: in float32 per parameter,

        mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)   (t = k + 1)
        p += -schedule(k) * (u + weight_decay * p)

    where k is the optimizer's own 0-based update count (the state's
    "step"), which restarts at 0 when the optimizer is made anew.  eps sits
    outside the square root, and the decay is scaled by the learning rate,
    as in optax (`torch.optim.Adam` divides in another order and its
    scheduler counts from another origin)."""

    def __init__(self, params, schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("OptaxAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int64)
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                k = int(st["step"])
                g = p.grad
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(k + 1))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(k + 1))
                u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2) + eps)
                if wd > 0:
                    u = u + wd * p
                p.add_(u * -float(np.float32(self.schedule(k))))
                st["step"] = torch.tensor(k + 1, dtype=torch.int64)
        return None


def make_optimizer(params, lr0: float, lr1: float, total_iter: int,
                   weight_decay: float = 0.0) -> OptaxAdam:
    """Adam(0.9, 0.999, eps 1e-8) + cosine LR over the tensors `params`
    (ref: sr/1_train_model.py:146); AdamW with weight_decay > 0."""
    return OptaxAdam(params, cosine_lr(lr0, lr1, total_iter), b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=weight_decay)


def param_leaves(params: dict) -> list:
    """The tensors of a {unit: {name: tensor}} dict in the JAX package's
    leaf order (sorted keys at both levels)."""
    return [params[u][n] for u in sorted(params) for n in sorted(params[u])]


def trainable(params: dict, device) -> dict:
    """NumPy (or tensor) params -> float32 leaf tensors on `device` that
    require grad."""
    out = params_from_numpy(params, device)
    for unit in out.values():
        for name, t in unit.items():
            unit[name] = t.detach().clone().requires_grad_(True)
    return out


def train_loss(params: dict, im: torch.Tensor, lb: torch.Tensor, *,
               modes: str, stages: int, scale: int,
               precision: str = "f32") -> torch.Tensor:
    """MSE of the train-phase cascade on a uint8 batch, normalized on the
    card as XLA does `/ 255` (a multiply by float32(1/255)); the units'
    matmuls at `precision` ("f32" or "bf16")."""
    x = im.to(torch.float32) * _INV255
    y = lb.to(torch.float32) * _INV255
    pred = srnets_predict(params, x, modes=modes, stages=stages, scale=scale,
                          phase="train", precision=precision)
    return torch.mean((pred - y) ** 2)


def loss_step(optimizer, loss_fn):
    """`step(params, *batch) -> loss` (the loss before the update,
    detached): `loss_fn(params, *batch)`, its backward and the optimizer's
    update of the tensors in place, all under `full_f32_matmul`."""
    def step(params, *batch):
        optimizer.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss = loss_fn(params, *batch)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def make_train_step(optimizer, *, modes: str, stages: int, scale: int,
                    precision: str = "f32", mesh: list | None = None):
    """One training step `step(params, im, lb) -> loss` (the loss before
    the update, detached): forward, backward and the optimizer's update
    of the tensors of `params` in place, all under `full_f32_matmul`.
    precision "bf16" runs the units' matmuls as `blocks.Bf16Dot` (the
    JAX step's Precision.DEFAULT on a TPU: bf16-rounded inputs, float32
    products, sums and outputs, in the backward's products too); every
    other op, the loss, the grads and the optimizer stay float32.

    With a `mesh` of several devices (`parallel.mesh.make_mesh`) the step
    is data-parallel: `step(replicas, im, lb)` takes one copy of the
    params per device (`parallel.mesh.replicate_tree`; `optimizer` steps
    the first), splits the batch over the devices and reduces the shards'
    losses and gradients onto the first (`data_parallel_grads`), updates
    once and copies the params to the other replicas: the full-batch step
    up to summation order."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")

    def loss_fn(params, im, lb):
        return train_loss(params, im, lb, modes=modes, stages=stages,
                          scale=scale, precision=precision)

    if mesh is not None and len(mesh) > 1:
        def dp_step(replicas, im, lb):
            with full_f32_matmul():
                return data_parallel_step(optimizer, mesh, replicas, loss_fn,
                                          im, lb)

        return dp_step

    return loss_step(optimizer, loss_fn)


def make_summary_writer(log_dir: str):
    """TensorBoard writer (ref: sr/1_train_model.py:127), or a no-op stub
    when torch's tensorboard backend is unavailable."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:  # noqa: BLE001 - observability must never break training
        class _Null:
            def add_scalar(self, *a, **k):
                pass

            def flush(self):
                pass

            def close(self):
                pass

        return _Null()


def valid_steps(params, valid: SRBenchmark, opt, it: int, logger,
                writer=None):
    """Benchmark validation with PNG dumps (ref: sr/1_train_model.py:70-119),
    the valid phase of the cascade on the params' device."""
    datasets = ["Set5"] if opt.debug else valid.datasets
    dev = param_leaves(params)[0].device
    for dataset in datasets:
        if dataset not in valid.files:
            continue
        psnrs = []
        result_path = os.path.join(opt.valoutDir, dataset)
        os.makedirs(result_path, exist_ok=True)
        for name, lr, hr in valid.pairs(dataset):
            x = torch.as_tensor(
                lr.astype(np.float32).transpose(2, 0, 1)[None] / 255.0,
                device=dev)
            with torch.no_grad():
                pred = srnets_predict(params, x, modes=opt.modes,
                                      stages=opt.stages, scale=opt.scale,
                                      phase="valid")
            pred = pred[0].cpu().numpy().transpose(1, 2, 0)
            pred = np.round(np.clip(pred, 0, 255)).astype(np.uint8)
            left = rgb2ycbcr(pred)[:, :, 0]
            right = rgb2ycbcr(hr)[:, :, 0]
            psnrs.append(psnr(left, right, opt.scale))
            if it < 10000:
                save_image(os.path.join(result_path, f"{name}_input.png"), lr)
                save_image(os.path.join(result_path, f"{name}_gt.png"), hr)
            save_image(os.path.join(result_path, f"{name}_net.png"), pred)
        avg = float(np.mean(np.asarray(psnrs)))
        logger.info(
            "Iter {} | Dataset {} | AVG Val PSNR: {:02f}".format(
                it, dataset, avg
            )
        )
        if writer is not None:
            writer.add_scalar(f"PSNR_valid/{dataset}", avg, it)


def train(opt, device=None) -> dict:
    """Full step-1 training CLI behavior on `device` (None: the card).
    Returns the final params ({unit: {name: tensor}}).  `opt.gpuNum > 1`
    trains data-parallel over min(gpuNum, device count) devices
    (`parallel.mesh.mesh_for`: gpuNum CPU shards with `device="cpu"`, or a
    list of gpuNum devices given as `device`).  `opt.trainPrecision`
    ("f32" or "bf16") picks the step's matmul precision
    (`make_train_step`)."""
    mesh = mesh_for(device, getattr(opt, "gpuNum", 1), "train")
    dev = mesh[0]
    logger_name = "train"
    logger_info(logger_name, os.path.join(opt.expDir, logger_name + ".log"))
    logger = logging.getLogger(logger_name)
    writer = make_summary_writer(opt.expDir)

    params = init_srnets(np.random.default_rng(0), nf=opt.nf, scale=opt.scale,
                         modes=opt.modes, stages=opt.stages,
                         arch=getattr(opt, "arch", "dense"),
                         depth=getattr(opt, "unitDepth", 0) or None)
    if opt.startIter > 0:
        ckpt = os.path.join(opt.expDir, f"Model_{opt.startIter:06d}.npz")
        params = load_params_npz(ckpt)
    params = trainable(params, dev)
    optimizer = make_optimizer(param_leaves(params), opt.lr0, opt.lr1,
                               opt.totalIter, opt.weightDecay)
    if opt.startIter > 0:
        opt_ckpt = os.path.join(opt.expDir, f"Opt_{opt.startIter:06d}.npz")
        if os.path.exists(opt_ckpt):
            # Full resume: Adam moments + the update count that drives the
            # cosine-LR phase (ref: sr/1_train_model.py:65-66, 157-164).
            load_opt_state_npz(opt_ckpt, optimizer)
            logger.info(f"Resumed params+optimizer from iter {opt.startIter}")
        else:
            logger.info(
                f"Resumed params from {ckpt} (no Opt_*.npz — optimizer "
                "state re-initialized; trajectory will differ)"
            )
    step = make_train_step(optimizer, modes=opt.modes, stages=opt.stages,
                           scale=opt.scale,
                           precision=getattr(opt, "trainPrecision", "f32"),
                           mesh=mesh)
    state = (params if len(mesh) == 1
             else [params] + replicate_tree(mesh[1:], params))

    provider = Provider(opt.batchSize, opt.workerNum, opt.scale, opt.trainDir,
                        opt.cropSize)
    valid = SRBenchmark(opt.valDir, scale=opt.scale)

    # Losses accumulate on the card and sync once per display window.
    l_accum = torch.zeros((), device=dev)
    dT = 0.0
    window_start = time.time()
    accum_samples = 0
    try:
        for i in range(opt.startIter + 1, opt.totalIter + 1):
            st = time.time()
            im, lb = provider.next()
            im = torch.from_numpy(im).to(dev)
            lb = torch.from_numpy(lb).to(dev)
            dT += time.time() - st

            l_accum += step(state, im, lb)
            accum_samples += opt.batchSize

            if i % opt.displayStep == 0:
                avg_loss = float(l_accum) / opt.displayStep  # sync point
                wall = time.time() - window_start
                logger.info(
                    "{} | Iter:{:6d}, Sample:{:6d}, GPixel:{:.2e}, dT:{:.4f}, rT:{:.4f}".format(
                        opt.expDir, i, accum_samples, avg_loss,
                        dT / opt.displayStep,
                        (wall - dT) / opt.displayStep,
                    )
                )
                writer.add_scalar("loss_Pixel", avg_loss, i)
                l_accum.zero_()
                dT = 0.0
                window_start = time.time()

            if i % opt.saveStep == 0:
                save_params_npz(os.path.join(opt.expDir, f"Model_{i:06d}.npz"),
                                params)
                save_opt_state_npz(
                    os.path.join(opt.expDir, f"Opt_{i:06d}.npz"), optimizer)
                logger.info(f"Checkpoint saved {i}")

            if i % opt.valStep == 0:
                valid_steps(params, valid, opt, i, logger, writer=writer)
                writer.flush()
    finally:
        provider.close()
        writer.close()
    logger.info("Complete")
    return params
