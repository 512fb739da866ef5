"""Step 3: STE fine-tuning of cached LUT entries (ref: sr/3_finetune_lut.py).

Torch twin of `mulut_tpu.pipelines.finetune`: the int8 LUTs become float32
trainables driven by the differentiable simplex cascade
(`models.lut_model`); Adam + cosine LR (optax's arithmetic,
`pipelines.train.OptaxAdam`) on DIV2K patches, PSNR/SSIM validation, int8
re-export through `utils.lut_io`'s naming.  `gpuNum > 1` runs
data-parallel steps over several devices, as `pipelines.train` does.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..data import Provider, SRBenchmark
from ..models.lut_model import (
    export_lut_weights,
    init_lut_weights_from_folder,
    lut_model_forward,
    unit_pixels,
)
from ..models.torch_import import load_opt_state_npz, save_opt_state_npz
from ..ops.resize import full_f32_matmul
from ..ops.unit_kernel import _INV255
from ..parallel.mesh import data_parallel_step, mesh_for, replicate_tree
from ..utils.imgio import save_image
from ..utils.logging_utils import logger_info
from ..utils.lut_io import lut_filename, parse_stage_key
from ..utils.metrics import psnr, rgb2ycbcr, ssim
from .train import make_optimizer


def finetune_loss(weights: dict, im: torch.Tensor, lb: torch.Tensor, *,
                  modes: str, stages: int, upscale: int,
                  interval: int) -> torch.Tensor:
    """MSE of the LUT cascade on a uint8 batch.  The input is divided by
    255 exactly (`unit_pixels`), so the cascade's `x * 255` gives back the
    integer pixels (as XLA's folded `/ 255 * 255` does in the JAX step);
    the label is normalized as XLA does it (a multiply by
    float32(1/255))."""
    x = unit_pixels(im)
    y = lb.to(torch.float32) * _INV255
    pred = lut_model_forward(weights, x, modes=modes, stages=stages,
                             upscale=upscale, interval=interval,
                             device=im.device)
    return torch.mean((pred - y) ** 2)


def make_finetune_step(optimizer, *, modes: str, stages: int, upscale: int,
                       interval: int, mesh: list | None = None):
    """One fine-tune step `step(weights, im, lb) -> loss` (the loss before
    the update, detached), updating the tensors of `weights` in place,
    under `full_f32_matmul` (the corner contraction's backward is a
    matmul of float gradients).  With a `mesh` of several devices,
    `step(replicas, im, lb)` is data-parallel, as
    `pipelines.train.make_train_step`'s."""
    def loss_fn(weights, im, lb):
        return finetune_loss(weights, im, lb, modes=modes, stages=stages,
                             upscale=upscale, interval=interval)

    if mesh is not None and len(mesh) > 1:
        def dp_step(replicas, im, lb):
            with full_f32_matmul():
                return data_parallel_step(optimizer, mesh, replicas, loss_fn,
                                          im, lb)

        return dp_step

    def step(weights, im, lb):
        optimizer.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss = loss_fn(weights, im, lb)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def valid_steps(weights, valid: SRBenchmark, opt, it: int, logger):
    """PSNR + SSIM validation (ref: sr/3_finetune_lut.py:23-65)."""
    datasets = ["Set5", "Set14"] if opt.debug else valid.datasets
    dev = next(iter(weights.values())).device
    for dataset in datasets:
        if dataset not in valid.files:
            continue
        psnrs, ssims = [], []
        result_path = os.path.join(opt.valoutDir, dataset)
        os.makedirs(result_path, exist_ok=True)
        for name, lr, hr in valid.pairs(dataset):
            x = torch.as_tensor(
                lr.astype(np.float32).transpose(2, 0, 1)[None] / 255.0,
                device=dev)
            with torch.no_grad():
                pred = lut_model_forward(weights, x, modes=opt.modes,
                                         stages=opt.stages, upscale=opt.scale,
                                         interval=opt.interval, device=dev)
            pred = pred[0].cpu().numpy().transpose(1, 2, 0) * 255.0
            pred = np.round(np.clip(pred, 0, 255)).astype(np.uint8)
            left, right = rgb2ycbcr(pred)[:, :, 0], rgb2ycbcr(hr)[:, :, 0]
            psnrs.append(psnr(left, right, opt.scale))
            ssims.append(ssim(left, right))
            save_image(os.path.join(result_path, f"{name}_lutft.png"), pred)
        logger.info(
            "Iter {} | Dataset {} | AVG PSNR: {:02f}, AVG: SSIM: {:04f}".format(
                it, dataset, float(np.mean(psnrs)), float(np.mean(ssims))
            )
        )


def finetune(opt, device=None) -> dict:
    """Full step-3 CLI behavior on `device` (None: the card): reads the
    transfer step's LUTs from `opt.expDir`, writes `LUT_ft_*` int8 tables
    there.  Returns the fine-tuned float weights ({key: tensor}).
    `opt.gpuNum > 1` fine-tunes data-parallel, as `pipelines.train.train`
    trains."""
    mesh = mesh_for(device, getattr(opt, "gpuNum", 1), "finetune")
    dev = mesh[0]
    logger_name = "lutft"
    logger_info(logger_name, os.path.join(opt.expDir, logger_name + ".log"))
    logger = logging.getLogger(logger_name)

    weights = init_lut_weights_from_folder(
        opt.expDir, stages=opt.stages, modes=opt.modes, upscale=opt.scale,
        interval=opt.interval, device=dev)
    if opt.startIter > 0:
        # Fixed resume (the reference's two-positional-arg torch.load never
        # worked, ref: sr/3_finetune_lut.py:98-104): restore the float LUT
        # weights; the optimizer state follows below once it exists.
        wpath = os.path.join(opt.expDir, f"LUTft_{opt.startIter:06d}.npz")
        flat = np.load(wpath)
        weights = {k: torch.as_tensor(flat[k], device=dev) for k in flat.files}
        logger.info(f"Resumed LUT weights from {wpath}")
    for w in weights.values():
        w.requires_grad_(True)

    keys = sorted(weights)
    optimizer = make_optimizer([weights[k] for k in keys], opt.lr0, opt.lr1,
                               opt.totalIter, opt.weightDecay)
    if opt.startIter > 0:
        opt_ckpt = os.path.join(opt.expDir, f"Opt_ft_{opt.startIter:06d}.npz")
        if os.path.exists(opt_ckpt):
            load_opt_state_npz(opt_ckpt, optimizer)
            logger.info(f"Resumed optimizer state from {opt_ckpt}")
    step = make_finetune_step(optimizer, modes=opt.modes, stages=opt.stages,
                              upscale=opt.scale, interval=opt.interval,
                              mesh=mesh)
    state = (weights if len(mesh) == 1
             else [weights] + replicate_tree(mesh[1:], weights))

    provider = Provider(opt.batchSize, opt.workerNum, opt.scale, opt.trainDir,
                        opt.cropSize)
    valid = SRBenchmark(opt.valDir, scale=opt.scale)

    # loss accumulation on the card, one sync per window (see train.py)
    l_accum = torch.zeros((), device=dev)
    dT, accum_samples = 0.0, 0
    window_start = time.time()
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
                avg_loss = float(l_accum) / opt.displayStep
                wall = time.time() - window_start
                logger.info(
                    "{} | Iter:{:6d}, Sample:{:6d}, GPixel:{:.2e}, dT:{:.4f}, rT:{:.4f}".format(
                        opt.expDir, i, accum_samples, avg_loss,
                        dT / opt.displayStep,
                        (wall - dT) / opt.displayStep,
                    )
                )
                l_accum.zero_()
                dT = 0.0
                window_start = time.time()

            if i % opt.valStep == 0 or i == 1:
                valid_steps(weights, valid, opt, i, logger)

            if i % opt.saveStep == 0:
                np.savez(
                    os.path.join(opt.expDir, f"LUTft_{i:06d}.npz"),
                    **{k: v.detach().cpu().numpy() for k, v in weights.items()},
                )
                save_opt_state_npz(
                    os.path.join(opt.expDir, f"Opt_ft_{i:06d}.npz"), optimizer)
                logger.info(f"Checkpoint saved {i}")
    finally:
        provider.close()

    for key, arr in export_lut_weights(weights).items():
        stage, mode = parse_stage_key(key)
        path = os.path.join(
            opt.expDir,
            lut_filename("LUT_ft", opt.scale, opt.interval, stage, mode),
        )
        np.save(path, arr)
    logger.info(f"Finetuned LUT saved to {opt.expDir}")
    logger.info("Complete")
    return weights
