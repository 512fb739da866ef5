"""Multi-device dry run of the port, on tiny shapes.

    from mulut_tpu_torch.dryrun import dryrun_multidevice
    dryrun_multidevice(4, ["cpu"] * 4)        # on the host
    dryrun_multidevice(4, ["cuda:0"] * 4)     # four shards of one card

Torch twin of `__graft_entry__.dryrun_multichip`: over a mesh of `n`
devices (`parallel.mesh.make_mesh`; default the first n CUDA devices) it
runs each way the port cuts work over devices and holds it against the
same work on the mesh's first device alone:

  * a data-parallel train step and fine-tune step (params replicated, the
    batch sharded, gradients reduced onto the first device): the loss and
    the updated params within 1e-6;
  * batch-sharded LUT retrieval (the packed x4 cascade per shard);
  * row-sharded LUT retrieval of one image at an even and an uneven H
    (`parallel.spatial.cascade_row_sharded`) and row-sharded net mode
    (`net_row_sharded` through the fast forward);
  * `LutEvaluator(bucket=8)` over mixed sizes and
    `NetEvaluator(fast=True)` (RGB and YUV) on the mesh (`device=` the
    list of n devices) at a batch that is not a device multiple;

the LUT paths and net mode byte for byte.  Raises RuntimeError on the
first difference; returns the names of the checks that passed.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.lut_model import init_lut_weights_from_arrays
from .models.srnet import (
    init_srnets,
    srnets_predict_fast,
    stack_srnets_for_fast,
)
from .models.torch_import import params_from_numpy
from .ops.ensemble import KERNEL_FORMATS, prepare_expanded_luts
from .ops.tail_kernel import lut_cascade_u8
from .parallel.mesh import (
    make_mesh,
    replicate_tree,
    shard_batch,
    tree_leaves,
)
from .parallel.spatial import cascade_row_sharded, net_row_sharded
from .pipelines.evaluate import LutEvaluator, NetEvaluator
from .pipelines.finetune import make_finetune_step
from .pipelines.train import make_optimizer, make_train_step, trainable

SCALE, MODES, STAGES = 4, "sdy", 2
#: tolerance of a data-parallel step against the one-device step (the
#: JAX package's tests/test_parallel.py)
STEP_ATOL = 1e-6


def _random_luts(rng, interval: int) -> dict:
    L = 2 ** (8 - interval) + 1
    return {f"s{s + 1}_{m}": rng.integers(
        -127, 128, (L ** 4, SCALE * SCALE if s + 1 == STAGES else 1)
    ).astype(np.int8) for s in range(STAGES) for m in MODES}


def _equal(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        n = (int((got != want).sum()) if got.shape == want.shape
             else f"shape {got.shape} vs {want.shape}")
        raise RuntimeError(f"dry run: {what} differs from one device ({n})")


def _step_pair(what: str, make_step, tree, mesh, im, lb) -> None:
    """One step of `make_step(optimizer, mesh)` on the mesh's first device
    alone and on the mesh, each from a copy of `tree` (trainable float32
    tensors): loss and updated leaves within STEP_ATOL."""
    results = []
    for m in (mesh[:1], mesh):
        state = replicate_tree(m, tree)
        leaves = tree_leaves(state[0])
        step = make_step(make_optimizer(leaves, 1e-3, 1e-4, 100), m)
        loss = float(step(state if len(m) > 1 else state[0], im, lb))
        results.append((loss, [t.detach().cpu() for t in leaves]))
    (l1, p1), (ln, pn) = results
    worst = max(float((a - b).abs().max()) for a, b in zip(p1, pn))
    if not (np.isfinite(l1) and abs(l1 - ln) <= STEP_ATOL * max(1.0, abs(l1))
            and worst <= STEP_ATOL):
        raise RuntimeError(f"dry run: {what} loss {ln} vs {l1}, params off "
                           f"by {worst}")


def dryrun_multidevice(n: int, devices=None) -> list:
    mesh = make_mesh(n, devices)
    if len(mesh) < n:
        raise RuntimeError(f"dry run: {n} devices asked, {len(mesh)} found")
    dev = mesh[0]
    cfg = dict(modes=MODES, stages=STAGES)
    rng = np.random.default_rng(0)
    batch, crop = 2 * n, 8
    done = []

    # data-parallel train step
    def im_lb():
        return (torch.from_numpy(rng.integers(
                    0, 256, (batch, 1, crop, crop), dtype=np.uint8)).to(dev),
                torch.from_numpy(rng.integers(
                    0, 256, (batch, 1, crop * SCALE, crop * SCALE),
                    dtype=np.uint8)).to(dev))

    params = trainable(init_srnets(np.random.default_rng(0), nf=8,
                                   scale=SCALE, **cfg), dev)
    _step_pair("train step", lambda o, m: make_train_step(
        o, scale=SCALE, mesh=m, **cfg), params, mesh, *im_lb())
    done.append("data-parallel train step")

    # data-parallel LUT fine-tune step
    ft = init_lut_weights_from_arrays(_random_luts(rng, 4), upscale=SCALE,
                                      device=dev, **cfg)
    for t in ft.values():
        t.requires_grad_(True)
    _step_pair("fine-tune step", lambda o, m: make_finetune_step(
        o, upscale=SCALE, interval=4, mesh=m, **cfg), ft, mesh, *im_lb())
    done.append("data-parallel fine-tune step")

    # batch-sharded LUT retrieval on the packed cascade
    kw = dict(stages=STAGES, modes=MODES, scale=SCALE, interval=4)
    tabs = prepare_expanded_luts(_random_luts(rng, 4), device=dev,
                                 **KERNEL_FORMATS)
    imgs = torch.from_numpy(rng.integers(0, 256, (n, 3, 12, 12),
                                         dtype=np.uint8))
    outs = [lut_cascade_u8(t, x, **kw).cpu() for x, t in
            zip(shard_batch(mesh, imgs), replicate_tree(mesh, tabs))]
    _equal("batch-sharded retrieval", torch.cat(outs),
           lut_cascade_u8(tabs, imgs.to(dev), **kw).cpu())
    done.append("batch-sharded retrieval")

    # row-sharded retrieval of one image, even and uneven H
    for h in (4 * n, 4 * n + 3):
        big = torch.from_numpy(rng.integers(0, 256, (3, h, 16),
                                            dtype=np.uint8))
        _equal(f"row-sharded retrieval, H={h}",
               cascade_row_sharded(mesh, tabs, big, expanded=True,
                                   **kw).cpu(),
               lut_cascade_u8(tabs, big.to(dev), **kw).cpu())
        done.append(f"row-sharded retrieval, H={h}")

    # the evaluator over mixed sizes, batch-sharded (interval 6: 5**4-row
    # tables)
    luts6 = _random_luts(rng, 6)
    ev = dict(interval=6, bucket=8, scale=SCALE, **cfg)
    sizes = [(12, 12), (9, 14), (16, 10), (13, 13), (12, 12), (7, 6)]
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in sizes]
    multi = LutEvaluator(luts6, device=mesh, **ev)
    single = LutEvaluator(luts6, device=dev, **ev)
    for i, (a, b) in enumerate(zip(multi.upscale_many(imgs),
                                   single.upscale_many(imgs))):
        _equal(f"LutEvaluator image {i}", a, b)
    done.append("LutEvaluator(n_devices, bucket)")

    # net mode: the batch over the mesh (not a device multiple), and the
    # rows of one image, through the fast forward (K3 on the card)
    net = init_srnets(np.random.default_rng(1), nf=128, scale=SCALE,
                      arch="mxu", **cfg)
    nimgs = rng.integers(0, 256, (n + 1, 12, 14, 3), dtype=np.uint8)
    multi = NetEvaluator(net, fast=True, device=mesh,
                         scale=SCALE, **cfg)
    single = NetEvaluator(net, fast=True, device=dev, scale=SCALE, **cfg)
    _equal("NetEvaluator upscale_batch", multi.upscale_batch(nimgs),
           single.upscale_batch(nimgs))
    _equal("NetEvaluator upscale_yuv_batch", multi.upscale_yuv_batch(nimgs),
           single.upscale_yuv_batch(nimgs))
    done.append("NetEvaluator(n_devices)")
    st = stack_srnets_for_fast(params_from_numpy(net, dev), scale=SCALE,
                               **cfg)
    x = torch.from_numpy(rng.random((1, 1, 6 * n + 3, 16),
                                    dtype=np.float32)).to(dev)
    _equal("row-sharded net mode",
           net_row_sharded(mesh, None, x, scale=SCALE, fast_stacked=st,
                           **cfg).cpu(),
           srnets_predict_fast(st, x, scale=SCALE, **cfg).cpu())
    done.append("row-sharded net mode")
    return done
