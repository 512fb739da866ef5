"""Device lists and batch sharding over them.

Torch twin of `mulut_tpu.parallel.mesh`.  The JAX package's data
parallelism is single-controller: one process drives every device of a
1-D `Mesh` (params replicated, the batch sharded, `jit` inserting the
gradient sum).  The port keeps that shape with plain functions on
tensors and no `torch.distributed`: a mesh is an ordered list of
`torch.device`s, one process enqueues each device's share on that
device's stream, and the reductions are copies onto the first device.
So `train(opt)` keeps its signature and needs no launcher.  A list may
name one device several times (`["cpu"] * 8` in the tests, `["cuda:0"] *
4` on a one-card machine): each entry is a shard of its own, with its
own copy of what is replicated.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The first `n_devices` of `devices` (default: every CUDA device, in
    order) as `torch.device`s; fewer when there are fewer, as the JAX
    package's `make_mesh` takes `jax.devices()[:n]`."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise RuntimeError("make_mesh: no device (no CUDA device, and no "
                           "device list given)")
    return mesh


def mesh_for(device, n_devices: int | None, who: str) -> list:
    """The devices an entry point with the JAX package's `n_devices` (or
    `gpuNum`) knob runs on.  `device` is None (the CUDA card; raises where
    there is none), one device, or a list of devices (a mesh: all of it,
    and a ValueError where `n_devices` is given and names another
    count).  With one device, `n_devices` (None: 1) copies of it on the
    CPU, the first `n_devices` CUDA devices on the card (clamped to
    `torch.cuda.device_count()`, as JAX clamps to `jax.device_count()`)."""
    if isinstance(device, (list, tuple)):
        mesh = make_mesh(None, device)
        if n_devices is not None and n_devices != len(mesh):
            raise ValueError(f"{who}: n_devices={n_devices} for a mesh of "
                             f"{len(mesh)} devices")
        return mesh
    n = max(1, n_devices or 1)
    dev = resolve_device(device, who)
    if n == 1:
        return [dev]
    if dev.type == "cpu":
        return [dev] * n
    return make_mesh(min(n, torch.cuda.device_count()))


def pad_batch(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis to a multiple of `n` by repeating the last
    item (the replicas are cropped off the result)."""
    pad = -arr.shape[0] % n
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)])
    return arr


def shard_batch(mesh: list, *arrays) -> list:
    """Split the leading axis of each array (NumPy or tensor) into
    `len(mesh)` contiguous shards (sizes differing by at most one, as
    `torch.tensor_split` gives them) and move shard d to `mesh[d]`.
    Returns one entry per device: the shard, or with several arrays the
    tuple of their shards."""
    parts = [torch.as_tensor(a).tensor_split(len(mesh)) for a in arrays]
    out = []
    for d, dev in enumerate(mesh):
        shard = tuple(p[d].to(dev) for p in parts)
        out.append(shard if len(shard) > 1 else shard[0])
    return out


def tree_to(tree, dev, *, copy: bool = False):
    """`tree` (dicts, lists and tuples of tensors or NumPy arrays) with
    its tensors on `dev`: moved only where they lie elsewhere, or with
    `copy` always copied (keeping `requires_grad`)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev, copy=copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev, copy=copy) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.as_tensor(tree)
    if isinstance(tree, torch.Tensor):
        if not copy:
            return tree.to(dev)
        return tree.detach().to(dev, copy=True).requires_grad_(
            tree.requires_grad)
    return tree


def replicate_tree(mesh: list, tree) -> list:
    """One copy of `tree` per device of `mesh` (`tree_to(copy=True)`):
    replicas that steps update or hold apart."""
    return [tree_to(tree, dev, copy=True) for dev in mesh]


def tree_leaves(tree) -> list:
    """The tensors of `tree` in the JAX package's leaf order (dict keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def data_parallel_grads(mesh: list, replicas: list, loss_fn, *batch):
    """The full batch's loss and gradients from one shard per device.

    `batch` is split over `mesh` (`shard_batch`); shard d's mean loss
    `loss_fn(replicas[d], *shard)` and its gradients are taken on
    `mesh[d]` against that device's replica, then summed onto the first
    device weighted by shard size: the full batch's mean and its
    gradients, up to summation order.  The gradients are written to the
    `.grad` of `replicas[0]`'s leaves (the ones its optimizer steps);
    returns the loss on `mesh[0]`, detached.  `sync_replicas` then copies
    the updated leaves to the other replicas.
    """
    n = torch.as_tensor(batch[0]).shape[0]
    master = tree_leaves(replicas[0])
    loss = grads = None
    for rep, shard in zip(replicas, shard_batch(mesh, *batch)):
        shard = shard if isinstance(shard, tuple) else (shard,)
        leaves = tree_leaves(rep)
        part = loss_fn(rep, *shard)
        g = torch.autograd.grad(part, leaves)
        w = shard[0].shape[0] / n
        part = part.detach().to(mesh[0]) * w
        g = [t.to(mesh[0]) * w for t in g]
        if loss is None:
            loss, grads = part, g
        else:
            loss = loss + part
            grads = [a + b for a, b in zip(grads, g)]
    for t, g in zip(master, grads):
        t.grad = g
    return loss


def data_parallel_step(optimizer, mesh: list, replicas: list, loss_fn,
                       *batch):
    """One data-parallel update: `data_parallel_grads`, `optimizer`'s step
    of `replicas[0]`'s leaves, `sync_replicas`; returns the loss."""
    loss = data_parallel_grads(mesh, replicas, loss_fn, *batch)
    optimizer.step()
    sync_replicas(replicas)
    return loss


@torch.no_grad()
def sync_replicas(replicas: list) -> None:
    """Copy the leaves of `replicas[0]` into every other replica."""
    master = tree_leaves(replicas[0])
    for rep in replicas[1:]:
        for t, m in zip(tree_leaves(rep), master):
            t.copy_(m)
