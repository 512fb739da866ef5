"""Row sharding of one large image over a mesh.

Torch twin of `mulut_tpu.parallel.spatial`.  JAX shards the image's row
axis over its mesh and lets XLA exchange the halos; here each device of
the mesh (`parallel.mesh.make_mesh`) computes its rows from a slab that
carries the halo rows itself, clamped into the image
(`ops.ensemble.slab_bounds`, the construction of the banded cascade), and
the bands are assembled on the first device.  Both functions give the
unsharded forward's bytes, uneven splits included.
"""

from __future__ import annotations

import torch

from ..ops import ensemble as ens
from ..ops import tail_kernel as tk
from .mesh import tree_to


def row_sharding(mesh: list, h: int, halo: int = 0):
    """How an `h`-row image splits over `mesh`: (band, slab_h, bounds),
    band = ceil(h / len(mesh)) kept rows per device, and per device the
    (kept0, start) of `ops.ensemble.slab_bounds`: it keeps rows [kept0,
    kept0 + band) and computes them from the `slab_h` rows from `start`
    (band + 2 * `halo`, clamped into the image)."""
    band = -(-h // len(mesh))
    slab_h, bounds = ens.slab_bounds(h, band, halo)
    return band, slab_h, bounds


def shard_image_rows(mesh: list, img) -> list:
    """The row bands of `img` (..., H, W) by `row_sharding`, band d on
    `mesh[d]` (no halo)."""
    img = torch.as_tensor(img)
    band, _, bounds = row_sharding(mesh, img.shape[-2])
    return [img.narrow(-2, kept0, band).to(dev)
            for dev, (kept0, _) in zip(mesh, bounds)]


def _assemble(mesh: list, shape, pieces, band: int, scale: int):
    out = torch.empty(shape, dtype=pieces[0][1].dtype, device=mesh[0])
    for kept0, piece in pieces:
        out.narrow(-2, kept0 * scale, band * scale).copy_(piece)
    return out


def cascade_row_sharded(mesh: list, luts: dict, img, *, stages: int,
                        modes: str, scale: int, interval: int = 4,
                        expanded: bool = False) -> torch.Tensor:
    """The LUT cascade with the image rows sharded over `mesh`.

    `img` is (..., H, W) integer in [0, 255].  H is edge-padded up to a
    device multiple and the cascade runs with `valid_hw = (H, W)` (the
    bucketed-evaluation clamp, `ops.ensemble.clamp_pad_region`), as in the
    JAX package; device d computes the rows of its band from a clamped
    slab, with the tables moved to its device where they are not there
    already (read only: shards of one device share them).  Expanded
    tables where `ops.tail_kernel.supports_tail_kernel` holds run the
    packed cascade (K1 and K2 on the card) and must be in its formats
    (`ops.ensemble.KERNEL_FORMATS`, as `LutEvaluator` builds them; others
    raise ValueError); raw tables, and any at other configurations, run
    `ops.ensemble.lut_cascade_int`.  Returns (..., H*scale, W*scale)
    uint8 on `mesh[0]`, bytes equal to the unsharded cascade (the JAX
    package returns the same values as int32).
    """
    img = torch.as_tensor(img)
    H, W = img.shape[-2], img.shape[-1]
    pad = -H % len(mesh)
    if pad:
        img = ens._edge_pad(img, (0, pad), (0, 0))
    hp = H + pad
    band, slab_h, bounds = row_sharding(mesh, hp, ens.cascade_halo(stages,
                                                                modes))
    kw = dict(stages=stages, modes=modes, scale=scale, interval=interval)
    packed = expanded and tk.supports_tail_kernel(modes, scale,
                                                  interval=interval)
    pieces = []
    for dev, (kept0, start) in zip(mesh, bounds):
        tabs = tree_to(luts, dev)
        slab = img.narrow(-2, start, slab_h).to(dev)
        valid = ens.slab_valid((H, W) if pad else None, start, slab_h)
        if packed:
            out = tk.lut_cascade_u8(tabs, slab, valid_hw=valid, **kw)
        else:
            out = ens.lut_cascade_int(tabs, slab, expanded=expanded,
                                      valid_hw=valid, **kw).to(torch.uint8)
        pieces.append((kept0, out.narrow(-2, (kept0 - start) * scale,
                                         band * scale)))
    out = _assemble(mesh, tuple(img.shape[:-2]) + (hp * scale, W * scale),
                    pieces, band, scale)
    return out[..., : H * scale, :]


def net_row_sharded(mesh: list, params: dict, x, *, modes: str, stages: int,
                    scale: int, halo: int | None = None,
                    fast_stacked: list | None = None,
                    final_clip: bool | str = False) -> torch.Tensor:
    """Row-sharded net-mode forward of one large image over `mesh`.

    Device d computes rows [kept0, kept0 + band) (band = ceil(H / n)) of
    the full cascade from a slab of band + 2 * `halo` rows clamped into
    the image, on the weights moved to its device (where they are not
    there already); the bands are assembled on
    `mesh[0]` (a last band that does not fit overlaps the one before it,
    with identical values).  `x`: (B, C, H, W) float in [0, 1].  With
    `fast_stacked` (`models.srnet.stack_srnets_for_fast` stacks) each slab
    runs `srnets_predict_fast` (the stage-ensemble kernels on the card,
    `final_clip` as there), otherwise the float32 `srnets_predict`.
    Returns (B, C, H*scale, W*scale), bytes equal to the unsharded
    forward.
    """
    from ..models.srnet import srnets_predict, srnets_predict_fast

    H = x.shape[2]
    if halo is None:
        halo = ens.cascade_halo(stages, modes)
    band, slab_h, bounds = row_sharding(mesh, H, halo)
    if H < band + 2 * halo:
        raise ValueError(f"{H} rows over {len(mesh)} devices: a band of "
                         f"{band} rows needs {band + 2 * halo} with its halo")
    kw = dict(modes=modes, stages=stages, scale=scale)
    weights = fast_stacked if fast_stacked is not None else params
    pieces = []
    for dev, (kept0, start) in zip(mesh, bounds):
        w = tree_to(weights, dev)
        slab = x.narrow(2, start, slab_h).to(dev)
        if fast_stacked is not None:
            out = srnets_predict_fast(w, slab, final_clip=final_clip, **kw)
        else:
            out = srnets_predict(w, slab, phase="valid", **kw)
        pieces.append((kept0, out.narrow(2, (kept0 - start) * scale,
                                         band * scale)))
    return _assemble(mesh, (x.shape[0], x.shape[1], H * scale,
                            x.shape[3] * scale), pieces, band, scale)
