"""Non-SR task pipelines: denoising / deblocking (DNNets) and demosaicking
(DMNet).

Torch twin of `mulut_tpu.pipelines.tasks`.  The reference ships the models
for these tasks (DNNet/DMNet, ref: common/network.py:229-317) but no
pipeline.  The x1 cascade trains as the SR cascade at scale 1
(`models.srnet.dnnets_predict`), caches through `transfer.cache_lut`, and
deploys through the integer simplex cascade at scale 1 over the expanded
tables (`ops.ensemble.lut_cascade_int(expanded=True)`): every contraction
there runs the window-read kernel K1 on the card, with the bytes of the
JAX package's raw-table cascade.  Demosaicking caches one plain unit with
12 output lanes and deploys it as one integer simplex pass per 2x2 bayer
cell (`ops.simplex.simplex_planes_int`, torch ops).

Degradations are made on the host from clean uint8 images:
  * denoise: additive Gaussian noise, sigma in 8-bit units (the
    reference's `--sigma` flag, ref: common/option.py:19);
  * deblock: a JPEG round trip at quality factor qf (`--qf`, :20; PIL,
    imported inside the function);
  * demosaic: RGGB bayer sampling of the RGB image.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..models.srnet import dmnet_apply, dnnets_predict, init_dmnet, init_dnnets
from ..models.torch_import import params_to_numpy
from ..ops.ensemble import lut_cascade_int, prepare_expanded_luts
from ..ops.simplex import simplex_planes_int
from ..ops.unit_kernel import _INV255
from ..utils.device import resolve_device
from .train import loss_step, make_optimizer, param_leaves, trainable
from .transfer import cache_lut, transfer_to_luts


# ---------------------------------------------------------------------------
# Degradations (host side, uint8 in/out)
# ---------------------------------------------------------------------------

def add_gaussian_noise(img: np.ndarray, sigma: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Additive Gaussian noise in 8-bit units, rounded and clipped (the
    denoise input)."""
    noisy = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(np.round(noisy), 0, 255).astype(np.uint8)


def jpeg_roundtrip(img: np.ndarray, qf: int) -> np.ndarray:
    """JPEG compress/decompress at quality qf (the deblock input)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(qf))
    return np.array(Image.open(buf).convert(
        "RGB" if img.ndim == 3 else "L"
    ))


def bayer_mosaic(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> (H, W) RGGB bayer plane (the demosaic input)."""
    h, w = img.shape[:2]
    out = np.empty((h, w), img.dtype)
    out[0::2, 0::2] = img[0::2, 0::2, 0]   # R
    out[0::2, 1::2] = img[0::2, 1::2, 1]   # G
    out[1::2, 0::2] = img[1::2, 0::2, 1]   # G
    out[1::2, 1::2] = img[1::2, 1::2, 2]   # B
    return out


# ---------------------------------------------------------------------------
# Denoise / deblock: x1 cascade (DNNets)
# ---------------------------------------------------------------------------

def dn_loss(params: dict, im: torch.Tensor, lb: torch.Tensor, *,
            modes: str, stages: int) -> torch.Tensor:
    """MSE of the x1 cascade's train phase on a degraded uint8 batch
    against the clean one, both normalized as XLA does `/ 255` (a
    multiply by float32(1/255))."""
    x = im.to(torch.float32) * _INV255
    y = lb.to(torch.float32) * _INV255
    pred = dnnets_predict(params, x, modes=modes, stages=stages,
                          phase="train")
    return torch.mean((pred - y) ** 2)


def make_dn_train_step(optimizer, *, modes: str, stages: int):
    """One x1-cascade training step `step(params, im, lb) -> loss`
    (degraded -> clean MSE, `dn_loss`)."""
    return loss_step(optimizer, lambda p, im, lb: dn_loss(
        p, im, lb, modes=modes, stages=stages))


def train_dn(clean_batches, *, modes: str = "sdy", stages: int = 2,
             nf: int = 64, iters: int = 100, lr0: float = 1e-3,
             lr1: float = 1e-4, degrade=None, seed: int = 0, device=None):
    """Train a denoise/deblock cascade on `device` (None: the card) from an
    iterable of (B, C, H, W) uint8 clean batches; `degrade` maps a clean
    batch to the network input (default: sigma 15 Gaussian noise from the
    host `numpy.random.default_rng(seed)`, draw for draw as in the JAX
    package).  The dense units start from `init_dnnets` on a generator of
    their own (`default_rng([seed, 1])`), apart from the noise's stream.
    Returns (params as float32 NumPy arrays, per-step losses)."""
    dev = resolve_device(device, "train_dn")
    rng = np.random.default_rng(seed)
    if degrade is None:
        degrade = lambda b: add_gaussian_noise(b, 15.0, rng)  # noqa: E731
    params = trainable(init_dnnets(np.random.default_rng([seed, 1]), nf=nf,
                                   modes=modes, stages=stages), dev)
    optimizer = make_optimizer(param_leaves(params), lr0, lr1, iters)
    step = make_dn_train_step(optimizer, modes=modes, stages=stages)
    losses = []
    it = iter(clean_batches)
    for _ in range(iters):
        clean = np.asarray(next(it))
        noisy = degrade(clean)
        losses.append(step(params, torch.from_numpy(
            np.ascontiguousarray(noisy)).to(dev), torch.from_numpy(
            np.ascontiguousarray(clean)).to(dev)))
    return params_to_numpy(params), [float(x) for x in losses]


def dn_transfer(params, *, modes: str = "sdy", stages: int = 2,
                interval: int = 4, device=None) -> dict:
    """Cache the x1 cascade into LUTs ({"s{n}_{m}": (L**4, 1) int8}) on
    `device` (None: the card)."""
    return transfer_to_luts(params, modes=modes, stages=stages,
                            interval=interval, device=device)


def dn_lut_apply(luts: dict, img: np.ndarray, *, modes: str = "sdy",
                 stages: int = 2, interval: int = 4,
                 device=None) -> np.ndarray:
    """Deploy the cached x1 cascade: (H, W[, C]) uint8 -> same-shape uint8,
    on `device` (None: the card).

    The integer simplex cascade at scale 1 (ref: sr/4_test_lut.py:263-306
    at upscale 1) over the JAX package's default expanded formats, built
    on the device from the (L**4, 1) tables: the symmetric modes (s, d,
    e) read rotation-folded (L**4, 64) rows (K1 at u=4), the others
    (L**4, 16) int32 rows (K1 at u=1), one contraction per stage and
    mode.  The bytes of the JAX package's raw-table cascade."""
    dev = resolve_device(device, "dn_lut_apply")
    chw = img.astype(np.int32)
    if chw.ndim == 3:
        chw = chw.transpose(2, 0, 1)
    tabs = prepare_expanded_luts(luts, interval=interval, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(chw)).to(dev)
    out = lut_cascade_int(tabs, x, stages=stages, modes=modes, scale=1,
                          interval=interval, expanded=True).cpu().numpy()
    if img.ndim == 3:
        out = out.transpose(1, 2, 0)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Demosaic: single bayer-cell unit (DMNet)
# ---------------------------------------------------------------------------

def dm_loss(params: dict, bayer: torch.Tensor,
            rgb: torch.Tensor) -> torch.Tensor:
    """MSE of the demosaic unit on (B, H, W) uint8 mosaics against the
    (B, 3, H, W) uint8 RGB images mapped to the unit's (-1, 1) range."""
    x = bayer.to(torch.float32) * _INV255
    y = rgb.to(torch.float32) * _INV255
    pred = dmnet_apply(params, x[:, None])
    return torch.mean((pred - (y * 2.0 - 1.0)) ** 2)


def make_dm_train_step(optimizer):
    """One demosaic training step `step(params, bayer, rgb) -> loss`
    (`dm_loss`)."""
    return loss_step(optimizer, dm_loss)


def train_dm(rgb_batches, *, nf: int = 64, iters: int = 100,
             lr0: float = 1e-3, lr1: float = 1e-4, seed: int = 0,
             device=None):
    """Train the demosaic unit (`init_dmnet(default_rng(seed))`) on
    `device` (None: the card) from an iterable of (B, H, W, 3) uint8 RGB
    batches, each mosaicked on the host.  Returns (params as float32 NumPy
    arrays, per-step losses)."""
    dev = resolve_device(device, "train_dm")
    params = trainable({"u": init_dmnet(np.random.default_rng(seed),
                                        nf=nf)}, dev)["u"]
    optimizer = make_optimizer([params[k] for k in sorted(params)], lr0,
                               lr1, iters)
    step = make_dm_train_step(optimizer)
    losses = []
    it = iter(rgb_batches)
    for _ in range(iters):
        rgb = np.asarray(next(it))
        bayer = np.stack([bayer_mosaic(im) for im in rgb])
        rgb_chw = np.ascontiguousarray(rgb.transpose(0, 3, 1, 2))
        losses.append(step(params, torch.from_numpy(bayer).to(dev),
                           torch.from_numpy(rgb_chw).to(dev)))
    return params_to_numpy({"u": params})["u"], [float(x) for x in losses]


def dm_transfer(params, *, interval: int = 4, device=None) -> np.ndarray:
    """Cache the demosaic unit: (L**4, 12) int8 (3 channels x the 2x2
    cell), on `device` (None: the card)."""
    return cache_lut(params, interval=interval, dense=False, device=device)


def dm_lut_apply(lut: np.ndarray, bayer: np.ndarray, *, interval: int = 4,
                 device=None) -> np.ndarray:
    """Deploy the cached demosaic LUT: (H, W) uint8 bayer -> (H, W, 3)
    uint8.

    One integer simplex retrieval per non-overlapping 2x2 bayer cell (the
    DMNet unfold geometry, ref: common/network.py:296-317) on `device`
    (None: the card), as torch ops (no kernel: K1 has no 12-lane form);
    no rotation ensemble, the RGGB pattern not being rotation-invariant.
    The value mapping back to [0, 255] runs on the host in float64, as in
    the JAX package.  Odd H or W raise ValueError."""
    q = 2 ** interval
    if bayer.shape[0] % 2 or bayer.shape[1] % 2:
        raise ValueError(
            f"RGGB bayer input needs even H/W, got {bayer.shape[:2]}; "
            "crop the mosaic to even dimensions first"
        )
    dev = resolve_device(device, "dm_lut_apply")
    h2, w2 = bayer.shape[0] // 2, bayer.shape[1] // 2
    x = torch.from_numpy(bayer.astype(np.int32)).to(dev)
    planes = [x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]]
    acc = simplex_planes_int(
        torch.as_tensor(np.asarray(lut, np.int32), device=dev), planes,
        interval=interval)                        # (h2, w2, 12), q x value
    out = acc.cpu().numpy().astype(np.float64) / q   # tanh*127 domain
    out = np.clip(np.round(out), -127, 127)
    # invert the training mapping: (-1,1)*127 -> [0,255]
    out = np.clip(np.round((out / 127.0 + 1.0) / 2.0 * 255.0), 0, 255)
    # lanes are (C, py, px) PixelShuffle order: interleave the cell pixels
    out = out.reshape(h2, w2, 3, 2, 2)
    out = out.transpose(0, 3, 1, 4, 2)             # (h2, py, w2, px, C)
    return out.reshape(h2 * 2, w2 * 2, 3).astype(np.uint8)
