"""Deployment-grade evaluation on the card: LUT retrieval and net mode.

Torch twins of `mulut_tpu.pipelines.evaluate`:

- `LutEvaluator`: the packed cascade (`ops.tail_kernel.lut_cascade_packed`)
  at x4, the integer cascade (`ops.ensemble.lut_cascade_int`) at other
  scales and intervals, over the expanded int8 tables, byte-identical to
  the reference NumPy engine (ref: sr/4_test_lut.py:263-306), and its
  device YUV pipeline.  Replaces the reference's per-image process fan-out
  (ref: sr/4_test_lut.py:257-259) with the card's batch dimension; large
  images stream through row slabs (`band`), bucketed batches shard over
  several devices (`n_devices`).
- `NetEvaluator`, net mode: the trained tap-MLP units run directly (no LUT
  caching), in float32 (`models.srnet.srnets_predict`) or, with
  `fast=True`, in bf16 through one stage-ensemble kernel launch per stage
  (`models.srnet.srnets_predict_fast`), or with `quant` as W8A8 int8
  units (`ops.quant`) through the same forward; batches shard over
  several devices (`n_devices`).
- `eval_dataset`, `run_test` and `process_single_image`: the step-4 CLI's
  path into `LutEvaluator` (ref: sr/4_test_lut.py, sr/5_test_lut.py), on
  the card unless `device="cpu"` is given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import srnet
from ..models.srnet import (
    srnets_predict,
    srnets_predict_fast,
    srnets_predict_tiled,
    stack_srnets_for_fast,
)
from ..models.torch_import import (
    load_params_npz,
    params_from_numpy,
    srnets_params_from_torch,
)
from ..ops.ensemble import (
    KERNEL_FORMATS,
    lut_cascade_banded,
    lut_cascade_int,
    prepare_expanded_luts,
)
from ..ops.quant import quantize_srnets_for_fast
from ..ops.resize import bicubic_upscale, full_f32_matmul
from ..ops.tail_kernel import (
    lut_cascade_packed_banded,
    lut_cascade_u8,
    supports_tail_kernel,
)
from ..parallel.mesh import mesh_for, pad_batch, replicate_tree, shard_batch
from ..utils.imgio import load_image, save_image
from ..utils.lut_io import load_luts
from ..utils.metrics import _YCBCR_O, _YCBCR_T, modcrop, psnr_ssim_y


def _rgb_to_ycc(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB on the device -> float32 YCbCr, one float32
    matmul as the JAX package's HIGHEST-precision einsum (ref:
    sr/Test.py:317-398)."""
    dev = rgb.device
    T = torch.as_tensor(_YCBCR_T, dtype=torch.float32, device=dev)
    O = torch.as_tensor(_YCBCR_O, dtype=torch.float32, device=dev)
    with full_f32_matmul():
        return rgb.float() @ T.T + O


def _chroma_sr(ycc: torch.Tensor, scale: int):
    """The rounded Cb and Cr planes of `ycc`, bicubic-upscaled: two
    (B, H*s, W*s) float32 planes."""
    cbcr = torch.clamp(torch.round(ycc[..., 1:]), 0, 255)
    cbcr_sr = bicubic_upscale(cbcr.permute(0, 3, 1, 2), scale)
    return cbcr_sr[:, 0], cbcr_sr[:, 1]


def _ycc_to_rgb_einsum(y_sr: torch.Tensor, ycc: torch.Tensor,
                       scale: int) -> torch.Tensor:
    """(Y, Cb, Cr) - O times inv(T) as one float32 matmul, as the JAX
    package's `LutEvaluator` computes it (an einsum at HIGHEST precision;
    its `NetEvaluator` uses per-channel plane FMAs instead), rounded and
    clipped to (B, H*s, W*s, 3) uint8."""
    dev = ycc.device
    cb, cr = _chroma_sr(ycc, scale)
    O = torch.as_tensor(_YCBCR_O, dtype=torch.float32, device=dev)
    Ti = torch.as_tensor(np.linalg.inv(_YCBCR_T), dtype=torch.float32,
                         device=dev)
    with full_f32_matmul():
        rgb = (torch.stack([y_sr, cb, cr], dim=-1) - O) @ Ti.T
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


class LutEvaluator:
    """Holds the expanded LUTs on the device and runs the cascade.

    At x4 on s/d/y/e/h/o mode sets and intervals >= 4 it runs the packed
    cascade (`ops.tail_kernel.lut_cascade_packed`) over the JAX kernel
    path's table formats (`ops.ensemble.KERNEL_FORMATS`); at any other
    scale or interval the integer cascade (`ops.ensemble.lut_cascade_int`)
    over the JAX package's default formats.  Every contraction of either
    runs the window-read kernel K1.  `device=None` means the CUDA card (and
    raises where there is none); `device="cpu"` runs every kernel's plain
    torch version.

    `band > 0` runs the cascade over row slabs of `band` rows
    (`ops.tail_kernel.lut_cascade_packed_banded` on the packed path,
    `ops.ensemble.lut_cascade_banded` on the other), so an image above the
    untiled pixel cap streams with bounded temporaries into a uint8 output
    on the device; it composes with `bucket` through each slab's local
    valid extents, with the untiled cascade's bytes.  `upscale_yuv_batch`
    stays untiled and keeps its cap, as in the JAX package.

    `n_devices > 1` shards each bucketed dispatch (`upscale_many`) over
    the batch: the tables are replicated on each device of the mesh
    (`parallel.mesh.mesh_for`: on the card the first `n_devices` CUDA
    devices, clamped to the count; with `device="cpu"` that many CPU
    shards; or a list of devices given as `device`, all of it, with
    `n_devices` left None or equal to its length), the batch padded to a
    device multiple with replicas of its last image and cut into one
    shard per device; bytes equal to one device.  `n_devices=None` is one
    device, or the whole of a list.
    """

    #: Default cap on input pixels per dispatch (batch x Hb x Wb): the
    #: stage-2 contraction buffers hold ~1 KB per input pixel.
    MAX_BATCH_PIXELS = 8_000_000

    def __init__(self, luts: dict, *, stages: int, modes: str, scale: int,
                 interval: int = 4, bucket: int = 0, band: int = 0,
                 max_batch_pixels: int | None = None, n_devices: int | None = None,
                 device=None):
        self.stages = stages
        self.modes = modes
        self.scale = scale
        self.interval = interval
        self.bucket = bucket
        self.band = band
        self.max_batch_pixels = max_batch_pixels or self.MAX_BATCH_PIXELS
        self.mesh = mesh_for(device, n_devices, "LutEvaluator")
        self.n_devices = len(self.mesh)
        self.device = self.mesh[0]
        self.kernel = supports_tail_kernel(modes, scale, interval=interval)
        # built on the device from the ~4 MB of source LUTs
        tabs = prepare_expanded_luts(
            luts, interval=interval, device=self.device,
            **(KERNEL_FORMATS if self.kernel else {}))
        self._replicas = (replicate_tree(self.mesh, tabs)
                          if self.n_devices > 1 else [tabs])
        self.luts = self._replicas[0]

    def _untiled(self, img: torch.Tensor, valid_hw=None,
                 luts=None) -> torch.Tensor:
        """(..., H, W) uint8 on the device -> (..., H*scale, W*scale) uint8
        on the device, in one pass over the image (`luts`: a replica of the
        tables on img's device, default the first)."""
        luts = self.luts if luts is None else luts
        kw = dict(stages=self.stages, modes=self.modes, scale=self.scale,
                  interval=self.interval, valid_hw=valid_hw)
        if self.kernel:
            return lut_cascade_u8(luts, img, **kw)
        return lut_cascade_int(luts, img, expanded=True,
                               **kw).to(torch.uint8)

    def _cascade(self, img: torch.Tensor, valid_hw=None,
                 luts=None) -> torch.Tensor:
        """`_untiled`, over row slabs of `band` rows when band > 0."""
        if not self.band:
            return self._untiled(img, valid_hw, luts)
        luts = self.luts if luts is None else luts
        kw = dict(stages=self.stages, modes=self.modes, scale=self.scale,
                  interval=self.interval, band=self.band, valid_hw=valid_hw)
        if self.kernel:
            return lut_cascade_packed_banded(luts, img, **kw)
        return lut_cascade_banded(luts, img, expanded=True, **kw)

    def _exec(self, chw, valid_hw=None) -> np.ndarray:
        """One dispatch -> host uint8 (..., H*scale, W*scale);
        `valid_hw` as in `ops.ensemble.clamp_pad_region` (per-image vectors
        go to the device once, not at every stage or slab)."""
        img = torch.from_numpy(np.ascontiguousarray(chw)).to(self.device)
        if valid_hw is not None:
            valid_hw = tuple(v if np.ndim(v) == 0
                             else torch.as_tensor(v, device=self.device)
                             for v in valid_hw)
        return np.ascontiguousarray(
            self._cascade(img, valid_hw).cpu().numpy())

    def _exec_bucketed(self, buf, hs, ws) -> np.ndarray:
        """One bucketed dispatch -> host uint8 (..., Hb*scale, Wb*scale)."""
        return self._exec(buf, valid_hw=(hs, ws))

    @classmethod
    def from_folder(cls, lut_folder: str, *, stages: int = 2,
                    modes: str = "sdy", scale: int = 4, interval: int = 4,
                    lut_name: str = "LUT_ft", bucket: int = 0, band: int = 0,
                    n_devices: int | None = None, device=None):
        luts = load_luts(lut_folder, stages=stages, modes=modes, scale=scale,
                         interval=interval, name=lut_name)
        return cls(luts, stages=stages, modes=modes, scale=scale,
                   interval=interval, bucket=bucket, band=band,
                   n_devices=n_devices, device=device)

    def upscale(self, img_lr: np.ndarray) -> np.ndarray:
        """(H, W, C) or (H, W) uint8 LR -> upscaled uint8 SR (same rank).

        With `bucket > 0`, images are evaluated in a (ceil to bucket)-sized
        buffer with the pad region clamp-synchronized on the device, with
        bit-identical output.
        """
        if img_lr.ndim == 2:
            return self.upscale(img_lr[:, :, None])[:, :, 0]
        chw = img_lr.transpose(2, 0, 1)
        if not self.bucket:
            self._check_untiled_size(*chw.shape[-2:], chw.shape[0])
            out = self._exec(chw)
            return out.transpose(1, 2, 0).astype(np.uint8)
        h, w = chw.shape[-2:]
        bucket = self.bucket
        hb = -(-h // bucket) * bucket
        wb = -(-w // bucket) * bucket
        self._check_untiled_size(hb, wb, chw.shape[0])
        buf = np.pad(chw, [(0, 0), (0, hb - h), (0, wb - w)], mode="edge")
        out = self._exec_bucketed(
            buf, np.int32(h), np.int32(w)
        )[:, : h * self.scale, : w * self.scale]
        return out.transpose(1, 2, 0).astype(np.uint8)

    def upscale_batch(self, imgs_lr: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, H*scale, W*scale, 3) uint8 (one
        same-shape dispatch)."""
        out = self._exec(imgs_lr.transpose(0, 3, 1, 2))
        return out.transpose(0, 2, 3, 1).astype(np.uint8)

    def upscale_many(self, imgs_lr: list) -> list:
        """Mixed-size batch: ONE dispatch per bucket shape, with per-image
        valid (h, w) vectors.  Bit-identical to per-image `upscale`.
        Requires `bucket > 0`."""
        if not self.bucket:
            raise ValueError("upscale_many requires a bucket size")
        bucket, scale = self.bucket, self.scale
        groups: dict = {}
        for i, img in enumerate(imgs_lr):
            h, w = img.shape[:2]
            hb = -(-h // bucket) * bucket
            wb = -(-w // bucket) * bucket
            groups.setdefault((hb, wb), []).append(i)
        outs: list = [None] * len(imgs_lr)
        for (hb, wb), idxs in groups.items():
            self._check_untiled_size(hb, wb, 3)
            # chunk so one dispatch never exceeds the pixel cap
            per = max(1, self.max_batch_pixels // (hb * wb * 3))
            for c0 in range(0, len(idxs), per):
                chunk = idxs[c0: c0 + per]
                batch = np.stack([
                    np.pad(
                        imgs_lr[i].transpose(2, 0, 1),
                        [(0, 0),
                         (0, hb - imgs_lr[i].shape[0]),
                         (0, wb - imgs_lr[i].shape[1])],
                        mode="edge",
                    )
                    for i in chunk
                ])
                hs = np.asarray(
                    [imgs_lr[i].shape[0] for i in chunk], np.int32
                )
                ws = np.asarray(
                    [imgs_lr[i].shape[1] for i in chunk], np.int32
                )
                out = self._dispatch_bucketed(batch, hs, ws)
                for k, i in enumerate(chunk):
                    h, w = imgs_lr[i].shape[:2]
                    outs[i] = (
                        out[k, :, : h * scale, : w * scale]
                        .transpose(1, 2, 0).astype(np.uint8)
                    )
        return outs

    def _dispatch_bucketed(self, batch: np.ndarray, hs: np.ndarray,
                           ws: np.ndarray) -> np.ndarray:
        """One bucketed dispatch, sharded over the batch when n_devices > 1
        (the batch padded to a device multiple with replicas of its last
        image, which are cropped off the result)."""
        if self.n_devices == 1:
            return self._exec_bucketed(batch, hs, ws)
        n = batch.shape[0]
        shards = shard_batch(self.mesh, *(pad_batch(a, self.n_devices)
                                          for a in (batch, hs, ws)))
        outs = [self._cascade(b, (h, w), luts)
                for (b, h, w), luts in zip(shards, self._replicas)]
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    def upscale_yuv_batch(self, imgs_rgb: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, H*s, W*s, 3) uint8, one dispatch:
        RGB -> YCbCr, the cascade on the luma plane only, chroma as two
        bicubic matmuls, YCbCr -> RGB (ref: sr/Test.py:317-398), nothing
        back on the host in between."""
        h, w = imgs_rgb.shape[1:3]
        if h * w * imgs_rgb.shape[0] > self.max_batch_pixels:
            raise ValueError(
                f"YUV batch {imgs_rgb.shape[0]}x{h}x{w} exceeds the untiled "
                f"device-safe size ({self.max_batch_pixels} px); split the "
                "batch or raise max_batch_pixels explicitly")
        rgb = torch.from_numpy(np.ascontiguousarray(imgs_rgb)).to(
            self.device)
        ycc = _rgb_to_ycc(rgb)
        y = torch.clamp(torch.round(ycc[..., 0]), 0, 255).to(torch.uint8)
        y_sr = self._untiled(y[:, None])[:, 0].float()
        return _ycc_to_rgb_einsum(y_sr, ycc, self.scale).cpu().numpy()

    def upscale_yuv(self, img_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (H*s, W*s, 3) uint8 (see
        `upscale_yuv_batch`)."""
        return self.upscale_yuv_batch(img_rgb[None])[0]

    def _check_untiled_size(self, hb: int, wb: int, channels: int) -> None:
        """Refuse to run the untiled cascade past the pixel cap (banded
        slabs bound the temporaries: no cap with band > 0)."""
        if self.band:
            return
        if hb * wb * channels > self.max_batch_pixels:
            raise ValueError(
                f"image bucket {hb}x{wb} exceeds the untiled device-safe "
                f"size ({self.max_batch_pixels} px); pass band>0 "
                "(--evalBand) to stream it, or raise max_batch_pixels "
                "explicitly"
            )


class NetEvaluator:
    """Deploys the trained MuLUT network directly (no LUT caching).

    `fast=True` runs the tap-MLPs in bf16 through one stage-ensemble
    kernel launch per stage, the kernel that `models.srnet`'s flags pick
    at each call: for plain (mxu-arch) units the window kernel K3 by
    default, K6 with `PLAIN_WINDOW` off, or K8 under `PLAIN_LAYOUT =
    "site"` (its head per `ops.unit_kernel.PLAIN_HEAD`); for dense-concat
    units K4 by default, K5 or K7 under `DENSE_LAYOUT = "feature"`, or K9
    when MULUT_PAIRED_KERNEL=1 is set at construction.
    `quant` (implies `fast`; plain units only, else ValueError) quantizes
    the units to W8A8 at construction (`ops.quant`, calibrated from the
    float32 params) and runs the int8 kernel K11 per stage: True or "int"
    for the integer fixed-point requant, "f32" or "f32w6" for the float32
    one.  `fast=False` is the float32 forward (TF32 off), band-tiled above
    `TILE_THRESHOLD` input pixels.  `device=None` means the CUDA card (and
    raises where there is none); `device="cpu"` runs every kernel's plain
    torch version.  `params` is the JAX package's params layout, as NumPy
    arrays or tensors (`models.torch_import.params_from_numpy`).

    `n_devices > 1` shards `upscale_batch` and `upscale_yuv_batch` over
    the batch, the mesh as `LutEvaluator`'s (`parallel.mesh.mesh_for`):
    the weights replicated on each device, the batch padded to a device
    multiple with replicas of its last image, one shard per device through
    the same route (the same kernel on the card), the replicas cropped
    off; bytes equal to one device.
    """

    #: LR pixel count above which the f32 forward is band-tiled.
    TILE_THRESHOLD = 96 * 96
    BAND = 16

    def __init__(self, params: dict, *, stages: int, modes: str, scale: int,
                 fast: bool = False, quant: bool | str = False,
                 n_devices: int | None = None, device=None):
        self.stages = stages
        self.modes = modes
        self.scale = scale
        self.fast = fast = bool(fast or quant)
        self.mesh = mesh_for(device, n_devices, "NetEvaluator")
        self.n_devices = len(self.mesh)
        self.device = self.mesh[0]
        self.params = params_from_numpy(params, self.device)
        self.stacked = None
        if quant:
            self.stacked = quantize_srnets_for_fast(
                self.params, modes=modes, stages=stages, scale=scale,
                requant=quant if isinstance(quant, str) else "int")
        elif fast:
            # MULUT_PAIRED_KERNEL=1 selects the rotation-paired stacks
            # (kernel K9, dense units only), as in the JAX package
            self.stacked = stack_srnets_for_fast(
                self.params, modes=modes, stages=stages, scale=scale,
                paired=os.environ.get("MULUT_PAIRED_KERNEL", "0") == "1")
        self._plain = fast and not quant and any(
            "hwt" in st for st in self.stacked)
        weights = (self.params, self.stacked)
        self._replicas = (replicate_tree(self.mesh, weights)
                          if self.n_devices > 1 else [weights])
        self.params, self.stacked = self._replicas[0]

    @property
    def _luma_clip(self):
        """final_clip of the fused-YUV luma run (plain bf16 stacks only,
        else None): the kernel epilogue clips the luma plane and, at x4 on
        the feature-major routes, packs it; read at each call, as the JAX
        package reads PLAIN_LAYOUT."""
        if not self._plain:
            return None
        return ("pack" if srnet.PLAIN_LAYOUT == "feature" and self.scale == 4
                else True)

    @classmethod
    def from_checkpoint(cls, path: str, *, stages: int = 2,
                        modes: str = "sdy", scale: int = 4,
                        fast: bool = False, quant: bool | str = False,
                        n_devices: int | None = None, device=None):
        """From a `save_params_npz` registry (.npz) or a reference
        PyTorch checkpoint (.pth)."""
        if path.endswith(".npz"):
            params = load_params_npz(path)
        else:
            params = srnets_params_from_torch(path, modes=modes,
                                              stages=stages)
        return cls(params, stages=stages, modes=modes, scale=scale,
                   fast=fast, quant=quant, n_devices=n_devices, device=device)

    def _run(self, x: torch.Tensor, weights) -> torch.Tensor:
        """(B, C, H, W) float32 in [0, 1] -> float32 SR values, on
        `weights` (a replica of (params, stacked) on x's device)."""
        params, stacked = weights
        kw = dict(modes=self.modes, stages=self.stages, scale=self.scale)
        if self.fast:
            return srnets_predict_fast(stacked, x, **kw).float()
        return srnets_predict(params, x, **kw)

    def _forward(self, x: torch.Tensor, weights) -> torch.Tensor:
        """`_run`, band-tiled on the f32 path for large inputs (along
        whichever spatial axis is long enough).  The fast path holds no
        per-site activations in memory and never tiles."""
        h, w = x.shape[-2:]
        min_dim = self.BAND + 8
        if (not self.fast and h * w > self.TILE_THRESHOLD
                and max(h, w) >= min_dim):
            return srnets_predict_tiled(
                weights[0], x, modes=self.modes, stages=self.stages,
                scale=self.scale, band=self.BAND,
                axis=2 if h >= min_dim else 3)
        return self._run(x, weights)

    def _sharded(self, fn, imgs: np.ndarray) -> np.ndarray:
        """`fn(batch on a device, weights there)` over the batch, one shard
        per device of the mesh (padded with replicas of the last image,
        cropped off) -> host array."""
        n = imgs.shape[0]
        if self.n_devices > 1:
            imgs = pad_batch(imgs, self.n_devices)
        shards = shard_batch(self.mesh, np.ascontiguousarray(imgs))
        outs = [fn(x, w) for x, w in zip(shards, self._replicas)]
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    def upscale(self, img_lr: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 LR -> (H*scale, W*scale, 3) uint8 SR."""
        return self.upscale_batch(img_lr[None])[0]

    def _rgb(self, imgs: torch.Tensor, weights) -> torch.Tensor:
        x = imgs.permute(0, 3, 1, 2).float() / 255.0
        out = torch.round(torch.clamp(self._forward(x, weights), 0, 255))
        return out.to(torch.uint8).permute(0, 2, 3, 1).contiguous()

    def upscale_batch(self, imgs_lr: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, H*scale, W*scale, 3) uint8 (one
        same-shape dispatch per device; channels and batch ride the
        leading axes)."""
        return self._sharded(self._rgb, imgs_lr)

    def _yuv(self, rgb: torch.Tensor, weights) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB on the device -> (B, H*s, W*s, 3) uint8:
        luma through the cascade, chroma as two bicubic matmuls, the color
        transforms as per-channel plane FMAs (ref: sr/Test.py:317-398)."""
        Ti = np.linalg.inv(_YCBCR_T)
        ycc = _rgb_to_ycc(rgb)
        y = torch.clamp(torch.round(ycc[..., 0]), 0, 255)
        # XLA's jitted `y / 255.0` is a multiply by float32(1/255)
        x = y[:, None] * float(np.float32(1 / 255))
        if self._luma_clip is not None:
            y_sr = srnets_predict_fast(
                weights[1], x, modes=self.modes, stages=self.stages,
                scale=self.scale, final_clip=self._luma_clip)[:, 0].float()
        else:
            y_sr = torch.clamp(torch.round(self._forward(x, weights)[:, 0]),
                               0, 255)
        cb, cr = _chroma_sr(ycc, self.scale)
        chans = []
        for o in range(3):
            c = [float(np.float32(a)) for a in
                 (Ti[o, 0], Ti[o, 1], Ti[o, 2], -(Ti[o] @ _YCBCR_O))]
            plane = y_sr * c[0] + cb * c[1] + cr * c[2] + c[3]
            chans.append(torch.clamp(torch.round(plane), 0, 255)
                         .to(torch.uint8))
        return torch.stack(chans, dim=-1)

    def upscale_yuv_batch(self, imgs_rgb: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, H*s, W*s, 3) uint8: the device
        YUV pipeline, one dispatch per device; the cascade sees one plane
        of three."""
        return self._sharded(self._yuv, imgs_rgb)

    def upscale_yuv(self, img_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (H*s, W*s, 3) uint8 (see
        `upscale_yuv_batch`)."""
        return self.upscale_yuv_batch(img_rgb[None])[0]


def eval_dataset(evaluator: LutEvaluator, test_dir: str, dataset: str,
                 result_path: str | None = None, *, lut_name: str = "LUT_ft",
                 interval: int = 4):
    """Evaluate one benchmark dataset; save result PNGs; return per-image
    (psnr, ssim) (ref: sr/4_test_lut.py:240-316, fixed LR path per
    sr/5_test_lut.py:527).  Runs where `evaluator` runs."""
    scale = evaluator.scale
    hr_dir = os.path.join(test_dir, dataset, "HR")
    lr_dir = os.path.join(test_dir, dataset, f"LR_bicubic/X{scale}")
    files = sorted(os.listdir(hr_dir))

    imgs_lr = [load_image(os.path.join(lr_dir, f)) for f in files]
    gts = [modcrop(load_image(os.path.join(hr_dir, f)), scale) for f in files]
    if getattr(evaluator, "bucket", 0):
        # whole-dataset batched dispatch: one dispatch per bucket shape
        # instead of the reference's per-image Pool(24) fan-out
        outs = evaluator.upscale_many(imgs_lr)
    else:
        outs = [evaluator.upscale(img) for img in imgs_lr]

    results = []
    for f, img_gt, img_out in zip(files, gts, outs):
        if result_path is not None:
            save_image(
                os.path.join(
                    result_path, f"{f[:-4]}_{lut_name}_{8 - interval}bit.png"
                ),
                img_out,
            )
        results.append(psnr_ssim_y(img_gt, img_out, scale))
    return results


def run_test(opt, datasets=("Set5",), device=None) -> dict:
    """Step-4 CLI behavior: load LUTs, evaluate datasets, print summary.
    Runs on `device`, default `opt.device` (the `--device` flag), and on
    the card when both are None."""
    if device is None:
        device = getattr(opt, "device", None)
    evaluator = LutEvaluator.from_folder(
        opt.expDir, stages=opt.stages, modes=opt.modes, scale=opt.scale,
        interval=opt.interval, lut_name=opt.lutName,
        bucket=getattr(opt, "evalBucket", 0),
        band=getattr(opt, "evalBand", 0),
        n_devices=getattr(opt, "gpuNum", 1),
        device=device,
    )
    exp_name = opt.expDir.rstrip("/").split("/")[-1]
    summary = {}
    for dataset in datasets:
        result_path = os.path.join(
            opt.resultRoot, exp_name, dataset, f"X{opt.scale}"
        )
        os.makedirs(result_path, exist_ok=True)
        results = eval_dataset(
            evaluator, opt.testDir, dataset, result_path,
            lut_name=opt.lutName, interval=opt.interval
        )
        arr = np.asarray(results)
        print(
            "Dataset {} | AVG LUT PSNR: {:.2f} SSIM: {:.4f}".format(
                dataset, arr[:, 0].mean(), arr[:, 1].mean()
            )
        )
        summary[dataset] = (float(arr[:, 0].mean()), float(arr[:, 1].mean()))
    return summary


def process_single_image(image_path: str, lut_folder: str, output_path: str | None
                         = None, *, stages: int = 2, modes: str = "sdy",
                         scale: int = 4, interval: int = 4,
                         lut_name: str = "LUT_ft", gt_path: str | None = None,
                         device=None):
    """Single-image API (ref: sr/5_test_lut.py:241-414), on `device`
    (None: the card).

    Returns (sr_image, metrics_or_None); metrics = (psnr, ssim) when gt given.
    """
    evaluator = LutEvaluator.from_folder(
        lut_folder, stages=stages, modes=modes, scale=scale,
        interval=interval, lut_name=lut_name, device=device
    )
    img_lr = load_image(image_path)
    img_out = evaluator.upscale(img_lr)
    if output_path:
        save_image(output_path, img_out)
    metrics = None
    if gt_path:
        img_gt = modcrop(load_image(gt_path), scale)
        metrics = psnr_ssim_y(img_gt, img_out, scale)
    return img_out, metrics
