"""The LUT-as-model: differentiable MuLUT cascade for STE fine-tuning.

Torch twin of `mulut_tpu.models.lut_model`.  The cached int8 LUTs become
float32 trainable tensors (entries / 127); the forward pass is the full
stage x mode x rotation cascade through the differentiable simplex
interpolation with straight-through rounding at every quantization point
(ref: sr/model.py:39-312).  Forward values equal the JAX package's jitted
ones: every summand is an integer-valued float, and the stage mixes take
XLA's fused form (`ops.simplex.div_add`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.ensemble import _pad_all
from ..ops.simplex import (
    clip,
    div_add,
    expand_weight,
    round_ste,
    simplex_planes_expanded_diff,
)
from ..ops.taps import lane_rotation_perm, mode_pad, rotated_taps
from ..ops.unit_kernel import _INV255
from ..utils.device import resolve_device
from ..utils.lut_io import lut_filename


def init_lut_weights_from_folder(lut_folder: str, *, stages: int, modes: str,
                                 upscale: int = 4, interval: int = 4,
                                 name: str = "LUT", device=None) -> dict:
    """Load cached LUTs as float32 trainables on `device` (None: the card)
    (ref: sr/model.py:49-57).

    Reads `{name}_x{upscale}_{interval}bit_int8_s{stage}_{mode}.npy` — the
    transfer step's naming (interval-bit, not 8-interval).
    """
    luts = {}
    for s in range(stages):
        for mode in modes:
            path = os.path.join(
                lut_folder, lut_filename(name, upscale, interval, s + 1, mode))
            luts[f"s{s + 1}_{mode}"] = np.load(path)
    return init_lut_weights_from_arrays(luts, stages=stages, modes=modes,
                                        upscale=upscale, device=device)


def init_lut_weights_from_arrays(luts: dict, *, stages: int, modes: str,
                                 upscale: int, device=None) -> dict:
    """int8 tables {"s{stage}_{mode}": (L**4, v)} -> float32 trainables
    (entries / 127) on `device` (None: the card)."""
    dev = resolve_device(device, "init_lut_weights_from_arrays")
    weights = {}
    for s in range(stages):
        stage = s + 1
        scale = upscale if stage == stages else 1
        for mode in modes:
            key = f"s{stage}_{mode}"
            arr = np.asarray(luts[key]).reshape(-1, scale * scale)
            weights[key] = torch.as_tensor(
                arr.astype(np.float32) / 127.0, device=dev)
    return weights


#: i / 255 in float32, correctly rounded, for every uint8 pixel i: the
#: cascade's `x * 255` gives i back exactly (a multiply by float32(1/255),
#: which CUDA's division by a scalar runs, does not for every i).
_UNIT_PIXELS = np.arange(256, dtype=np.float32) / np.float32(255)


def unit_pixels(im: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 i / 255, correctly rounded on every device
    (a 256-entry table), the input `lut_model_forward` takes."""
    table = torch.as_tensor(_UNIT_PIXELS, device=im.device)
    return table[im.to(torch.int64)]


def lut_model_forward(weights: dict, x: torch.Tensor, *, modes: str,
                      stages: int, upscale: int, interval: int = 4,
                      device=None) -> torch.Tensor:
    """Differentiable cascade forward (ref: sr/model.py:289-312).

    Args:
      weights: {"s{stage}_{mode}": (L**4, v) float32} trainable LUTs.
      x: (B, C, H, W) float32 in [0, 1].
      device: where it runs (None: the card); tensors are moved there.

    Returns (B, C, H*upscale, W*upscale) float32 in [0, 1].  Note the
    reference STE-rounds the accumulated `pred` after *every* rotation
    addition (ref: sr/model.py:305-308) — replicated exactly.
    """
    dev = resolve_device(device, "lut_model_forward")
    x = x.to(dev) * 255.0
    for s in range(stages):
        stage = s + 1
        if stage == stages:
            avg_factor, bias, scale = len(modes), 0.0, upscale
        else:
            avg_factor, bias, scale = len(modes) * 4, 127.0, 1
        # Rotated tap offsets on an all-sides padded image + lane
        # un-rotation, never rot90-ing tensors; rounding is elementwise, so
        # the lane-space accumulation keeps the reference's order.  Each
        # mode's LUT is corner-expanded in-graph (expand_weight): one wide
        # row gather per tapset in place of five.
        pred = 0.0
        h, w_ = x.shape[-2], x.shape[-1]
        v = scale * scale
        for mode in modes:
            pad = mode_pad(mode)
            w = weights[f"s{stage}_{mode}"].to(dev)
            w127 = clip(round_ste(w * 127.0), -127.0, 127.0)
            e127 = expand_weight(w127, interval=interval)
            xp = _pad_all(x, pad)
            for r in range(4):
                planes = [
                    xp[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w_]
                    for dy, dx in rotated_taps(mode, r)
                ]
                out = simplex_planes_expanded_diff(e127, planes, v=v,
                                                   interval=interval)
                if scale > 1 and r:
                    perm = torch.as_tensor(lane_rotation_perm(scale, r),
                                           device=dev)
                    out = out[..., perm]
                pred = round_ste(pred + out)
        pred = round_ste(clip(div_add(pred, avg_factor, bias), 0.0, 255.0))
        if scale > 1:
            B, C = pred.shape[0], pred.shape[1]
            pred = pred.reshape(B, C, h, w_, scale, scale)
            pred = torch.movedim(pred, -2, -3)
            x = pred.reshape(B, C, h * scale, w_ * scale)
        else:
            x = pred[..., 0]
    return x * _INV255


def export_lut_weights(weights: dict) -> dict:
    """Trainable floats -> int8 NumPy arrays: round(clip(w, -1, 1) * 127)
    (ref: sr/3_finetune_lut.py:162-169)."""
    return {
        k: np.round(np.clip(torch.as_tensor(w).detach().cpu().numpy(), -1, 1)
                    * 127).astype(np.int8)
        for k, w in weights.items()
    }
