"""MuLUT's network deployed directly (`sr/model.py` SRNets, eval phase).

Per stage, mode and rotation the unit runs on the rotated, bottom/right
padded image; its output times 127 is rounded and summed over rotations
and modes.  An inner stage mixes as round(clamp(pred / 4M + 127, 0,
255)) / 255; the last as round(pred / M).  Float32 throughout, but for
the matmuls of `fmt="fp8"` (`common.apply_unit`).
"""

from __future__ import annotations

import torch

from .common import apply_unit, exact_f32, rotation_ensemble


def srnets(units: dict, x: torch.Tensor, *, stages: int, modes: str,
           scale: int, dense: bool, fmt: str = "f32") -> torch.Tensor:
    """(B, C, H, W) float32 in [0, 1] -> (B, C, H*scale, W*scale) float32
    (the last stage's round(pred / M), not clamped)."""
    exact_f32()
    M = len(modes)
    with torch.no_grad():
        for s in range(stages):
            last = s + 1 == stages
            up = scale if last else 1
            pred = None
            for mode in modes:
                unit = units[f"s{s + 1}_{mode}"]

                def lanes(t4, unit=unit):
                    out = apply_unit(unit, t4.reshape(-1, 4), dense=dense,
                                     fmt=fmt)
                    out = torch.round(out * 127.0)
                    return out.reshape(*t4.shape[:-1], out.shape[-1])

                acc = rotation_ensemble(x, mode, up, lanes)
                pred = acc if pred is None else pred + acc
            if last:
                x = torch.round(pred / M)
            else:
                x = torch.round(torch.clamp(pred / (4 * M) + 127, 0, 255))
                x = x / 255.0
    return x


def upscale_rgb(units: dict, frames: torch.Tensor, *, stages: int,
                modes: str, scale: int, dense: bool, fmt: str = "f32",
                frames_per_block: int = 2):
    """(B, H, W, 3) uint8 -> (B, H*s, W*s, 3) uint8, in blocks of frames."""
    outs = []
    for f0 in range(0, frames.shape[0], frames_per_block):
        x = frames[f0: f0 + frames_per_block].permute(0, 3, 1, 2)
        y = srnets(units, x.float() / 255.0, stages=stages, modes=modes,
                   scale=scale, dense=dense, fmt=fmt)
        y = torch.round(torch.clamp(y, 0, 255)).to(torch.uint8)
        outs.append(y.permute(0, 2, 3, 1))
    return torch.cat(outs)
