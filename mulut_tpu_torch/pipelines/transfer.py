"""Step 2: exhaustively cache the trained network into 4-D LUTs.

Torch twin of `mulut_tpu.pipelines.transfer`.  The reference enumerates
the 17**4 uniform grid as tiny images and runs the spatial model in 100
GPU chunks (ref: sr/2_transfer_to_lut.py:12-110).  In the tap-MLP
formulation the spatial wrapper is the identity for a single site, so
caching one LUT is one (L**4, 4) @ MLP forward, float32 with TF32 off
(`models.blocks.apply_mulut_unit`), then round(clamp(out, -1, 1) * 127).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.blocks import apply_mulut_unit
from ..models.torch_import import params_from_numpy
from ..utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def lut_grid(interval: int = 4) -> np.ndarray:
    """All 4-tap combinations in LUT row order, normalized to [0, 1].

    Row n = (base[ia], base[ib], base[ic], base[id]) / 255 with
    n = ia*L^3 + ib*L^2 + ic*L + id and base = (0, q, 2q, ..., 255)
    (ref: sr/2_transfer_to_lut.py:12-42 — the last grid point is 256-1 so
    MSB bin 16 is sampled at pixel value 255).
    """
    q = 2 ** interval
    base = np.arange(0, 257, q, dtype=np.int64)
    base[-1] -= 1
    L = base.size
    idx = np.indices((L, L, L, L)).reshape(4, -1).T  # lexicographic
    vals = base[idx].astype(np.float32) / 255.0
    return vals  # (L**4, 4)


def cache_lut(unit_params: dict, *, interval: int = 4,
              dense: bool | None = None, device=None) -> np.ndarray:
    """One unit -> int8 LUT (L**4, out_dim): round(clamp(out, -1, 1) * 127)
    (ref: sr/2_transfer_to_lut.py:108-109), computed on `device` (None:
    the card).

    `unit_params` holds NumPy arrays or tensors.  `dense` defaults to None =
    inferred from the parameter shapes (`blocks.unit_layout`): LUT caching
    is architecture-blind (4 taps in, out_dim lanes out), so dense units
    and plain (mxu-arch) units cache through the same call."""
    dev = resolve_device(device, "cache_lut")
    unit = params_from_numpy({"u": unit_params}, dev)["u"]
    grid = torch.as_tensor(lut_grid(interval), device=dev)
    with torch.no_grad():
        out = apply_mulut_unit(unit, grid, dense=dense)
        out = torch.round(torch.clamp(out, -1.0, 1.0) * 127.0)
    return out.cpu().numpy().astype(np.int8)


def transfer_to_luts(params: dict, *, modes: str, stages: int,
                     interval: int = 4, device=None) -> dict:
    """Cache every stage x mode unit: {"s{stage}_{mode}": (L**4, v) int8}."""
    dev = resolve_device(device, "transfer_to_luts")
    return {f"s{s + 1}_{mode}": cache_lut(params[f"s{s + 1}_{mode}"],
                                          interval=interval, device=dev)
            for s in range(stages) for mode in modes}
