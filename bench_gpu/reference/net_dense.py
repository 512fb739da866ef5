"""Net mode with dense-concat MuLUT units (configuration kind
`net_dense`): the float32 network of `net.py` on every channel.

Compared: the output bytes (the program computes in bf16).  The control
is the same network with every matmul's operands in float8 e4m3, the
next precision down, in the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from .net import upscale_rgb


def _kw(cfg: dict) -> dict:
    return dict(stages=cfg["stages"], modes=cfg["modes"], scale=cfg["scale"],
                dense=cfg["unit"] == "dense")


class Reference:
    def __init__(self, cfg: dict, seed: int, root, device):
        self.cfg, self.device = cfg, device
        self.units = weights.units(cfg, seed, root, device)

    def outputs(self, frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        return upscale_rgb(self.units, x, **_kw(self.cfg)).cpu().numpy()

    def state_readings(self, program_state) -> dict:
        return {}


class Control:
    """The reference network at fp8, driven as the entry `net_rgb_device`
    drives the program: (B, H, W, 3) uint8 frames on the device in and
    out."""

    def __init__(self, cfg, traffic, device, span, root, seed):
        self.cfg, self.device = cfg, device
        t0 = time.perf_counter()
        self.units = weights.units(cfg, seed, root, device)
        self.init_s = time.perf_counter() - t0

    def inputs(self, batches):
        return [torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
                for b in batches]

    def run(self, x):
        return upscale_rgb(self.units, x, **_kw(self.cfg), fmt="fp8")

    def result(self, out):
        return out.cpu().numpy()

    def state(self):
        return None

    def close(self):
        self.units = None
