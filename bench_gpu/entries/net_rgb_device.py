"""Entry `net_rgb_device`: net mode through `NetEvaluator(fast=True)` on
RGB frames that already sit on the device, as a GPU video pipeline that
decodes, upscales and encodes on the card drives it.

Set-up hands the configuration's units (`weights.py`: drawn from the
seed, or the npz) to `NetEvaluator`, which builds the bf16 stacks of the
stage-ensemble kernel (K4 for dense units).  A batch is one call of the
evaluator's RGB path, `upscale_batch` without its host copies
(`NetEvaluator._rgb`: to [0, 1], the stages, round and clamp), on a (B,
H, W, 3) uint8 batch, ended by a synchronize; its (B, H*s, W*s, 3) uint8
result stays on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_gpu import weights


class Runner:
    def __init__(self, cfg: dict, traffic: dict, device, span, root,
                 seed):
        from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

        self.device, self.span = device, span
        units = weights.units(cfg, seed, root, device)
        t0 = time.perf_counter()
        self.ev = NetEvaluator(units, stages=cfg["stages"],
                               modes=cfg["modes"], scale=cfg["scale"],
                               fast=True, device=device)
        _sync(device)
        self.init_s = time.perf_counter() - t0
        self._weights = (self.ev.params, self.ev.stacked)

    def inputs(self, batches: list) -> list:
        """Each host batch as a (B, H, W, 3) uint8 tensor on the device."""
        return [torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
                for b in batches]

    def run(self, x):
        with self.span("call"):
            out = self.ev._rgb(x, self._weights)
        with self.span("sync"):
            _sync(self.device)
        return out

    def result(self, out) -> np.ndarray:
        return out.cpu().numpy()

    def state(self):
        return None

    def close(self):
        self.ev = self._weights = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg, traffic, device, span, root, seed):
    if traffic["placement"] != "device":
        raise ValueError("net_rgb_device takes frames on the device")
    return Runner(cfg, traffic, device, span, root, seed)
