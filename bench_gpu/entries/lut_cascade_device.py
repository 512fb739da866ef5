"""Entry `lut_cascade_device`: the packed LUT cascade on frames that
already sit on the device, as a GPU video pipeline that decodes, upscales
and encodes on the card drives it.

Set-up caches the configuration's units (`weights.py`) into int8 tables
(`pipelines.transfer.transfer_to_luts`) and builds `LutEvaluator`, which
prepares the expanded tables on the device; the check compares the
tables (`state`).  A batch is one call of
`ops.tail_kernel.lut_cascade_u8(ev.luts, x, ...)` on a (B, 3, H, W) uint8
batch, ended by a synchronize; its result stays on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_gpu import weights


class Runner:
    def __init__(self, cfg: dict, traffic: dict, device, span, root,
                 seed):
        from mulut_tpu_torch.ops.tail_kernel import lut_cascade_u8
        from mulut_tpu_torch.pipelines.evaluate import LutEvaluator
        from mulut_tpu_torch.pipelines.transfer import transfer_to_luts

        self.device, self.span = device, span
        self.kw = dict(stages=cfg["stages"], modes=cfg["modes"],
                       scale=cfg["scale"], interval=cfg["interval"])
        self._cascade = lut_cascade_u8
        params = weights.units(cfg, seed, root, device)
        t0 = time.perf_counter()
        self.tables = transfer_to_luts(
            params, modes=cfg["modes"], stages=cfg["stages"],
            interval=cfg["interval"], device=device)
        self.ev = LutEvaluator(self.tables, **self.kw, device=device)
        _sync(device)
        self.init_s = time.perf_counter() - t0

    def inputs(self, batches: list) -> list:
        """Each host batch as a (B, 3, H, W) uint8 tensor on the device."""
        return [torch.from_numpy(np.ascontiguousarray(
            b.transpose(0, 3, 1, 2))).to(self.device) for b in batches]

    def run(self, x):
        with self.span("call"):
            out = self._cascade(self.ev.luts, x, **self.kw)
        with self.span("sync"):
            _sync(self.device)
        return out

    def result(self, out) -> np.ndarray:
        """(B, H*s, W*s, 3) uint8 on the host."""
        return out.permute(0, 2, 3, 1).cpu().numpy()

    def state(self):
        return self.tables

    def close(self):
        self.ev = self.tables = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg, traffic, device, span, root, seed):
    if traffic["placement"] != "device":
        raise ValueError("lut_cascade_device takes frames on the device")
    return Runner(cfg, traffic, device, span, root, seed)
