"""MuLUT's LUT path (configuration kind `lut`): cache the units into 4-D
tables, then retrieve.

`transfer` follows `sr/2_transfer_to_lut.py`: the 17**4 lattice
(0, 16, ..., 240, 255) / 255 through each unit, round(clamp(out, -1, 1) *
127) as int8.  `cascade` follows `sr/4_test_lut.py`: per stage, mode and
rotation a 4-D simplex interpolation (the corners walked in the order of
the fractions, sorted from the largest; ties give the corners between
them zero weight, so the order among equals does not matter), the sums
divided by q, mixed as clip(pred / avg + bias, 0, 255) in float64 and
rounded half to even.

Compared: `table_off`, the entries of the program's tables that differ
from the reference's, and the output bytes.  The control is the same
cascade over the reference's tables cut to int4.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from .common import apply_unit, exact_f32, rotation_ensemble


def lattice(interval: int, device) -> torch.Tensor:
    q = 2 ** interval
    base = torch.arange(0, 257, q, dtype=torch.float32, device=device)
    base[-1] -= 1
    L = base.numel()
    idx = torch.cartesian_prod(*[torch.arange(L, device=device)] * 4)
    return base[idx] / 255.0


def transfer(units: dict, *, interval: int, dense: bool, device) -> dict:
    """{unit: (L**4, v) int8 table} of every unit."""
    exact_f32()
    grid = lattice(interval, device)
    tables = {}
    with torch.no_grad():
        for name, unit in units.items():
            out = apply_unit(unit, grid, dense=dense)
            tables[name] = torch.round(torch.clamp(out, -1, 1) * 127).to(
                torch.int8)
    return tables


def simplex(table: torch.Tensor, t4: torch.Tensor, interval: int):
    """(..., 4) int64 taps -> (..., v) int64: sum of the five corner rows
    of the taps' simplex, each weighted by a difference of the sorted
    fractions (q times the reference's float output)."""
    q = 2 ** interval
    L = 2 ** (8 - interval) + 1
    stride = torch.tensor([L ** 3, L ** 2, L, 1], device=t4.device)
    base = ((t4 // q) * stride).sum(-1)
    frac, order = torch.sort(t4 % q, dim=-1, descending=True, stable=True)
    offs = torch.cumsum(stride[order], dim=-1)
    weights = [q - frac[..., 0]] + [frac[..., k] - frac[..., k + 1]
                                    for k in range(3)] + [frac[..., 3]]
    corners = [base] + [base + offs[..., k] for k in range(4)]
    tab = table.to(torch.int64)
    out = None
    for w, c in zip(weights, corners):
        term = w[..., None] * tab[c]
        out = term if out is None else out + term
    return out


def cascade(tables: dict, img: torch.Tensor, *, stages: int, modes: str,
            scale: int, interval: int, frames_per_block: int = 2):
    """(B, C, H, W) uint8 -> (B, C, H*scale, W*scale) uint8, in blocks of
    frames."""
    outs = []
    for f0 in range(0, img.shape[0], frames_per_block):
        outs.append(_cascade(tables, img[f0: f0 + frames_per_block],
                             stages=stages, modes=modes, scale=scale,
                             interval=interval))
    return torch.cat(outs)


def _cascade(tables, img, *, stages, modes, scale, interval):
    q = 2 ** interval
    x = img.to(torch.int64)
    for s in range(stages):
        last = s + 1 == stages
        up = scale if last else 1
        avg, bias = (len(modes), 0) if last else (4 * len(modes), 127)
        pred = None
        for mode in modes:
            tab = tables[f"s{s + 1}_{mode}"]
            acc = rotation_ensemble(
                x, mode, up, lambda t4, tab=tab: simplex(tab, t4, interval))
            pred = acc if pred is None else pred + acc
        mixed = torch.clamp(pred.to(torch.float64) / q / avg + bias, 0, 255)
        x = torch.round(mixed).to(torch.int64)
    return x.to(torch.uint8)


def int4_tables(tables: dict) -> dict:
    """The tables at int4 precision (16 levels of step 16)."""
    return {k: (torch.clamp(torch.round(t.float() / 16), -8, 7) * 16).to(
        torch.int8) for k, t in tables.items()}


def reference_tables(cfg: dict, seed: int, root, device) -> dict:
    return transfer(weights.units(cfg, seed, root, device),
                    interval=cfg["interval"], dense=cfg["unit"] == "dense",
                    device=device)


def _kw(cfg: dict) -> dict:
    return dict(stages=cfg["stages"], modes=cfg["modes"], scale=cfg["scale"],
                interval=cfg["interval"])


class Reference:
    def __init__(self, cfg: dict, seed: int, root, device):
        self.cfg, self.device = cfg, device
        self.tables = reference_tables(cfg, seed, root, device)

    def outputs(self, frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(
            frames.transpose(0, 3, 1, 2))).to(self.device)
        out = cascade(self.tables, x, **_kw(self.cfg))
        return out.permute(0, 2, 3, 1).cpu().numpy()

    def state_readings(self, program_tables) -> dict:
        if program_tables is None:
            return {}
        return {"table_off": sum(
            int(np.count_nonzero(np.asarray(program_tables[k])
                                 != t.cpu().numpy()))
            for k, t in self.tables.items())}


class Control:
    """The reference cascade over int4 tables in the program's place,
    driven as the entry `lut_cascade_device` drives the program."""

    def __init__(self, cfg, traffic, device, span, root, seed):
        self.cfg, self.device = cfg, device
        t0 = time.perf_counter()
        self.tables = int4_tables(reference_tables(cfg, seed, root, device))
        self.init_s = time.perf_counter() - t0

    def inputs(self, batches):
        return [torch.from_numpy(np.ascontiguousarray(
            b.transpose(0, 3, 1, 2))).to(self.device) for b in batches]

    def run(self, x):
        return cascade(self.tables, x, **_kw(self.cfg))

    def result(self, out):
        return out.permute(0, 2, 3, 1).cpu().numpy()

    def state(self):
        return {k: v.cpu().numpy() for k, v in self.tables.items()}

    def close(self):
        self.tables = None
