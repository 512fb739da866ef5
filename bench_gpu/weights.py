"""The units of a configuration, which the program and the reference are
both handed: read from the npz that the configuration names, or, where it
names `"seed"`, drawn from the run's seed on the device.

Drawn units start from MuLUT's initialisation (`common/network.py`):
Kaiming normal weights (gain sqrt(2), fan-in), zero biases, all from one
call of a `torch.Generator` on the device, in float32, split in the order
stage, mode, layer.  Untrained, such a network sums signs at random: its
output clamps to 0 on much of a frame, on some seeds on all of it, and a
check of its bytes would judge nothing.  So each unit's output layer
(`w6`, `b6`) is then fitted, by ridge regression in float64 on the host
over a 9**4 lattice of taps, to the value that makes the whole network
upscale by nearest neighbour: the hidden layers stay as drawn, and no
shape or operation changes.  The same seed on the same device gives the
same units, so the reference draws its own copy after the window.
"""

from __future__ import annotations

import numpy as np
import torch

#: the lattice of taps the output layers are fitted over, and the ridge
FIT_LEVELS = 9
FIT_RIDGE = 1e-2
#: tanh targets are kept inside (-TANH_CLIP, TANH_CLIP)
TANH_CLIP = 0.98


def unit_shapes(nf: int, depth: int, v: int, dense: bool) -> dict:
    """{name: (rows, cols)} of one unit's weights; each `w<i>` has the
    bias `b<i>` of its columns.  The k-th hidden layer of a dense-concat
    unit reads the concat of the head and all k - 1 layers before it."""
    shapes = {"w1": (4, nf)}
    for k in range(1, depth + 1):
        shapes[f"w{k + 1}"] = (k * nf if dense else nf, nf)
    shapes["w6"] = ((depth + 1) * nf if dense else nf, v)
    return shapes


def load_npz(path: str) -> dict:
    """npz `"s{stage}_{mode}/{name}"` arrays -> {unit: {name: array}}."""
    units: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            unit, name = key.split("/")
            units.setdefault(unit, {})[name] = np.asarray(flat[key],
                                                          np.float32)
    return units


def draw(cfg: dict, seed: int, device) -> dict:
    """{unit: {name: float32 tensor on `device`}} from `seed`."""
    dense = cfg["unit"] == "dense"
    layout = []
    for s in range(cfg["stages"]):
        v = cfg["scale"] ** 2 if s + 1 == cfg["stages"] else 1
        for mode in cfg["modes"]:
            layout.append((f"s{s + 1}_{mode}",
                           unit_shapes(cfg["nf"], cfg["depth"], v, dense)))
    total = sum(r * c for _, shapes in layout for r, c in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    units, at = {}, 0
    for name, shapes in layout:
        unit = {}
        for w, (r, c) in shapes.items():
            std = (2.0 / r) ** 0.5
            unit[w] = flat[at: at + r * c].view(r, c) * std
            unit["b" + w[1:]] = torch.zeros(c, device=device)
            at += r * c
        last = name.startswith(f"s{cfg['stages']}_")
        _fit_output(unit, dense, _target_tanh(len(cfg["modes"]), last))
        units[name] = unit
    return units


def _target_tanh(n_modes: int, last: bool):
    """Each unit's tanh output that makes its stage give the centre tap's
    pixel p (in [0, 1]) back, as 0-255 levels: an inner stage mixes as
    sum(127 t) / (4 M) + 127, the last as sum(127 t) / M over the 4 M
    terms of the rotations and modes."""
    if last:
        return lambda p: 255.0 * p / (4 * 127)
    return lambda p: (255.0 * p - 127) / 127


def _fit_output(unit: dict, dense: bool, target) -> None:
    """Fit `w6`, `b6` of `unit` in place: least squares (with a small
    ridge) of atanh(target(centre tap)) on the unit's last features, every
    output lane alike, over the lattice of taps."""
    dev = unit["w1"].device
    w = {k: t.detach().cpu().double() for k, t in unit.items()}
    lv = torch.linspace(0, 1, FIT_LEVELS, dtype=torch.float64)
    taps = torch.cartesian_prod(*[lv] * 4)
    x = torch.relu(taps @ w["w1"] + w["b1"])
    for i in sorted(int(k[1:]) for k in w if k.startswith("w")
                    and k not in ("w1", "w6")):
        feat = torch.relu(x @ w[f"w{i}"] + w[f"b{i}"])
        x = torch.cat([x, feat], dim=-1) if dense else feat
    f = torch.cat([x, torch.ones(x.shape[0], 1, dtype=torch.float64)], -1)
    y = torch.atanh(target(taps[:, 0]).clamp(-TANH_CLIP, TANH_CLIP))
    g = f.T @ f
    g += FIT_RIDGE * torch.trace(g) / g.shape[0] * torch.eye(g.shape[0],
                                                            dtype=g.dtype)
    sol = torch.linalg.solve(g, f.T @ y)
    v = unit["w6"].shape[1]
    unit["w6"] = sol[:-1, None].expand(-1, v).float().contiguous().to(dev)
    unit["b6"] = sol[-1].expand(v).float().contiguous().to(dev)


def units(cfg: dict, seed: int, root, device) -> dict:
    """The configuration's units as float32 tensors on `device`."""
    if cfg["weights"] == "seed":
        return draw(cfg, seed, device)
    return {u: {k: torch.as_tensor(a, device=device) for k, a in p.items()}
            for u, p in load_npz(str(root / cfg["weights"])).items()}
