"""Load SRNets weights: reference PyTorch checkpoints, `.npz` registries,
and the carry-over of NumPy parameter dicts into the port's tensors.

Torch twin of `mulut_tpu.models.torch_import`; the optimizer state is
saved as the JAX package saves it (optax's leaves, `leaf_{k}`), so one
experiment folder resumes in either package.  The reference saves whole-model
pickles (ref: sr/1_train_model.py:63-64) whose unpickling needs the classes
`model.SRNets`, `common.network.*`; minimal stub classes are registered
under those names so pickle can restore instance state, then the
state_dict is read.  No reference code is imported or executed.

State-dict layout (ref models/sr_x2sdy/Model_200000.pth):
  s{stage}_{mode}.model.conv1.conv.{weight,bias}    head conv (nf,1,K,K)
  s{stage}_{mode}.model.conv{2..5}.conv1.conv.*     dense 1x1 convs
  s{stage}_{mode}.model.conv6.conv.*                output 1x1 conv
The head conv's K*K (or 1x4) entries are the four tap weights in
(a, b, c, d) order for every mode, so the convs flatten into the
tap-MLP matrices of `models.blocks` with no numerical change.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch


def _install_stub_modules():
    import torch.nn as nn

    class _Stub(nn.Module):
        pass

    names = ["SRNets", "SRNet", "MuLUT", "MuLUTUnit", "MuLUTcUnit", "DenseConv",
             "Conv", "ActConv", "DNNet", "DMNet", "DNNets", "DMNets"]
    for mod_name in ["model", "common", "common.network"]:
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
        for cls in names:
            if not hasattr(sys.modules[mod_name], cls):
                setattr(sys.modules[mod_name], cls, type(cls, (_Stub,), {}))


def load_torch_state_dict(path: str) -> dict:
    """Load a reference .pth (whole-model pickle or state_dict) -> ndarray
    dict."""
    _install_stub_modules()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state = obj if isinstance(obj, dict) else obj.state_dict()
    return {k: v.detach().numpy() for k, v in state.items()}


def _unit_from_state(state: dict, prefix: str) -> dict:
    """One MuLUT unit's tap-MLP params (NumPy) from torch conv tensors."""
    params = {}
    w1 = state[f"{prefix}.conv1.conv.weight"]  # (nf, 1, kh, kw)
    params["w1"] = np.asarray(w1.reshape(w1.shape[0], -1).T)  # (4, nf)
    params["b1"] = np.asarray(state[f"{prefix}.conv1.conv.bias"])
    for i in range(2, 6):
        dense_key = f"{prefix}.conv{i}.conv1.conv"
        plain_key = f"{prefix}.conv{i}.conv"
        key = dense_key if f"{dense_key}.weight" in state else plain_key
        w = state[f"{key}.weight"]  # (out, in, 1, 1)
        params[f"w{i}"] = np.asarray(w.reshape(w.shape[0], w.shape[1]).T)
        params[f"b{i}"] = np.asarray(state[f"{key}.bias"])
    w6 = state[f"{prefix}.conv6.conv.weight"]
    params["w6"] = np.asarray(w6.reshape(w6.shape[0], w6.shape[1]).T)
    params["b6"] = np.asarray(state[f"{prefix}.conv6.conv.bias"])
    return params


def srnets_params_from_torch(path: str, *, modes: str = "sdy",
                             stages: int = 2) -> dict:
    """Reference SRNets checkpoint -> {"s{stage}_{mode}": unit params}."""
    state = load_torch_state_dict(path)
    params = {}
    for s in range(stages):
        for mode in modes:
            key = f"s{s + 1}_{mode}"
            params[key] = _unit_from_state(state, f"{key}.model")
    return params


def save_params_npz(path: str, params: dict) -> None:
    flat = {}
    for unit_key, unit in params.items():
        for name, arr in unit.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            flat[f"{unit_key}/{name}"] = np.asarray(arr)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """`save_params_npz` file (either package's) -> NumPy params dict."""
    flat = np.load(path)
    params: dict = {}
    for k in flat.files:
        unit_key, name = k.split("/")
        params.setdefault(unit_key, {})[name] = np.asarray(flat[k])
    return params


def params_from_numpy(params: dict, device) -> dict:
    """A params dict of NumPy arrays (the JAX package's layout, e.g. from
    `load_params_npz` or `np.asarray` of its pytree) -> float32 tensors on
    `device`, same keys and shapes.  Tensors are moved as they are."""
    def conv(arr):
        if isinstance(arr, torch.Tensor):
            return arr.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.array(arr, dtype=np.float32),
                               device=device)

    return {unit_key: {name: conv(arr) for name, arr in unit.items()}
            for unit_key, unit in params.items()}


def params_to_numpy(params: dict) -> dict:
    """The inverse of `params_from_numpy`: a params dict of tensors (any
    device) -> float32 NumPy arrays on the host, same keys and shapes."""
    return {unit_key: {name: t.detach().cpu().numpy()
                       for name, t in unit.items()}
            for unit_key, unit in params.items()}


def _opt_params(optimizer) -> list:
    """The optimizer's parameters in its groups' order (the JAX package's
    leaf order for the pipelines' optimizers)."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def save_opt_state_npz(path: str, optimizer) -> None:
    """Persist an `OptaxAdam` optimizer's state (the Adam moments and the
    update count that drives the cosine-LR phase) as the JAX package's
    `save_opt_state_npz` writes optax's state: arrays `leaf_{k}` in tree
    order.  For `optax.adam` (and `optax.adamw`, whose weight-decay state
    has no leaves) under the cosine schedule, with n parameters in leaf
    order, that is

        leaf_0                    Adam's count (int32 scalar)
        leaf_1 .. leaf_n          mu, one per parameter (float32)
        leaf_{n+1} .. leaf_{2n}   nu, one per parameter (float32)
        leaf_{2n+1}               the schedule's count (int32 scalar)

    and both counts are the update count.  Completes the reference's
    abandoned intent — its optimizer save is commented out (ref:
    sr/1_train_model.py:65-66) and its resume is broken (ref:
    sr/1_train_model.py:157-164) — so a resumed run follows the same
    trajectory as an uninterrupted one, in either package."""
    params = _opt_params(optimizer)
    states = [optimizer.state.get(p, {}) for p in params]
    counts = {int(st["step"]) if st else 0 for st in states}
    if len(counts) != 1:
        raise ValueError(f"optimizer state: parameters at different update "
                         f"counts {sorted(counts)}; optax keeps one count")
    count = np.int32(counts.pop())

    def moment(p, st, name):
        if not st:
            return np.zeros(tuple(p.shape), np.float32)
        return st[name].detach().cpu().numpy().astype(np.float32)

    leaves = ([count] + [moment(p, st, "mu") for p, st in zip(params, states)]
              + [moment(p, st, "nu") for p, st in zip(params, states)]
              + [count])
    np.savez(path, **{f"leaf_{k}": np.asarray(a) for k, a in
                      enumerate(leaves)})


def load_opt_state_npz(path: str, template):
    """Restore an optimizer state into `template`, an `OptaxAdam` of the
    same config over the same parameters (it supplies the parameter
    groups; the file supplies the state), and return it.

    Reads the JAX package's layout (`save_opt_state_npz` of either
    package: optax's leaves for adam/adamw under the cosine schedule), and
    the `state/{param index}/{name}` arrays the port wrote before it.  A
    file whose leaves do not fit the optimizer (another parameter count,
    another optimizer chain, a moment of another shape, the two counts
    apart) raises ValueError, naming what differs."""
    flat = np.load(path)
    params = _opt_params(template)
    n = len(params)
    groups = template.state_dict()["param_groups"]
    if any(k.startswith("state/") for k in flat.files):
        state: dict = {}
        for k in flat.files:
            _, i, name = k.split("/")
            state.setdefault(int(i), {})[name] = torch.from_numpy(flat[k])
        if sorted(state) != list(range(n)):
            raise ValueError(
                f"optimizer-state mismatch: {path} holds state for "
                f"{len(state)} parameters, the optimizer has {n} — was the "
                "model config changed?")
    else:
        leaves = len(flat.files)
        if sorted(flat.files) != sorted(f"leaf_{k}" for k in range(leaves)) \
                or leaves != 2 * n + 2:
            raise ValueError(
                f"optimizer-state leaf count mismatch: {path} has {leaves} "
                f"leaves, optax's adam over {n} parameters has {2 * n + 2} "
                "(its count, n first moments, n second moments, the "
                "schedule's count) — was the model or optimizer config "
                "changed?")
        count, sched = int(flat["leaf_0"]), int(flat[f"leaf_{2 * n + 1}"])
        if count != sched:
            raise ValueError(f"optimizer state {path}: Adam's count {count} "
                             f"and the schedule's count {sched} differ")
        state = {}
        for i, p in enumerate(params):
            mu, nu = flat[f"leaf_{1 + i}"], flat[f"leaf_{1 + n + i}"]
            if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
                raise ValueError(
                    f"optimizer state {path}: parameter {i} is "
                    f"{tuple(p.shape)}, its moments {mu.shape} and "
                    f"{nu.shape}")
            state[i] = {"step": torch.tensor(count, dtype=torch.int64),
                        "mu": torch.from_numpy(mu.astype(np.float32)),
                        "nu": torch.from_numpy(nu.astype(np.float32))}
    template.load_state_dict({"state": state, "param_groups": groups})
    return template
