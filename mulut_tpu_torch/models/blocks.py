"""MuLUT units as tap-MLPs over plain parameter dicts.

Torch twin of `mulut_tpu.models.blocks` (ref: common/network.py:16-133):
every conv after the receptive-field head is 1x1, so a unit is an MLP over
the four sampled pixels.  Parameters are dicts of float32 arrays
(`w1` (4, nf), `b1` (nf,), `w2`..`w{depth+1}`, `w6`, `b6`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import full_f32_matmul


def _kaiming_normal(rng: np.random.Generator, shape, fan_in: int):
    """Torch nn.init.kaiming_normal_ default: gain sqrt(2), fan_in mode."""
    std = float(np.sqrt(2.0 / fan_in))
    return (rng.standard_normal(shape) * std).astype(np.float32)


def init_mulut_unit(rng: np.random.Generator, *, nf: int = 64,
                    upscale: int = 1, out_c: int = 1, dense: bool = True,
                    depth: int = 4) -> dict:
    """Parameters of one MuLUT unit as float32 NumPy arrays
    (ref: common/network.py:62-105): Kaiming-normal weights from `rng`,
    zero biases.  Same layout as `mulut_tpu.models.blocks.init_mulut_unit`;
    the random stream is NumPy's, not JAX's."""
    assert not (dense and depth != 4), "the dense-concat unit is depth-4"
    out_dim = out_c * upscale * upscale
    params = {
        "w1": _kaiming_normal(rng, (4, nf), fan_in=4),
        "b1": np.zeros((nf,), np.float32),
    }
    for i in range(2, 2 + depth):
        w_in = (i - 1) * nf if dense else nf
        params[f"w{i}"] = _kaiming_normal(rng, (w_in, nf), fan_in=w_in)
        params[f"b{i}"] = np.zeros((nf,), np.float32)
    head_in = (depth + 1) * nf if dense else nf
    params["w6"] = _kaiming_normal(rng, (head_in, out_dim), fan_in=head_in)
    params["b6"] = np.zeros((out_dim,), np.float32)
    return params


def unit_layout(params: dict) -> tuple:
    """Infer (dense, hidden_layer_indices) from a unit's parameter shapes:
    the unit is dense-concat iff the output head consumes the full concat
    width ((depth+1)*nf)."""
    nf = params["w1"].shape[1]
    hidden = [i for i in range(2, 6) if f"w{i}" in params]
    dense = params["w6"].shape[0] == (len(hidden) + 1) * nf and hidden
    return bool(dense), hidden


#: the matmul precisions of the float32 units: "f32" full float32 (the
#: JAX package's Precision.HIGHEST), "bf16" inputs rounded to bf16 with
#: float32 products and sums (Precision.DEFAULT on a TPU)
PRECISIONS = ("f32", "bf16")


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ bf16 b with float32 output: on a CUDA device one cuBLAS
    bf16 matmul that accumulates and writes float32; on the CPU the same
    function as a float32 matmul of the bf16 values (their products are
    exact in float32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    with full_f32_matmul():
        return a.float() @ b.float()


class Bf16Dot(torch.autograd.Function):
    """`a @ b` for 2-D float32 a and b as a TPU's single-pass dot
    (Precision.DEFAULT) computes it, forward and backward: each input
    rounded to bf16 (round to nearest even), products, sums and the output
    in float32.  The backward's two products, g @ b.T and a.T @ g, round
    their inputs (the incoming gradient g too) in the same way, as XLA's
    transposed dots keep the forward's precision.  Autograd through
    `a.bfloat16().float()` would leave the backward's products in float32
    and round the gradients to bf16 instead."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _bf16_product(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        ga = _bf16_product(g16, b16.T) if ctx.needs_input_grad[0] else None
        gb = _bf16_product(a16.T, g16) if ctx.needs_input_grad[1] else None
        return ga, gb


def _dot(precision: str):
    """The unit's matmul at `precision` (`PRECISIONS`); the "f32" one
    runs inside the callers' `full_f32_matmul` block."""
    if precision == "bf16":
        return Bf16Dot.apply
    if precision != "f32":
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return torch.matmul


def apply_mulut_unit(params: dict, x4: torch.Tensor, *,
                     dense: bool | None = None,
                     precision: str = "f32") -> torch.Tensor:
    """(N, 4) tap pixels -> (N, out_c*upscale**2) in (-1, 1), float32.

    relu head, dense-concat (or plain) 1x1 layers, linear output, tanh
    (ref: common/network.py:96-105).  Matmuls run in full float32 (TF32
    off), as the JAX unit runs at Precision.HIGHEST; `precision="bf16"`
    runs them as `Bf16Dot` (Precision.DEFAULT on a TPU, the JAX package's
    trainPrecision="bf16"), every other op still in float32.
    """
    inferred, hidden = unit_layout(params)
    if dense is None:
        dense = inferred
    dot = _dot(precision)
    with full_f32_matmul():
        x = torch.relu(dot(x4, params["w1"]) + params["b1"])
        for i in hidden:
            feat = torch.relu(dot(x, params[f"w{i}"]) + params[f"b{i}"])
            x = torch.cat([x, feat], dim=-1) if dense else feat
        return torch.tanh(dot(x, params["w6"]) + params["b6"])


def init_mulut_c_unit(rng: np.random.Generator, *, nf: int = 64) -> dict:
    """Channel-wise RGB->RGB unit (ref: common/network.py:108-133) as
    float32 NumPy arrays: w1 (3, nf), dense-concat w2..w5 (k*nf, nf), w6
    (5*nf, 3), Kaiming-normal from `rng`, zero biases.  Same layout as
    `mulut_tpu.models.blocks.init_mulut_c_unit`."""
    params = {
        "w1": _kaiming_normal(rng, (3, nf), fan_in=3),
        "b1": np.zeros((nf,), np.float32),
    }
    for i, w_in in enumerate([nf, 2 * nf, 3 * nf, 4 * nf], start=2):
        params[f"w{i}"] = _kaiming_normal(rng, (w_in, nf), fan_in=w_in)
        params[f"b{i}"] = np.zeros((nf,), np.float32)
    params["w6"] = _kaiming_normal(rng, (5 * nf, 3), fan_in=5 * nf)
    params["b6"] = np.zeros((3,), np.float32)
    return params


def apply_mulut_c_unit(params: dict, rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3) in (-1, 1): the dense 1x1 stack with a tanh
    output, matmuls in full float32 (TF32 off)."""
    with full_f32_matmul():
        x = torch.relu(rgb @ params["w1"] + params["b1"])
        for i in range(2, 6):
            feat = torch.relu(x @ params[f"w{i}"] + params[f"b{i}"])
            x = torch.cat([x, feat], dim=-1)
        return torch.tanh(x @ params["w6"] + params["b6"])
