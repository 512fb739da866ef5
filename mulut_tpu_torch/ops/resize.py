"""Bicubic resize as dense per-axis matmuls.

Torch twin of `mulut_tpu.ops.resize`: one (out, in) PIL-convention
bicubic weight matrix per axis (Keys cubic, a = -0.5, border taps
renormalized; built on the host with NumPy), applied as two float32
matmuls with TF32 off.  The weight builders are copies of the JAX
package's (tests hold them equal).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax < 1, ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        np.where(ax < 2, (((ax - 5) * ax + 8) * ax - 4) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def _bicubic_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 PIL-convention bicubic resampling matrix."""
    ratio = n_in / n_out
    filterscale = max(ratio, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * ratio
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), n_in)
        taps = np.arange(lo, hi)
        ww = _keys_cubic((taps - center + 0.5) / filterscale)
        w[i, lo:hi] = ww / ww.sum()
    return w.astype(np.float32)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full float32 (TF32 off) inside the block; the
    previous setting is restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def bicubic_resize_hw(x: torch.Tensor, h_out: int, w_out: int):
    """Bicubic-resize the last two dims of `x` to (h_out, w_out), f32.
    `x` may have any leading dims."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    x = x.to(torch.float32)
    with full_f32_matmul():
        if h_in != h_out:
            wv = torch.as_tensor(_bicubic_matrix_np(h_in, h_out),
                                 device=x.device)
            x = torch.matmul(wv, x)
        if w_in != w_out:
            wh = torch.as_tensor(_bicubic_matrix_np(w_in, w_out),
                                 device=x.device)
            x = torch.matmul(x, wh.T)
    return x


def bicubic_upscale(x: torch.Tensor, scale: int):
    """Integer-factor bicubic upscale of the last two dims (PIL phases)."""
    return bicubic_resize_hw(x, x.shape[-2] * scale, x.shape[-1] * scale)
