"""Pieces the LUT and the net reference share."""

from __future__ import annotations

import torch

#: the four sampled pixels of each mode and its bottom/right pad
#: (MuLUT `common/network.py` SRNet, `sr/4_test_lut.py`)
TAPS = {"s": ((0, 0), (0, 1), (1, 0), (1, 1)),
        "d": ((0, 0), (0, 2), (2, 0), (2, 2)),
        "y": ((0, 0), (1, 1), (1, 2), (2, 1))}
PAD = {"s": 1, "d": 2, "y": 2}

#: rows of a unit evaluated at once
BLOCK_ROWS = 1 << 20


def exact_f32() -> None:
    """Float32 matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FP8_MAX = 448.0             # largest float8 e4m3 value


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude to 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def apply_unit(unit: dict, x4: torch.Tensor, *, dense: bool,
               fmt: str = "f32") -> torch.Tensor:
    """MuLUTUnit as an MLP over the four taps (every conv after the
    receptive-field head is 1x1): relu head, relu hidden layers (plain:
    each takes the previous one's output; dense: the concat of the head
    and every layer before), linear head, tanh.  (N, 4) float32 -> (N, v),
    in blocks of rows.  `fmt="fp8"` rounds both operands of every matmul
    to float8 e4m3 (the control of a bf16 configuration)."""
    hidden = sorted(int(k[1:]) for k in unit if k.startswith("w")
                    and k not in ("w1", "w6"))
    if fmt == "fp8":
        w = {k: to_fp8(t) if k.startswith("w") else t
             for k, t in unit.items()}

        def mm(a, k):
            return to_fp8(a) @ w[k]
    else:
        def mm(a, k):
            return a @ unit[k]
    outs = []
    for r0 in range(0, x4.shape[0], BLOCK_ROWS):
        x = torch.relu(mm(x4[r0: r0 + BLOCK_ROWS], "w1") + unit["b1"])
        for i in hidden:
            feat = torch.relu(mm(x, f"w{i}") + unit[f"b{i}"])
            x = torch.cat([x, feat], dim=-1) if dense else feat
        outs.append(torch.tanh(mm(x, "w6") + unit["b6"]))
    return torch.cat(outs)


def pad_bottom_right(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate `pad` rows below and columns right of the last two
    axes (numpy's `np.pad(mode="edge")`)."""
    H, W = x.shape[-2:]
    rows = torch.arange(H + pad, device=x.device).clamp(max=H - 1)
    cols = torch.arange(W + pad, device=x.device).clamp(max=W - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def taps(x: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 4): the mode's four pixels of each site
    of the bottom/right padded image."""
    H, W = x.shape[-2:]
    xp = pad_bottom_right(x, PAD[mode])
    return torch.stack([xp[..., dy: dy + H, dx: dx + W]
                        for dy, dx in TAPS[mode]], dim=-1)


def pixel_shuffle(lanes: torch.Tensor, up: int) -> torch.Tensor:
    """(..., H, W, up*up) lanes, lane sy*up + sx -> (..., H*up, W*up)."""
    *lead, H, W, _ = lanes.shape
    out = lanes.reshape(*lead, H, W, up, up).movedim(-2, -3)
    return out.reshape(*lead, H * up, W * up)


def rotation_ensemble(x: torch.Tensor, mode: str, up: int, lanes_fn):
    """Sum over the four rotations of `lanes_fn(taps)` (..., h, w, v),
    each evaluated on the rotated image and rotated back."""
    acc = None
    for r in range(4):
        xr = torch.rot90(x, r, dims=(-2, -1))
        out = pixel_shuffle(lanes_fn(taps(xr, mode)), up)
        out = torch.rot90(out, (4 - r) % 4, dims=(-2, -1))
        acc = out if acc is None else acc + out
    return acc
