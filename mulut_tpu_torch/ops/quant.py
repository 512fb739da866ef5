"""W8A8 quantization of plain (mxu-arch) MuLUT units for net-mode
deployment through the int8 stage-ensemble kernel K11.

Torch twin of `mulut_tpu.ops.quant`.  The scheme is static and symmetric:

  * Activations: unsigned per-channel scales (post-ReLU values in
    [0, max_c]) calibrated on the 17**4 lattice of the unit input box
    [0, 1]^4 (stage inputs are clipped to [0, 255]/255), times a 1.05
    margin -> int8 codes in [0, 127].  Each matmul's per-channel input scale is
    folded into its weight rows; the head scale folds into w1/b1.
  * Weights: per-output-column symmetric int8 on the folded weights.
  * Requant between int8 matmuls, per output column:
      - "f32" (and "f32w6"): clip(round(relu(acc * hcq + hbq)), 0, 127);
      - "int": clip(((acc * hmq + hhq) >> hsq) + hbi, 0, 127) in int32.
  * The output head dequantizes fma(o, c6, b6), then tanh and the
    per-rotation round(127 * .) accumulation in float32.

All quantization arithmetic is the JAX package's NumPy code (float32 and
float64), so the stacks are byte-equal to it; tensors are made only at the
end.  `quantize_srnets_for_fast` returns each stage's stack once, in the
layout K11 reads (`kernel_stack`); `jax_stack` gives it back in the JAX
package's keys and layout.
"""

from __future__ import annotations

import numpy as np
import torch

#: requant forms and the JAX kernel body of each (`mulut_tpu.ops.
#: unit_kernel`); "f32" and "f32w6" compute one function and share a
#: kernel-layout stack.
REQUANT_FORMS = ("int", "f32w6", "f32")
_GRID_N = 17          # calibration lattice points per input axis
_CHUNK = 1 << 16      # lattice points per calibration matmul
_MARGIN = 1.05        # activation scale headroom over the calibrated max


def _grid4(n: int) -> np.ndarray:
    """(n**4, 4) lattice over the unit input box [0, 1]^4."""
    base = np.linspace(0.0, 1.0, n, dtype=np.float32)
    g = np.stack(np.meshgrid(base, base, base, base, indexing="ij"), -1)
    return g.reshape(-1, 4)


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def calibrate_plain_unit(params: dict) -> dict:
    """Per-channel post-ReLU activation maxima of a plain unit.

    Returns {"head": (nf,) float array, "hidden": (D, nf) float array}:
    column-wise maxima of the head ReLU output and of each hidden layer's
    ReLU output over the 17**4 lattice of the input box.  params:
    float32 NumPy arrays or tensors.
    """
    from ..models.blocks import unit_layout

    dense, hidden = unit_layout(params)
    assert not dense, "W8A8 quantization targets plain (mxu-arch) units"
    w1 = _np32(params["w1"])
    b1 = _np32(params["b1"])
    hws = [_np32(params[f"w{i}"]) for i in hidden]
    hbs = [_np32(params[f"b{i}"]) for i in hidden]
    grid = _grid4(_GRID_N)
    nf = w1.shape[1]
    head_max = np.zeros(nf, np.float32)
    hid_max = np.zeros((len(hidden), nf), np.float32)
    for lo in range(0, grid.shape[0], _CHUNK):
        x = np.maximum(grid[lo: lo + _CHUNK] @ w1 + b1, 0.0)
        head_max = np.maximum(head_max, x.max(axis=0, initial=0.0))
        for d, (w, b) in enumerate(zip(hws, hbs)):
            x = np.maximum(x @ w + b, 0.0)
            hid_max[d] = np.maximum(hid_max[d], x.max(axis=0, initial=0.0))
    return {"head": head_max, "hidden": hid_max}


def _fixed_point(hcq: np.ndarray, hbq: np.ndarray, nf: int):
    """Per-column fixed-point (M, S, half, B) from f32 requant constants.

    x_next = clip(((acc * M + half) >> S) + B, 0, 127) approximates
    clip(round(relu(acc * hcq + hbq)), 0, 127).  S keeps |acc * M + half|
    inside 2^30 (|acc| <= 127 * 127 * nf) with M as large as that allows.
    The bias is added after the shift and clamped to +-2^29, so ti + B
    never wraps int32.  Columns with hcq == 0 (dead channels) get M = 0,
    so their code is exactly B.
    """
    accmax = 127.0 * 127.0 * nf
    mcap = (2.0**30 - 1.0) / accmax
    pos = np.maximum(hcq, 1e-30)
    S = np.clip(np.floor(np.log2(mcap / pos)), 0, 30).astype(np.int64)
    Mi = np.rint(pos * np.exp2(S.astype(np.float64)))
    over = Mi > mcap
    while over.any():
        S = np.where(over & (S > 0), S - 1, S)
        Mi = np.rint(pos * np.exp2(S.astype(np.float64)))
        over = (Mi > mcap) & (S > 0)
    Mi = np.where(hcq <= 0.0, 0.0, np.clip(Mi, 1, mcap))
    half = np.where(S > 0, np.exp2((S - 1).astype(np.float64)), 0.0)
    B = np.clip(np.nan_to_num(np.rint(hbq)), -(2.0**29), 2.0**29)
    return (Mi.astype(np.int32), S.astype(np.int32),
            half.astype(np.int32), B.astype(np.int32))


def _check_requant(requant: str) -> None:
    if requant not in REQUANT_FORMS:
        raise ValueError(f"unknown requant form: {requant!r}")


def quantize_plain_stack(stacked: dict, params: dict, *, stage: int,
                         modes: str, requant: str = "int") -> dict:
    """int8 (W8A8) stage stack in the JAX package's keys and layout.

    stacked: a plain-unit site-major `unit_kernel.stack_stage_params` (bf16
    hw/hb, w6 rotation-permuted and padded to 16 lanes per rotation).
    params: the float32 params (calibration source).  Returns CPU tensors:
    w1 (M, 4, nf) / b1 (M, nf) bf16 with the head scale folded in; hwq
    (D, M, nf, nf) int8; then for "f32" hcq/hbq (D, M, nf) f32, w6q
    (M, nf, 64) int8, c6/b6 (M, 64) f32; for "f32w6" the same constants
    with w6q (M, 4, nf, 16) and c6/b6 (M, 4, 16); for "int" that head
    layout and hmq/hsq/hhq/hbi (D, M, nf) int32 instead of hcq/hbq.
    """
    if "hw" not in stacked:
        raise ValueError("quantize_plain_stack expects a plain-unit stack "
                         "(dense-concat units keep the bf16 kernel)")
    _check_requant(requant)
    hw = _np32(stacked["hw"])     # (D, M, nf, nf)
    hb = _np32(stacked["hb"])     # (D, M, nf)
    w6 = _np32(stacked["w6"])     # (M, nf, 4*P)
    b6 = _np32(stacked["b6"])     # (M, 4*P)
    D, M, nf = hw.shape[:3]

    s_head = np.zeros((M, nf), np.float32)
    s_hid = np.zeros((D, M, nf), np.float32)
    hid_dead = np.zeros((D, M, nf), bool)
    for mi, m in enumerate(modes):
        cal = calibrate_plain_unit(params[f"s{stage}_{m}"])
        s_head[mi] = np.maximum(cal["head"], 1e-12) * _MARGIN / 127.0
        s_hid[:, mi] = np.maximum(cal["hidden"], 1e-12) * _MARGIN / 127.0
        # a channel that is ~0 over the whole input box always emits code
        # 0; its requant constants would explode, so zero it exactly
        hid_dead[:, mi] = cal["hidden"] <= 1e-9

    # fold each matmul's per-channel input scale into its weight rows,
    # then quantize per output column
    s_in = np.concatenate([s_head[None], s_hid[:-1]], 0)        # (D, M, nf)
    hw_f = hw * s_in[:, :, :, None]
    sw_h = np.maximum(np.abs(hw_f).max(axis=2) / 127.0, 1e-12)  # (D, M, nf)
    hwq = np.rint(hw_f / sw_h[:, :, None, :]).astype(np.int8)
    s_last = s_hid[-1] if D else s_head                          # (M, nf)
    w6_f = w6 * s_last[:, :, None]
    sw_6 = np.maximum(np.abs(w6_f).max(axis=1) / 127.0, 1e-12)   # (M, 4P)
    w6q = np.rint(w6_f / sw_6[:, None, :]).astype(np.int8)

    hcq = sw_h / s_hid                                           # (D, M, nf)
    hbq = hb / s_hid
    c6 = sw_6                                                    # (M, 4P)

    if hid_dead.any():
        dm, dmi, dc = np.nonzero(hid_dead)
        hwq[dm, dmi, :, dc] = 0
        hcq[hid_dead] = 0.0
        hbq[hid_dead] = 0.0

    bf = torch.bfloat16
    w1 = _np32(stacked["w1"]) / s_head[:, None, :]
    b1 = _np32(stacked["b1"]) / s_head
    out = {"w1": torch.from_numpy(w1).to(bf),
           "b1": torch.from_numpy(b1).to(bf),
           "hwq": torch.from_numpy(hwq)}
    if requant == "f32":
        out.update(hcq=torch.from_numpy(hcq), hbq=torch.from_numpy(hbq),
                   w6q=torch.from_numpy(w6q), c6=torch.from_numpy(c6),
                   b6=torch.from_numpy(b6))
        return out
    # the JAX package's lane-sliceless head layout (M, 4, nf, P)
    P = w6.shape[2] // 4
    w6q4 = np.ascontiguousarray(w6q.reshape(M, nf, 4, P).transpose(0, 2, 1, 3))
    out.update(w6q=torch.from_numpy(w6q4),
               c6=torch.from_numpy(c6.reshape(M, 4, P)),
               b6=torch.from_numpy(b6.reshape(M, 4, P)))
    if requant == "f32w6":
        out.update(hcq=torch.from_numpy(hcq), hbq=torch.from_numpy(hbq))
        return out
    hm, hs, hh, hbi = _fixed_point(hcq, hbq, nf)
    out.update(hmq=torch.from_numpy(hm), hsq=torch.from_numpy(hs),
               hhq=torch.from_numpy(hh), hbi=torch.from_numpy(hbi))
    return out


# ---------------------------------------------------------------------------
# K11's layout
# ---------------------------------------------------------------------------


def k32_feature_order(nf: int) -> np.ndarray:
    """Input-feature order of K11's int8 weights: entry k is the feature
    that the kernel's logical reduction index k reads.

    In `mma.sync.m16n8k32` a thread of group index t holds accumulator
    columns {2t, 2t+1} of each 8-column tile, while its A registers take
    k-columns {4t .. 4t+3} of each 16-wide half of a k32 slice.  The
    kernel packs the codes of tiles (0, 1) and (2, 3) of a 32-feature
    block as its A registers unchanged, so logical k = 4t + i of a half
    reads feature 8*(i >> 1) + 2t + (i & 1) of that half; the weights'
    input axis is permuted to match (whole 16-feature blocks only; a
    remainder keeps its order).
    """
    order = np.arange(nf)
    k = np.arange(16)
    perm = 8 * ((k % 4) >> 1) + 2 * (k // 4) + (k % 2)
    for b in range(nf // 16):
        order[16 * b: 16 * b + 16] = 16 * b + perm
    return order


def kernel_stack(q: dict) -> dict:
    """JAX-layout quantized stack (`quantize_plain_stack`) -> K11's layout,
    contiguous, on q's device:

      w1t (M, nf, 4) bf16, b1 (M, nf) bf16 (the head, as K4 reads it);
      hwqt (D, M, nf_out, nf_in) int8, [out][in], the input axis in
        `k32_feature_order`;
      w6qt (M, 64, nf_in) int8, row 16r + lane, same input order;
      c6, b6 (M, 64) float32;
      hcq, hbq (D, M, nf) float32 ("f32", "f32w6") or hmq, hsq, hhq, hbi
        (D, M, nf) int32 ("int").
    """
    w1 = q["w1"]
    M, _, nf = w1.shape
    order = torch.as_tensor(k32_feature_order(nf), device=w1.device)
    w6q = q["w6q"]
    if w6q.dim() == 4:                        # (M, 4, nf, P) -> (M, nf, 4P)
        w6q = w6q.permute(0, 2, 1, 3).reshape(M, nf, -1)
    out = {
        "w1t": w1.permute(0, 2, 1).contiguous(),
        "b1": q["b1"].contiguous(),
        "hwqt": q["hwq"].permute(0, 1, 3, 2)[..., order].contiguous(),
        "w6qt": w6q.permute(0, 2, 1)[..., order].contiguous(),
        "c6": q["c6"].reshape(M, -1).contiguous(),
        "b6": q["b6"].reshape(M, -1).contiguous(),
    }
    keys = ("hmq", "hsq", "hhq", "hbi") if "hmq" in q else ("hcq", "hbq")
    for k in keys:
        out[k] = q[k].contiguous()
    return out


def jax_stack(st: dict, requant: str) -> dict:
    """K11-layout stack -> the JAX package's keys and layout for `requant`
    (CPU tensors), the inverse of `kernel_stack`."""
    _check_requant(requant)
    if ("hmq" in st) != (requant == "int"):
        raise ValueError(f"stack does not carry {requant!r} constants")
    st = {k: v.cpu() for k, v in st.items()}
    M, nf, _ = st["w1t"].shape
    inv = torch.as_tensor(np.argsort(k32_feature_order(nf)))
    w6q = st["w6qt"][..., inv].permute(0, 2, 1).contiguous()  # (M, nf, 64)
    out = {"w1": st["w1t"].permute(0, 2, 1).contiguous(), "b1": st["b1"],
           "hwq": st["hwqt"][..., inv].permute(0, 1, 3, 2).contiguous()}
    if requant == "f32":
        out.update(w6q=w6q, c6=st["c6"], b6=st["b6"])
    else:
        P = w6q.shape[2] // 4
        out.update(
            w6q=w6q.reshape(M, nf, 4, P).permute(0, 2, 1, 3).contiguous(),
            c6=st["c6"].reshape(M, 4, P), b6=st["b6"].reshape(M, 4, P))
    keys = ("hmq", "hsq", "hhq", "hbi") if requant == "int" else ("hcq",
                                                                   "hbq")
    out.update({k: st[k] for k in keys})
    return out


def quantize_srnets_for_fast(params: dict, *, modes: str, stages: int,
                             scale: int, requant: str = "int") -> list:
    """Per-stage W8A8 stacks for `srnets_predict_fast` (plain units only),
    in K11's layout (`kernel_stack`), on the device of `params` (float32
    tensors, `models.torch_import.params_from_numpy`).  Calibration reads
    the float32 params; the quantized weights come from the bf16 stacks,
    as in the JAX package."""
    from ..models.srnet import unit_upscale
    from ..models.torch_import import params_from_numpy
    from .unit_kernel import stack_stage_params

    if not isinstance(params[f"s1_{modes[0]}"]["w1"], torch.Tensor):
        params = params_from_numpy(params, "cpu")
    device = params[f"s1_{modes[0]}"]["w1"].device
    out = []
    for s in range(stages):
        st = stack_stage_params(params, stage=s + 1, modes=modes,
                                upscale=unit_upscale(s + 1, stages, scale))
        q = quantize_plain_stack(st, params, stage=s + 1, modes=modes,
                                 requant=requant)
        out.append(kernel_stack({k: v.to(device) for k, v in q.items()}))
    return out
