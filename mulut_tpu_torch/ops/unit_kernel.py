"""Whole-stage tap-MLP ensembles of net mode, with their CUDA kernels.

Torch twin of the net-mode default paths of `mulut_tpu.ops.unit_kernel`.
One launch evaluates all 4*M passes (M modes x 4 rotations) of one cascade
stage: per pass the unit's head over its 4 taps, the hidden layers, the
output head with the lane un-rotation baked into rotation r's w6 column
block, and `acc += round(127 * tanh(.))`; the rotation/mode sum stays in
the kernel.

- K3 `stage_ensemble_apply_w` (csrc/plain_window.cu) runs plain (mxu-arch)
  stacks.  It reads each pass's taps straight from the flat edge-padded
  plane (site p's tap (dy, dx) is p + dy*Wp + dx) and folds the cascade's
  stage mix into its epilogue (`MIXES`).
- K4 `stage_ensemble_apply` (csrc/dense_ensemble.cu) runs dense-concat
  stacks over an (N, 16*M) bf16 tap matrix and returns the raw (N, 16)
  accumulator; the mix runs in torch (`inner_mix`, `final_mix`).
- K11 `stage_ensemble_apply_q` (csrc/plain_w8a8.cu) runs W8A8 quantized
  plain stacks (`quant.py`) over the same tap matrix, with the same
  output and torch mix as K4.

Numerics are the JAX kernels': bf16 weights and activations, float32
products summed in float32, float32 bias/ReLU/tanh, round half to even.
K4's and K11's head is the JAX package's broadcast form with every
product and partial sum rounded to bf16.  K11's hidden and output
products are exact int8 x int8 -> int32 sums, and its dequantizing
multiply-adds are single-rounded, as XLA fuses them.  The inner stage mix
is XLA's jitted form of `round(acc / (4M) + 127)`: one fused multiply-add
by float32(1/(4M)).

Each wrapper runs its plain torch version (`*_plain`) when given CPU
tensors and launches its kernel when given CUDA tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import library
from .resize import full_f32_matmul
from .taps import lane_rotation_perm, mode_pad, rotated_taps

#: Kernel launches per wrapper (CUDA launches only; the plain CPU versions
#: do not count).  A run resets them to 0 to show which kernels it used.
LAUNCHES = {"stage_ensemble_apply_w": 0, "stage_ensemble_apply": 0,
            "stage_ensemble_apply_q": 0}

#: K3 epilogues (`_apply_stage_mix_t` of the JAX package): None = raw
#: accumulator; "inner" = the inner-stage mix as one bf16 row;
#: "final" = round(acc / M) f32; "final_u8" = its clip to [0, 255] as bf16;
#: "final_pack" = the x4 clip packed 4 sub-pixels per 32-bit word.
MIXES = (None, "inner", "final", "final_u8", "final_pack")

_MAX_MODES = 6            # csrc/plain_window.cu kMaxModes
_LANES = 16               # output lanes per rotation (csrc kHeadRows / 4)
_PLAIN_NF = 128           # csrc/plain_window.cu instantiation (the artifacts)
_DENSE_NF = 64            # csrc/dense_ensemble.cu instantiation (reference)
_W8A8_NF = 128            # csrc/plain_w8a8.cu instantiation (the artifacts)
_CHUNK = 1 << 19          # plain versions: sites per chunk
_INV255 = float(np.float32(1 / 255))


# ---------------------------------------------------------------------------
# Weight stacks
# ---------------------------------------------------------------------------


def stack_stage_params(params: dict, *, stage: int, modes: str,
                       upscale: int) -> dict:
    """Stack one stage's per-mode unit params (float tensors) as bf16.

    Dense units give w1 (M, 4, nf), ..., w6 (M, 5*nf, 64); plain (mxu-arch)
    units give w1/b1, hw (D, M, nf, nf) / hb (D, M, nf) and w6 (M, nf, 64).
    In both, rotation r's w6 columns [16r, 16r + 16) are permuted by
    `lane_rotation_perm(upscale, r)` and zero-padded from upscale**2 to 16
    lanes.
    """
    from ..models.blocks import unit_layout

    units = [params[f"s{stage}_{m}"] for m in modes]
    dense, hidden = unit_layout(units[0])
    bf = torch.bfloat16
    st = {}
    names = ["w1", "b1"]
    if dense:
        for i in hidden:
            names += [f"w{i}", f"b{i}"]
    for name in names:
        st[name] = torch.stack([u[name] for u in units]).to(bf)
    if not dense:
        st["hw"] = torch.stack([torch.stack([u[f"w{i}"] for u in units])
                                for i in hidden]).to(bf)     # (D, M, nf, nf)
        st["hb"] = torch.stack([torch.stack([u[f"b{i}"] for u in units])
                                for i in hidden]).to(bf)     # (D, M, nf)
    v = upscale * upscale
    w6s, b6s = [], []
    for u in units:
        w6, b6 = u["w6"], u["b6"]
        cols, bs = [], []
        for r in range(4):
            perm = lane_rotation_perm(upscale, r) if v > 1 else np.array([0])
            idx = torch.as_tensor(perm, device=w6.device)
            wp, bp = w6[:, idx], b6[idx]
            if v < _LANES:
                wp = torch.nn.functional.pad(wp, (0, _LANES - v))
                bp = torch.nn.functional.pad(bp, (0, _LANES - v))
            cols.append(wp)
            bs.append(bp)
        w6s.append(torch.cat(cols, dim=1))
        b6s.append(torch.cat(bs))
    st["w6"] = torch.stack(w6s).to(bf)          # (M, nf_in, 64)
    st["b6"] = torch.stack(b6s).to(bf)          # (M, 64)
    return st


def transpose_plain_stack(stacked: dict) -> dict:
    """Site-major stack -> feature-major (output-row-major) weights, as
    `mulut_tpu.ops.unit_kernel.transpose_plain_stack`; contiguous.  Plain
    and dense stacks alike; this is the layout both kernels read."""
    def t(a, dims):
        return a.permute(dims).contiguous()

    out = {"w1t": t(stacked["w1"], (0, 2, 1)), "b1": stacked["b1"],
           "w6t": t(stacked["w6"], (0, 2, 1)), "b6": stacked["b6"]}
    if "hw" in stacked:
        out["hwt"] = t(stacked["hw"], (0, 1, 3, 2))
        out["hb"] = stacked["hb"]
        return out
    for k in (2, 3, 4, 5):
        if f"w{k}" in stacked:
            out[f"w{k}t"] = t(stacked[f"w{k}"], (0, 2, 1))
            out[f"b{k}"] = stacked[f"b{k}"]
    return out


def window_offsets(modes: str):
    """Deduplicated (dy, dx) tap shifts across all modes x rotations,
    sorted; P is the uniform halo (edge replication is idempotent, so one
    pad of P serves every mode)."""
    P = max(mode_pad(m) for m in modes)
    offs = sorted({o for m in modes for r in range(4)
                   for o in rotated_taps(m, r)})
    return P, offs


def plane_tap_offsets(modes: str, width: int) -> list:
    """Flat-plane offset dy*width + dx of every [mode][rotation][tap]."""
    return [[[dy * width + dx for dy, dx in rotated_taps(m, r)]
             for r in range(4)] for m in modes]


# ---------------------------------------------------------------------------
# Stage mixes (shared by K3's epilogue, K4's torch glue, the f32 path and
# every plain version)
# ---------------------------------------------------------------------------


def inner_mix(acc: torch.Tensor, n_modes: int,
              dtype=torch.bfloat16) -> torch.Tensor:
    """Inner-stage mix clip(round(acc / (4M) + 127), 0, 255) / 255.

    `acc / (4M) + 127` is computed as XLA computes it under jit: one fused
    multiply-add fma(acc, float32(1/(4M)), 127), rounded once to float32
    (the float64 product and sum of these integer accumulators are exact).
    An exact division rounds differently on ties (acc = 6 mod 12 at M=3).
    `/ 255` is likewise XLA's multiply by float32(1/255).  Rounding is half
    to even.  Returns `dtype` (bf16 on the fast path, float32 on the f32
    path)."""
    c = float(np.float32(1.0 / (4 * n_modes)))
    y = (acc.to(torch.float64) * c + 127.0).to(torch.float32)
    mixed = torch.clamp(torch.round(y), 0, 255)
    return (mixed * _INV255).to(dtype)


def final_mix(acc: torch.Tensor, n_modes: int) -> torch.Tensor:
    """Final-stage mix round(acc / M), float32 (never a tie: acc is an
    integer and M = 3 divides to thirds)."""
    return torch.round(acc / n_modes)


def _pack_rows(vi: torch.Tensor) -> torch.Tensor:
    """(16, N) sub-pixel values in [0, 255], row 4*sy + sx -> (4, N) int32
    whose little-endian byte sx of word sy is that value."""
    n = vi.shape[1]
    b = vi.to(torch.uint8).reshape(4, 4, n).permute(0, 2, 1).contiguous()
    return b.view(torch.int32).reshape(4, n)


def _apply_mix(acc: torch.Tensor, mix, n_modes: int) -> torch.Tensor:
    """K3's epilogue on the (16, N) float32 accumulator."""
    if mix is None:
        return acc
    if mix == "inner":
        return inner_mix(acc[:1], n_modes)
    vi = final_mix(acc, n_modes)
    if mix == "final":
        return vi
    vi = torch.clamp(vi, 0, 255)
    if mix == "final_u8":
        return vi.to(torch.bfloat16)
    return _pack_rows(vi)


def _mix_rows(mix):
    if mix == "inner":
        return 1, torch.bfloat16
    if mix == "final_pack":
        return 4, torch.int32
    return _LANES, torch.bfloat16 if mix == "final_u8" else torch.float32


def _check_device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _f32(a):
    return a.to(torch.float32)


def _bf(a):
    return a.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K3: plain window kernel
# ---------------------------------------------------------------------------


def stage_ensemble_apply_w_plain(stacked_t: dict, plane: torch.Tensor, *,
                                 modes: str, width: int,
                                 mix=None) -> torch.Tensor:
    """Plain torch version of `stage_ensemble_apply_w` (same contract):
    float32 matmuls over the bf16-valued operands, chunked over sites."""
    M = len(modes)
    n = plane.shape[0]
    offs = plane_tap_offsets(modes, width)
    S = max(abs(o) for m in offs for r in m for o in r)
    flat = torch.nn.functional.pad(_f32(plane), (S, S))
    w1t, b1 = _f32(stacked_t["w1t"]), _f32(stacked_t["b1"])
    hwt, hb = _f32(stacked_t["hwt"]), _f32(stacked_t["hb"])
    w6t, b6 = _f32(stacked_t["w6t"]), _f32(stacked_t["b6"])
    rows, dtype = _mix_rows(mix)
    out = torch.empty((rows, n), dtype=dtype, device=plane.device)
    with full_f32_matmul():
        for c0 in range(0, n, _CHUNK):
            sites = torch.arange(c0, min(n, c0 + _CHUNK), device=plane.device)
            acc = torch.zeros((sites.shape[0], _LANES), device=plane.device)
            for mi in range(M):
                for r in range(4):
                    t = torch.stack([flat[S + o + sites] for o in offs[mi][r]],
                                    dim=1)                        # (n_c, 4)
                    x = _bf(torch.relu(t @ w1t[mi].T + b1[mi]))
                    for d in range(hwt.shape[0]):
                        x = _bf(torch.relu(_f32(x) @ hwt[d, mi].T + hb[d, mi]))
                    sl = slice(_LANES * r, _LANES * (r + 1))
                    o = torch.tanh(_f32(x) @ w6t[mi, sl].T + b6[mi, sl])
                    acc += torch.round(o * 127.0)
            out[:, c0: c0 + sites.shape[0]] = _apply_mix(acc.T, mix, M)
    return out


class _PlainDesc(ctypes.Structure):
    """Mirror of `PlainParams` in csrc/plain_window.cu (same field order)."""

    _fields_ = [
        ("plane", ctypes.c_void_p),
        ("w1t", ctypes.c_void_p),
        ("b1", ctypes.c_void_p),
        ("hwt", ctypes.c_void_p),
        ("hb", ctypes.c_void_p),
        ("w6t", ctypes.c_void_p),
        ("b6", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("modes", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("v", ctypes.c_int),
        ("inv_4m", ctypes.c_float),
        ("offs", ctypes.c_int * (_MAX_MODES * 16)),
    ]


@functools.cache
def _plain_fn():
    fn = library("plain_window").plain_window
    fn.argtypes = [ctypes.POINTER(_PlainDesc), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_stack(st: dict, keys, what: str):
    for k in keys:
        if k not in st:
            raise ValueError(f"{what} stack lacks {k!r}")
        if st[k].dtype != torch.bfloat16:
            raise ValueError(f"{what} stack: {k} must be bfloat16, got "
                             f"{st[k].dtype}")


def stage_ensemble_apply_w(stacked_t: dict, plane: torch.Tensor, *,
                           modes: str, width: int, mix=None,
                           v: int | None = None):
    """One plain-unit cascade stage over the flat edge-padded plane.

    stacked_t: `transpose_plain_stack` of a plain `stack_stage_params`
    (bf16).  plane: (N,) bf16, the (B, C, Hp, Wp) image edge-padded by the
    `window_offsets` halo on all sides and flattened; width = Wp.  Taps
    that fall outside [0, N) read 0; pad-band sites compute values the
    caller crops.  v: the unit's real output lanes (default 16); the
    kernel skips the output-head columns past them, whose lanes are zero
    padding.  Returns (rows, N) per `MIXES`: (16, N) float32 for None and
    "final", (16, N) bf16 for "final_u8", (1, N) bf16 for "inner", (4, N)
    int32 for "final_pack".
    """
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    _check_stack(stacked_t, ("w1t", "b1", "hwt", "hb", "w6t", "b6"),
                 "plain")
    if plane.dim() != 1 or plane.dtype != torch.bfloat16:
        raise ValueError(f"plane must be a 1-D bfloat16 tensor, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    M = len(modes)
    D, M_, nf, _ = stacked_t["hwt"].shape
    if M_ != M or stacked_t["w6t"].shape != (M, 4 * _LANES, nf):
        raise ValueError(f"stack does not match {M} modes")
    ts = [stacked_t[k] for k in ("w1t", "b1", "hwt", "hb", "w6t", "b6")]
    dev = _check_device(plane, *ts)
    if dev.type == "cpu":
        return stage_ensemble_apply_w_plain(stacked_t, plane, modes=modes,
                                            width=width, mix=mix)
    if nf != _PLAIN_NF or M > _MAX_MODES:
        raise NotImplementedError(
            f"the CUDA window kernel is built for nf={_PLAIN_NF} and at "
            f"most {_MAX_MODES} modes; got nf={nf}, {M} modes")
    if not all(t.is_contiguous() for t in ts + [plane]):
        raise ValueError("stage_ensemble_apply_w needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (stacked_t["hwt"], stacked_t["w6t"])):
        raise ValueError("hwt and w6t must be 16-byte aligned")
    rows, dtype = _mix_rows(mix)
    n = plane.shape[0]
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    d = _PlainDesc()
    (d.plane, d.w1t, d.b1, d.hwt, d.hb, d.w6t, d.b6) = [
        t.data_ptr() for t in [plane] + ts]
    d.out, d.n, d.modes, d.depth = out.data_ptr(), n, M, D
    d.v = _LANES if v is None else v
    d.inv_4m = float(np.float32(1.0 / (4 * M)))
    for i, o in enumerate(o for m in plane_tap_offsets(modes, width)
                          for r in m for o in r):
        d.offs[i] = o
    with torch.cuda.device(dev):
        err = _plain_fn()(ctypes.byref(d), nf, MIXES.index(mix),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stage_ensemble_apply_w: CUDA error {err}")
    LAUNCHES["stage_ensemble_apply_w"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: dense ensemble kernel
# ---------------------------------------------------------------------------


def _dense_head(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """The JAX dense kernels' broadcast head, every product and partial
    sum rounded to bf16 in tap order, then + b1 in bf16 and ReLU.
    t (n, 4), w1 (4, nf), b1 (nf,), all bf16-valued."""
    x = None
    for k in range(4):
        term = _bf(_f32(t[:, k: k + 1]) * _f32(w1[k]))
        x = term if x is None else _bf(_f32(x) + _f32(term))
    return torch.relu(_bf(_f32(x) + _f32(b1)))


def stage_ensemble_apply_plain(stacked_t: dict, taps: torch.Tensor, *,
                               n_modes: int):
    """Plain torch version of `stage_ensemble_apply` (same contract)."""
    N = taps.shape[0]
    hidden = [k for k in (2, 3, 4, 5) if f"w{k}t" in stacked_t]
    out = torch.empty((N, _LANES), device=taps.device)
    with full_f32_matmul():
        for c0 in range(0, N, _CHUNK):
            tc = taps[c0: c0 + _CHUNK]
            acc = torch.zeros((tc.shape[0], _LANES), device=taps.device)
            for mi in range(n_modes):
                for r in range(4):
                    col = (mi * 4 + r) * 4
                    cat = _dense_head(tc[:, col: col + 4],
                                      stacked_t["w1t"][mi].T,
                                      stacked_t["b1"][mi])
                    for k in hidden:
                        xk = torch.relu(
                            _f32(cat) @ _f32(stacked_t[f"w{k}t"][mi]).T
                            + _f32(stacked_t[f"b{k}"][mi]))
                        cat = torch.cat([cat, _bf(xk)], dim=1)
                    sl = slice(_LANES * r, _LANES * (r + 1))
                    o = torch.tanh(_f32(cat) @ _f32(stacked_t["w6t"][mi, sl]).T
                                   + _f32(stacked_t["b6"][mi, sl]))
                    acc += torch.round(o * 127.0)
            out[c0: c0 + tc.shape[0]] = acc
    return out


class _DenseDesc(ctypes.Structure):
    """Mirror of `DenseParams` in csrc/dense_ensemble.cu."""

    _fields_ = [
        ("taps", ctypes.c_void_p),
        ("w1t", ctypes.c_void_p),
        ("b1", ctypes.c_void_p),
        ("wt", ctypes.c_void_p * 4),
        ("hb", ctypes.c_void_p * 4),
        ("w6t", ctypes.c_void_p),
        ("b6", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("modes", ctypes.c_int),
        ("v", ctypes.c_int),
    ]


@functools.cache
def _dense_fn():
    fn = library("dense_ensemble").dense_ensemble
    fn.argtypes = [ctypes.POINTER(_DenseDesc), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stage_ensemble_apply(stacked_t: dict, taps: torch.Tensor, *,
                         n_modes: int, v: int | None = None):
    """(N, 16*M) bf16 tap matrix -> (N, 16) float32 ensemble over a dense
    stack: the sum over modes and rotations of round(127 * unit(taps)),
    lanes already un-rotated.  stacked_t: `transpose_plain_stack` of a
    dense `stack_stage_params` (bf16).  Column block (mi*4 + r)*4 .. +4
    holds pass (mi, r)'s 4 taps.  v: as in `stage_ensemble_apply_w`.

    A quantized stack (`quant.kernel_stack`, key "hwqt") goes to K11,
    `stage_ensemble_apply_q`, as the JAX entry routes it.  The paired (K9)
    and site-major plain (K8) stacks that share this JAX entry are not
    ported: they raise NotImplementedError.
    """
    if "hwt" in stacked_t:
        raise NotImplementedError(
            "plain stacks run the window kernel (stage_ensemble_apply_w); "
            "the site-major plain schedules (K8) are not ported")
    if "hwqt" in stacked_t:
        return stage_ensemble_apply_q(stacked_t, taps, n_modes=n_modes, v=v)
    if "hwq" in stacked_t:
        raise ValueError(
            "a quantized stack in the JAX package's layout (hwq); K11 "
            "reads quant.kernel_stack's layout (hwqt)")
    keys = ["w1t", "b1", "w2t", "b2", "w3t", "b3", "w4t", "b4", "w5t", "b5",
            "w6t", "b6"]
    _check_stack(stacked_t, keys, "dense")
    nf = stacked_t["w1t"].shape[1]
    if stacked_t["w2t"].shape[1] != nf:
        raise NotImplementedError(
            "rotation-paired stacks (K9) are a later slice of the port")
    if (taps.dim() != 2 or taps.shape[1] != 16 * n_modes
            or taps.dtype != torch.bfloat16):
        raise ValueError(f"taps must be (N, {16 * n_modes}) bfloat16, got "
                         f"{tuple(taps.shape)} {taps.dtype}")
    if stacked_t["w6t"].shape != (n_modes, 4 * _LANES, 5 * nf):
        raise ValueError(f"stack does not match {n_modes} modes")
    ts = [stacked_t[k] for k in keys]
    dev = _check_device(taps, *ts)
    if dev.type == "cpu":
        return stage_ensemble_apply_plain(stacked_t, taps, n_modes=n_modes)
    if nf != _DENSE_NF:
        raise NotImplementedError(
            f"the CUDA dense kernel is built for nf={_DENSE_NF}; got nf={nf}")
    if not all(t.is_contiguous() for t in ts + [taps]):
        raise ValueError("stage_ensemble_apply needs contiguous tensors")
    if taps.data_ptr() % 8 or any(
            stacked_t[k].data_ptr() % 16 for k in keys[2::2]):
        raise ValueError("taps must be 8-byte and w2t..w6t 16-byte aligned")
    N = taps.shape[0]
    out = torch.empty((N, _LANES), dtype=torch.float32, device=dev)
    d = _DenseDesc()
    d.taps, d.w1t, d.b1 = (taps.data_ptr(), stacked_t["w1t"].data_ptr(),
                           stacked_t["b1"].data_ptr())
    for i, k in enumerate((2, 3, 4, 5)):
        d.wt[i] = stacked_t[f"w{k}t"].data_ptr()
        d.hb[i] = stacked_t[f"b{k}"].data_ptr()
    d.w6t, d.b6 = stacked_t["w6t"].data_ptr(), stacked_t["b6"].data_ptr()
    d.out, d.n, d.modes = out.data_ptr(), N, n_modes
    d.v = _LANES if v is None else v
    with torch.cuda.device(dev):
        err = _dense_fn()(ctypes.byref(d), nf,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stage_ensemble_apply: CUDA error {err}")
    LAUNCHES["stage_ensemble_apply"] += 1
    return out


# ---------------------------------------------------------------------------
# K11: W8A8 plain ensemble kernel
# ---------------------------------------------------------------------------

_Q8_KEYS = ("w1t", "b1", "hwqt", "w6qt", "c6", "b6")
_RQ_INT = ("hmq", "hhq", "hsq", "hbi")     # the order Q8Params.rq takes
_RQ_F32 = ("hcq", "hbq")


def _q8_requant(a: torch.Tensor, st: dict, d: int, mi: int) -> torch.Tensor:
    """Layer d's next int8 codes (as float32) from its exact sums `a`:
    clip(((a * hmq + hhq) >> hsq) + hbi, 0, 127) in int32, or
    clip(round(relu(fma(a, hcq, hbq))), 0, 127); the float64 form of the
    multiply-add rounds once to float32, as XLA's fused one does."""
    if "hmq" in st:
        ti = a.to(torch.int32) * st["hmq"][d, mi] + st["hhq"][d, mi]
        ti = torch.bitwise_right_shift(ti, st["hsq"][d, mi])
        return torch.clamp(ti + st["hbi"][d, mi], 0, 127).to(torch.float32)
    y = (a.to(torch.float64) * st["hcq"][d, mi].to(torch.float64)
         + st["hbq"][d, mi].to(torch.float64)).to(torch.float32)
    return torch.clamp(torch.round(torch.relu(y)), 0, 127)


def stage_ensemble_apply_q_plain(st: dict, taps: torch.Tensor, *,
                                 n_modes: int) -> torch.Tensor:
    """Plain torch version of `stage_ensemble_apply_q` (same contract).
    The int8 products run as float32 matmuls (TF32 off), which are exact:
    every partial sum is an integer below 127 * 127 * nf < 2^24."""
    from .quant import k32_feature_order

    N = taps.shape[0]
    nf = st["w1t"].shape[1]
    inv = torch.as_tensor(np.argsort(k32_feature_order(nf)),
                          device=taps.device)
    hw = _f32(st["hwqt"][..., inv])           # (D, M, out, in), feature order
    w6 = _f32(st["w6qt"][..., inv])           # (M, 64, in)
    out = torch.empty((N, _LANES), device=taps.device)
    with full_f32_matmul():
        for c0 in range(0, N, _CHUNK):
            tc = taps[c0: c0 + _CHUNK]
            acc = torch.zeros((tc.shape[0], _LANES), device=taps.device)
            for mi in range(n_modes):
                for r in range(4):
                    col = (mi * 4 + r) * 4
                    x = _dense_head(tc[:, col: col + 4], st["w1t"][mi].T,
                                    st["b1"][mi])
                    x = torch.clamp(torch.round(_f32(x)), 0, 127)
                    for d in range(hw.shape[0]):
                        x = _q8_requant(x @ hw[d, mi].T, st, d, mi)
                    sl = slice(_LANES * r, _LANES * (r + 1))
                    o = ((x @ w6[mi, sl].T).to(torch.float64)
                         * st["c6"][mi, sl].to(torch.float64)
                         + st["b6"][mi, sl].to(torch.float64))
                    acc += torch.round(torch.tanh(_f32(o)) * 127.0)
            out[c0: c0 + tc.shape[0]] = acc
    return out


class _Q8Desc(ctypes.Structure):
    """Mirror of `Q8Params` in csrc/plain_w8a8.cu."""

    _fields_ = [
        ("taps", ctypes.c_void_p),
        ("w1t", ctypes.c_void_p),
        ("b1", ctypes.c_void_p),
        ("hwq", ctypes.c_void_p),
        ("rq", ctypes.c_void_p * 4),
        ("w6q", ctypes.c_void_p),
        ("c6", ctypes.c_void_p),
        ("b6", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("modes", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("v", ctypes.c_int),
    ]


@functools.cache
def _q8_fn():
    fn = library("plain_w8a8").plain_w8a8
    fn.argtypes = [ctypes.POINTER(_Q8Desc), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_q8_stack(st: dict, n_modes: int):
    """Keys, dtypes and shapes of a `quant.kernel_stack`; returns
    (depth, nf, requant constant keys)."""
    rq = _RQ_INT if "hmq" in st else _RQ_F32
    want = {"w1t": torch.bfloat16, "b1": torch.bfloat16,
            "hwqt": torch.int8, "w6qt": torch.int8, "c6": torch.float32,
            "b6": torch.float32}
    want.update({k: torch.int32 if rq is _RQ_INT else torch.float32
                 for k in rq})
    for k, dt in want.items():
        if k not in st:
            raise ValueError(f"quantized stack lacks {k!r}")
        if st[k].dtype != dt:
            raise ValueError(f"quantized stack: {k} must be {dt}, got "
                             f"{st[k].dtype}")
    M, nf, _ = st["w1t"].shape
    D = st["hwqt"].shape[0]
    shapes = {"w1t": (n_modes, nf, 4), "b1": (n_modes, nf),
              "hwqt": (D, n_modes, nf, nf),
              "w6qt": (n_modes, 4 * _LANES, nf),
              "c6": (n_modes, 4 * _LANES), "b6": (n_modes, 4 * _LANES)}
    shapes.update({k: (D, n_modes, nf) for k in rq})
    for k, shape in shapes.items():
        if tuple(st[k].shape) != shape:
            raise ValueError(f"stack does not match {n_modes} modes: {k} is "
                             f"{tuple(st[k].shape)}, expected {shape}")
    return D, nf, rq


def stage_ensemble_apply_q(st: dict, taps: torch.Tensor, *, n_modes: int,
                           v: int | None = None) -> torch.Tensor:
    """(N, 16*M) bf16 tap matrix -> (N, 16) float32 ensemble over a W8A8
    quantized plain stack (`quant.kernel_stack`): per pass the bf16 head
    and its int8 codes, `depth` exact int8 layers with the stack's requant
    ("int" constants hmq.. or "f32" hcq/hbq), the int8 output head
    dequantized by fma(o, c6, b6), and acc += round(127 * tanh(.)).
    Columns and v as in `stage_ensemble_apply`.  The JAX twins are
    `_plain_q_kernel`, `_plain_qw6_kernel` and `_plain_q2_kernel`.
    """
    D, nf, rq = _check_q8_stack(st, n_modes)
    if (taps.dim() != 2 or taps.shape[1] != 16 * n_modes
            or taps.dtype != torch.bfloat16):
        raise ValueError(f"taps must be (N, {16 * n_modes}) bfloat16, got "
                         f"{tuple(taps.shape)} {taps.dtype}")
    ts = [st[k] for k in _Q8_KEYS + rq]
    dev = _check_device(taps, *ts)
    if dev.type == "cpu":
        return stage_ensemble_apply_q_plain(st, taps, n_modes=n_modes)
    if nf != _W8A8_NF:
        raise NotImplementedError(
            f"the CUDA W8A8 kernel (K11) is built for nf={_W8A8_NF}; got "
            f"nf={nf}")
    if not all(t.is_contiguous() for t in ts + [taps]):
        raise ValueError("stage_ensemble_apply_q needs contiguous tensors")
    if taps.data_ptr() % 8 or any(st[k].data_ptr() % 16
                                  for k in ("hwqt", "w6qt")):
        raise ValueError("taps must be 8-byte and hwqt, w6qt 16-byte "
                         "aligned")
    N = taps.shape[0]
    out = torch.empty((N, _LANES), dtype=torch.float32, device=dev)
    d = _Q8Desc()
    d.taps, d.w1t, d.b1 = (taps.data_ptr(), st["w1t"].data_ptr(),
                           st["b1"].data_ptr())
    d.hwq, d.w6q = st["hwqt"].data_ptr(), st["w6qt"].data_ptr()
    for i, k in enumerate(rq):
        d.rq[i] = st[k].data_ptr()
    d.c6, d.b6 = st["c6"].data_ptr(), st["b6"].data_ptr()
    d.out, d.n, d.modes, d.depth = out.data_ptr(), N, n_modes, D
    d.v = _LANES if v is None else v
    with torch.cuda.device(dev):
        err = _q8_fn()(ctypes.byref(d), nf, int(rq is _RQ_INT),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stage_ensemble_apply_q: CUDA error {err}")
    LAUNCHES["stage_ensemble_apply_q"] += 1
    return out
