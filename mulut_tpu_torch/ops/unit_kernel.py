"""Whole-stage tap-MLP ensembles of net mode, with their CUDA kernels.

Torch twin of the net-mode paths of `mulut_tpu.ops.unit_kernel`.  One
launch evaluates all 4*M passes (M modes x 4 rotations) of one cascade
stage: per pass the unit's head over its 4 taps, the hidden layers, the
output head with the lane un-rotation baked into rotation r's w6 column
block, and `acc += round(127 * tanh(.))`; the rotation/mode sum stays in
the kernel.

- K3 `stage_ensemble_apply_w` (csrc/plain_window.cu) runs plain (mxu-arch)
  stacks.  It reads each pass's taps straight from the flat edge-padded
  plane (site p's tap (dy, dx) is p + dy*Wp + dx) and folds the cascade's
  stage mix into its epilogue (`MIXES`).  Given a dense stack the same
  wrapper runs K5 (csrc/dense_window.cu), the dense kernel over the plane
  with the same epilogues.
- K4 `stage_ensemble_apply` (csrc/dense_ensemble.cu) runs dense-concat
  stacks over an (N, 16*M) bf16 tap matrix and returns the raw (N, 16)
  accumulator; the mix runs in torch (`inner_mix`, `final_mix`).  Given a
  rotation-paired stack (`pair_stage_params`) it runs K9, the same kernel
  reading the paired weights' diagonal blocks.  Given a plain stack it
  runs K8 (csrc/plain_site.cu), K3's pass over the tap matrix with the
  head `PLAIN_HEAD` picks and a site-major mix epilogue (`SITE_MIXES`).
- K7 `stage_ensemble_apply_t` (csrc/dense_feature.cu) runs dense stacks
  over the feature-major (16*M, N) tap matrix, with K3's epilogues; given
  a plain stack it runs K6 (csrc/plain_feature.cu), K3's pass over that
  matrix.
- K11 `stage_ensemble_apply_q` (csrc/plain_w8a8.cu) runs W8A8 quantized
  plain stacks (`quant.py`) over the (N, 16*M) tap matrix, with K4's
  output and torch mix.
- K10 `fused_unit_apply` (csrc/dense_unit.cu) runs one dense unit alone
  over (N, 4) taps and returns bf16 tanh outputs.

K4, K5, K7, K9 and K10 share one pass body (csrc/dense_body.cuh), so K5,
K7 and K9 return K4's raw accumulator bit for bit; K3, K6 and K8 share
another (csrc/plain_body.cuh), so K6 and K8 with the float32 head return
K3's.  The plain body is built for nf=128 and nf=256; at nf=256 its
layers stream through shared memory, and the wrapper hands them over in
the order they stream, already swizzled (`ring_layers`).  The JAX
package runs K6 and K8 in several schedules
(`PLAIN_T_SCHEDULE`, `PLAIN_SCHEDULE`, `PLAIN_INTERLEAVE`), which only
reorder the TPU's instructions and give the same outputs; the port has no
such flags, and one kernel per contract stands for every schedule (the
tests hold it against each).

Numerics are the JAX kernels': bf16 weights and activations, float32
products summed in float32, float32 bias/ReLU/tanh, round half to even.
The dense kernels' and K11's head, and K8's under PLAIN_HEAD = "vpu", is
the JAX package's broadcast form with every product and partial sum
rounded to bf16; the plain kernels' default head is one float32 dot.
K11's hidden and output products are exact int8 x int8 -> int32 sums, and
its dequantizing multiply-adds are single-rounded, as XLA fuses them.  The
inner stage mix is XLA's jitted form of `round(acc / (4M) + 127)`: one
fused multiply-add by float32(1/(4M)).

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
#: K3 and K5 share the window wrapper, K4, K8 and K9 the tap-matrix one, K6
#: and K7 the feature-major one; each kernel has its own key ("_mxu_arch":
#: the plain units' K6 and K8).
LAUNCHES = {"stage_ensemble_apply_w": 0, "stage_ensemble_apply_w_dense": 0,
            "stage_ensemble_apply": 0, "stage_ensemble_apply_pair": 0,
            "stage_ensemble_apply_mxu_arch": 0, "stage_ensemble_apply_t": 0,
            "stage_ensemble_apply_t_mxu_arch": 0, "stage_ensemble_apply_q": 0,
            "fused_unit_apply": 0}

#: K3 epilogues (`_apply_stage_mix_t` of the JAX package): None = raw
#: accumulator; "inner" = the inner-stage mix as one bf16 row;
#: "final" = round(acc / M) f32; "final_u8" = its clip to [0, 255] as bf16;
#: "final_pack" = the x4 clip packed 4 sub-pixels per 32-bit word.
MIXES = (None, "inner", "final", "final_u8", "final_pack")
#: K8's site-major epilogues (`_apply_stage_mix` of the JAX package): the
#: same values as (N, 16) rows, "inner" as one (N, 1) column; no packed form.
SITE_MIXES = MIXES[:4]

#: The head of the plain units' site-major kernel K8, read at each call as
#: the JAX package's flag of the same name: "mxu", one float32 dot plus the
#: float32 bias (K3's head), or "vpu", the bf16 broadcast chain (every
#: product and partial sum rounded to bf16, then + b1 in bf16).  They are
#: different functions, not roundings of one.
PLAIN_HEAD = "mxu"
HEADS = ("mxu", "vpu")

_MAX_MODES = 6            # csrc/net_common.cuh kMaxModes
_LANES = 16               # output lanes per rotation (csrc kHeadRows / 4)
_PLAIN_NF = (128, 256)    # csrc/plain_*.cu instantiations (the artifacts)
_PLAIN_MAX_DEPTH = 4      # csrc/plain_body.cuh kMaxDepth
_DENSE_NF = 64            # csrc/dense_*.cu instantiation (reference)
_W8A8_NF = (128, 256)     # csrc/plain_w8a8.cu instantiations (the artifacts)
_SMEM_MAX = 232_448       # H100: a block's opt-in shared memory
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


def window_tap_rows(modes: str) -> tuple:
    """[mode][rotation][tap] -> index of its shift in `window_offsets`."""
    _, offs = window_offsets(modes)
    idx = {o: j for j, o in enumerate(offs)}
    return tuple(tuple(tuple(idx[o] for o in rotated_taps(m, r))
                       for r in range(4)) for m in modes)


def plane_tap_offsets(modes: str, width: int) -> list:
    """Flat-plane offset dy*width + dx of every [mode][rotation][tap]."""
    return [[[dy * width + dx for dy, dx in rotated_taps(m, r)]
             for r in range(4)] for m in modes]


def pair_stage_params(stacked_t: dict) -> dict:
    """Rotation-pair block-diagonal weights (K9's layout) from a dense
    stack in the kernels' layout: byte for byte `transpose_plain_stack` of
    the JAX package's `pair_stage_params`.  Layer k's (M, 2nf, 2(k-1)nf)
    weights hold the unpaired ones twice on the diagonal of each 2nf
    block, the (M, 64, 10nf) output head rotation r's columns in the first
    (r even) or second (r odd) half of each 2nf block; the off-diagonal
    blocks are zeros.  Biases b2..b5 are doubled, b1 and b6 unchanged."""
    if "hwt" in stacked_t:
        raise ValueError(
            "pair_stage_params expects dense-unit stacks; plain (mxu-arch) "
            "units run full-width matmuls already")
    M, nf, _ = stacked_t["w1t"].shape
    out = {"w1t": stacked_t["w1t"], "b1": stacked_t["b1"]}
    w = stacked_t["w2t"]
    z = torch.zeros((M, nf, nf), dtype=w.dtype, device=w.device)
    for k in (2, 3, 4, 5):
        wt = stacked_t[f"w{k}t"]                   # (M, nf, (k-1) nf)
        blocks = []
        for j in range(k - 1):
            c = wt[:, :, j * nf: (j + 1) * nf]
            blocks.append(torch.cat([torch.cat([c, z], dim=2),
                                     torch.cat([z, c], dim=2)], dim=1))
        out[f"w{k}t"] = torch.cat(blocks, dim=2).contiguous()
        out[f"b{k}"] = torch.cat([stacked_t[f"b{k}"]] * 2, dim=1)
    w6t = stacked_t["w6t"]                          # (M, 64, 5nf)
    zp = torch.zeros((M, _LANES, nf), dtype=w6t.dtype, device=w6t.device)
    blocks = []
    for j in range(5):
        rows = [w6t[:, _LANES * r: _LANES * (r + 1), j * nf: (j + 1) * nf]
                for r in range(4)]
        blocks.append(torch.cat(
            [torch.cat([rows[r], zp] if r % 2 == 0 else [zp, rows[r]],
                       dim=2) for r in range(4)], dim=1))
    out["w6t"] = torch.cat(blocks, dim=2).contiguous()   # (M, 64, 10nf)
    out["b6"] = stacked_t["b6"]
    return out


def _unpair_stage_params(paired_t: dict) -> dict:
    """The dense stack a `pair_stage_params` stack was made from: its
    diagonal blocks, as K9's kernel stages them."""
    M, nf, _ = paired_t["w1t"].shape
    out = {k: paired_t[k] for k in ("w1t", "b1", "b6")}
    for k in (2, 3, 4, 5):
        w = paired_t[f"w{k}t"][:, :nf].reshape(M, nf, k - 1, 2, nf)
        out[f"w{k}t"] = w[:, :, :, 0].reshape(M, nf, (k - 1) * nf)
        out[f"b{k}"] = paired_t[f"b{k}"][:, :nf]
    w6 = paired_t["w6t"].reshape(M, 4, _LANES, 5, 2, nf)
    out["w6t"] = torch.stack([w6[:, r, :, :, r % 2] for r in range(4)],
                             dim=1).reshape(M, 4 * _LANES, 5 * nf)
    return out


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
    b = vi.to(torch.uint8).reshape(4, 4, n).permute(0, 2, 1).reshape(-1)
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
# The plain-unit kernels: K3 (plane), K6 (feature-major tap matrix), K8
# (site-major tap matrix)
# ---------------------------------------------------------------------------

_PLAIN_KEYS = ("w1t", "b1", "hwt", "hb", "w6t", "b6")


def _plain_acc(st: dict, taps: torch.Tensor, n_modes: int,
               head: str = "mxu") -> torch.Tensor:
    """K3's passes over an (n, 16M) tap matrix -> (n, 16) raw accumulator
    (float32 matmuls over the bf16-valued operands); head "mxu" is the
    float32 dot, "vpu" the bf16 chain of `_dense_head`.  Call under
    `full_f32_matmul`."""
    w1t, b1 = _f32(st["w1t"]), _f32(st["b1"])
    hwt, hb = _f32(st["hwt"]), _f32(st["hb"])
    w6t, b6 = _f32(st["w6t"]), _f32(st["b6"])
    acc = torch.zeros((taps.shape[0], _LANES), device=taps.device)
    for mi in range(n_modes):
        for r in range(4):
            col = (mi * 4 + r) * 4
            t = _f32(taps[:, col: col + 4]).contiguous()
            if head == "mxu":
                x = _bf(torch.relu(t @ w1t[mi].T + b1[mi]))
            else:
                x = _dense_head(t, w1t[mi].T, b1[mi])
            for d in range(hwt.shape[0]):
                x = _bf(torch.relu(_f32(x) @ hwt[d, mi].T + hb[d, mi]))
            sl = slice(_LANES * r, _LANES * (r + 1))
            o = torch.tanh(_f32(x) @ w6t[mi, sl].T + b6[mi, sl])
            acc += torch.round(o * 127.0)
    return acc


def stage_ensemble_apply_w_plain(stacked_t: dict, plane: torch.Tensor, *,
                                 modes: str, width: int,
                                 mix=None) -> torch.Tensor:
    """Plain torch version of `stage_ensemble_apply_w` (same contract, K3
    or K5 by the stack), chunked over sites: each chunk's deduplicated
    plane shifts gathered once (`window_offsets`), its tap matrix indexed
    from them (`window_tap_rows`), then K3's passes or K4's."""
    M = len(modes)
    n = plane.shape[0]
    _, offs = window_offsets(modes)
    shifts = [dy * width + dx for dy, dx in offs]
    S = max(abs(o) for o in shifts)
    flat = torch.nn.functional.pad(_f32(plane), (S, S))
    cols = torch.as_tensor([j for m in window_tap_rows(modes) for r in m
                            for j in r], device=plane.device)
    acc_fn = _plain_acc if "hwt" in stacked_t else _dense_acc
    rows, dtype = _mix_rows(mix)
    out = torch.empty((rows, n), dtype=dtype, device=plane.device)
    with full_f32_matmul():
        for c0 in range(0, n, _CHUNK):
            sites = torch.arange(c0, min(n, c0 + _CHUNK), device=plane.device)
            win = torch.stack([flat[S + o + sites] for o in shifts], dim=1)
            acc = acc_fn(stacked_t, win[:, cols], M)
            out[:, c0: c0 + sites.shape[0]] = _apply_mix(acc.T, mix, M)
    return out


def _check_plane(plane: torch.Tensor):
    if plane.dim() != 1 or plane.dtype != torch.bfloat16:
        raise ValueError(f"plane must be a 1-D bfloat16 tensor, got "
                         f"{tuple(plane.shape)} {plane.dtype}")


def _check_stack(st: dict, keys, what: str):
    for k in keys:
        if k not in st:
            raise ValueError(f"{what} stack lacks {k!r}")
        if st[k].dtype != torch.bfloat16:
            raise ValueError(f"{what} stack: {k} must be bfloat16, got "
                             f"{st[k].dtype}")


def _check_plain_stack(st: dict, n_modes: int):
    """Keys, dtypes and shapes of a plain stack in the kernels' layout."""
    _check_stack(st, _PLAIN_KEYS, "plain")
    _, M, nf, _ = st["hwt"].shape
    if M != n_modes or st["w6t"].shape != (n_modes, 4 * _LANES, nf):
        raise ValueError(f"stack does not match {n_modes} modes")


class _PlainDesc(ctypes.Structure):
    """Mirror of `PlainParams` in csrc/plain_body.cuh (same field order)."""

    _fields_ = [
        ("taps", ctypes.c_void_p),
        ("w1t", ctypes.c_void_p),
        ("b1", ctypes.c_void_p),
        ("hwt", ctypes.c_void_p),
        ("hws", ctypes.c_void_p),
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


def ring_layers(hwt: torch.Tensor) -> torch.Tensor:
    """The nf=256 hidden layers (D, M, 256, 256) [d][m][out][in] in the
    order the plain kernels' ring streams them (csrc/plain_body.cuh,
    `plain_wide_kernel`): (M, D, 4, 2, 2, 64, 64), per mode, layer,
    quarter q of the outputs and half h of the inputs one 16 KB fill of 2
    K-blocks of 64 inputs, each 64 rows of 64 bf16 with a row's 16-byte
    chunk c at chunk c ^ (row % 8) (wgmma's 128-byte swizzle), so one bulk
    copy lands a fill as wgmma reads it."""
    D, M = hwt.shape[:2]
    x = hwt.reshape(D, M, 4, 64, 2, 2, 8, 8).permute(1, 0, 2, 4, 5, 3, 6, 7)
    r = torch.arange(64, device=hwt.device)[:, None]
    c = torch.arange(8, device=hwt.device)[None, :] ^ (r & 7)
    return x[..., r, c, :].contiguous()


@functools.cache
def _plain_fn(name: str):
    """The C entry `name` of csrc/{name}.cu: (params, nf, mix, [head,]
    stream) -> cudaError_t; only plain_site takes a head."""
    fn = getattr(library(name), name)
    fn.argtypes = ([ctypes.POINTER(_PlainDesc), ctypes.c_int, ctypes.c_int]
                   + ([ctypes.c_int] if name == "plain_site" else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_plain(name: str, st: dict, src: torch.Tensor, out: torch.Tensor,
                  *, n: int, modes: int, v, mix, head=None, offs=()):
    """Launch csrc/{name}.cu's entry on the current stream over the plain
    stack `st` (kernels' layout), the tap source `src` (n sites) and `out`,
    with epilogue `mix` (and, for K8, `head`)."""
    D, _, nf, _ = st["hwt"].shape
    if nf not in _PLAIN_NF or modes > _MAX_MODES or D > _PLAIN_MAX_DEPTH:
        widths = " and ".join(f"nf={w}" for w in _PLAIN_NF)
        raise NotImplementedError(
            f"the CUDA plain-unit kernels are built for {widths}, at most "
            f"{_MAX_MODES} modes and depth {_PLAIN_MAX_DEPTH}; got nf={nf}, "
            f"{modes} modes, depth {D}")
    ts = [st[k] for k in _PLAIN_KEYS]
    if not all(t.is_contiguous() for t in ts + [src]):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (st["hwt"], st["w6t"])):
        raise ValueError("hwt and w6t must be 16-byte aligned")
    # nf=256: the layers stream through shared memory in fill order
    hws = ring_layers(st["hwt"]) if nf == 256 else None
    d = _PlainDesc()
    (d.taps, d.w1t, d.b1, d.hwt, d.hb, d.w6t, d.b6) = [
        t.data_ptr() for t in [src] + ts]
    d.hws = None if hws is None else hws.data_ptr()
    d.out, d.n, d.modes, d.depth = out.data_ptr(), n, modes, D
    d.v = _LANES if v is None else v
    d.inv_4m = float(np.float32(1.0 / (4 * modes)))
    for i, o in enumerate(offs):
        d.offs[i] = o
    args = [ctypes.byref(d), nf, MIXES.index(mix)]
    if head is not None:
        args.append(HEADS.index(head))
    with torch.cuda.device(src.device):
        err = _plain_fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


# K3


def stage_ensemble_apply_w(stacked_t: dict, plane: torch.Tensor, *,
                           modes: str, width: int, mix=None,
                           v: int | None = None):
    """One cascade stage over the flat edge-padded plane: K3 for a plain
    stack, K5 for a dense one (no `hwt`, as the JAX entry tells them).

    stacked_t: `transpose_plain_stack` of a plain or dense
    `stack_stage_params` (bf16).  plane: (N,) bf16, the (B, C, Hp, Wp)
    image edge-padded by the `window_offsets` halo on all sides and
    flattened; width = Wp.  Taps that fall outside [0, N) read 0; pad-band
    sites compute values the caller crops.  v: the unit's real output
    lanes (default 16); the kernel skips the output-head columns past
    them, whose lanes are zero padding.  Returns (rows, N) per `MIXES`:
    (16, N) float32 for None and "final", (16, N) bf16 for "final_u8",
    (1, N) bf16 for "inner", (4, N) int32 for "final_pack".
    """
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    M = len(modes)
    if "hwt" not in stacked_t:
        return _dense_window(stacked_t, plane, modes=modes, width=width,
                             mix=mix, v=v)
    _check_plain_stack(stacked_t, M)
    _check_plane(plane)
    dev = _check_device(plane, *stacked_t.values())
    if dev.type == "cpu":
        return stage_ensemble_apply_w_plain(stacked_t, plane, modes=modes,
                                            width=width, mix=mix)
    rows, dtype = _mix_rows(mix)
    n = plane.shape[0]
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    offs = [o for m in plane_tap_offsets(modes, width) for r in m for o in r]
    _launch_plain("plain_window", stacked_t, plane, out, n=n, modes=M, v=v,
                  mix=mix, offs=offs)
    LAUNCHES["stage_ensemble_apply_w"] += 1
    return out


# ---------------------------------------------------------------------------
# The dense-unit kernels: K4 and K9 (tap matrix), K5 (plane), K7
# (feature-major tap matrix), K10 (one unit)
# ---------------------------------------------------------------------------

_DENSE_KEYS = ("w1t", "b1", "w2t", "b2", "w3t", "b3", "w4t", "b4", "w5t",
               "b5", "w6t", "b6")


def _dense_head(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """The JAX dense kernels' broadcast head, every product and partial
    sum rounded to bf16 in tap order, then + b1 in bf16 and ReLU.
    t (n, 4), w1 (4, nf), b1 (nf,), all bf16-valued."""
    x = None
    for k in range(4):
        term = _bf(_f32(t[:, k: k + 1]) * _f32(w1[k]))
        x = term if x is None else _bf(_f32(x) + _f32(term))
    return torch.relu(_bf(_f32(x) + _f32(b1)))


def _dense_pass(st: dict, t: torch.Tensor, mi: int, rows: slice):
    """One dense-unit pass of mode mi over (n, 4) taps: the head, the
    concat layers, and output-head rows `rows` of w6t before the tanh
    (float32).  Call under `full_f32_matmul`."""
    cat = _dense_head(t, st["w1t"][mi].T, st["b1"][mi])
    for k in (2, 3, 4, 5):
        xk = torch.relu(_f32(cat) @ _f32(st[f"w{k}t"][mi]).T
                        + _f32(st[f"b{k}"][mi]))
        cat = torch.cat([cat, _bf(xk)], dim=1)
    return _f32(cat) @ _f32(st["w6t"][mi, rows]).T + _f32(st["b6"][mi, rows])


def _dense_acc(st: dict, taps: torch.Tensor, n_modes: int) -> torch.Tensor:
    """K4's passes over an (n, 16M) tap matrix -> (n, 16) raw
    accumulator.  Call under `full_f32_matmul`."""
    acc = torch.zeros((taps.shape[0], _LANES), device=taps.device)
    for mi in range(n_modes):
        for r in range(4):
            col = (mi * 4 + r) * 4
            o = _dense_pass(st, taps[:, col: col + 4], mi,
                            slice(_LANES * r, _LANES * (r + 1)))
            acc += torch.round(torch.tanh(o) * 127.0)
    return acc


def _check_dense_stack(st: dict, n_modes: int, *, paired_ok: bool = False):
    """Keys, dtypes and shapes of a dense (or, with paired_ok, a
    rotation-paired) stack in the kernels' layout; returns (nf, paired)."""
    _check_stack(st, _DENSE_KEYS, "dense")
    nf = st["w1t"].shape[1]
    paired = st["w2t"].shape[1] == 2 * nf
    if paired and not paired_ok:
        raise ValueError("a rotation-paired stack runs the site-major tap "
                         "matrix (stage_ensemble_apply, K9) only")
    p = 2 if paired else 1
    shapes = {"w1t": (n_modes, nf, 4), "b1": (n_modes, nf),
              "w6t": (n_modes, 4 * _LANES, p * 5 * nf),
              "b6": (n_modes, 4 * _LANES)}
    for k in (2, 3, 4, 5):
        shapes[f"w{k}t"] = (n_modes, p * nf, p * (k - 1) * nf)
        shapes[f"b{k}"] = (n_modes, p * nf)
    for k, shape in shapes.items():
        if tuple(st[k].shape) != shape:
            raise ValueError(f"stack does not match {n_modes} modes: {k} is "
                             f"{tuple(st[k].shape)}, expected {shape}")
    return nf, paired


class _DenseDesc(ctypes.Structure):
    """Mirror of `DenseParams` in csrc/dense_body.cuh."""

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
        ("inv_4m", ctypes.c_float),
        ("offs", ctypes.c_int * (_MAX_MODES * 16)),
    ]


@functools.cache
def _dense_fn(name: str):
    """The C entry `name` of csrc/{name}.cu: (params, nf, [paired or mix,]
    stream) -> cudaError_t; dense_unit takes no third argument."""
    fn = getattr(library(name), name)
    fn.argtypes = ([ctypes.POINTER(_DenseDesc), ctypes.c_int]
                   + ([] if name == "dense_unit" else [ctypes.c_int])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_dense(name: str, st: dict, src: torch.Tensor, out: torch.Tensor,
                  *, n: int, modes: int, v: int, arg=None, offs=()):
    """Launch csrc/{name}.cu's entry on the current stream over the dense
    stack `st` (kernels' layout), the tap source `src` (n sites) and
    `out`; `arg` is the entry's paired flag or mix index."""
    nf = st["w1t"].shape[1]
    if nf != _DENSE_NF or modes > _MAX_MODES:
        raise NotImplementedError(
            f"the CUDA dense kernels are built for nf={_DENSE_NF} and at "
            f"most {_MAX_MODES} modes; got nf={nf}, {modes} modes")
    ts = [st[k] for k in _DENSE_KEYS]
    if not all(t.is_contiguous() for t in ts + [src]):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(st[k].data_ptr() % 16 for k in _DENSE_KEYS[2::2]):
        raise ValueError("w2t..w6t must be 16-byte aligned")
    d = _DenseDesc()
    d.taps, d.w1t, d.b1 = src.data_ptr(), ts[0].data_ptr(), ts[1].data_ptr()
    for i, k in enumerate((2, 3, 4, 5)):
        d.wt[i] = st[f"w{k}t"].data_ptr()
        d.hb[i] = st[f"b{k}"].data_ptr()
    d.w6t, d.b6 = st["w6t"].data_ptr(), st["b6"].data_ptr()
    d.out, d.n, d.modes, d.v = out.data_ptr(), n, modes, v
    d.inv_4m = float(np.float32(1.0 / (4 * modes)))
    for i, o in enumerate(offs):
        d.offs[i] = o
    args = [ctypes.byref(d), nf] + ([] if arg is None else [arg])
    with torch.cuda.device(src.device):
        err = _dense_fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


# K4, K8 and K9


def _plain_head() -> str:
    """`PLAIN_HEAD`, read at the call."""
    if PLAIN_HEAD not in HEADS:
        raise ValueError(f"PLAIN_HEAD must be one of {HEADS}, got "
                         f"{PLAIN_HEAD!r}")
    return PLAIN_HEAD


def stage_ensemble_apply_plain(stacked_t: dict, taps: torch.Tensor, *,
                               n_modes: int, mix=None):
    """Plain torch version of `stage_ensemble_apply`: K8 on plain stacks
    (K3's passes with `PLAIN_HEAD`'s head, then the site-major `mix`), K4
    on dense stacks and K9 on rotation-paired ones (through their diagonal
    blocks)."""
    if "hwt" in stacked_t:
        acc_fn = functools.partial(_plain_acc, head=_plain_head())
    else:
        acc_fn = _dense_acc
        if stacked_t["w2t"].shape[1] == 2 * stacked_t["w1t"].shape[1]:
            stacked_t = _unpair_stage_params(stacked_t)
    N = taps.shape[0]
    cols, dtype = _mix_rows(mix)
    out = torch.empty((N, cols), dtype=dtype, device=taps.device)
    with full_f32_matmul():
        for c0 in range(0, N, _CHUNK):
            tc = taps[c0: c0 + _CHUNK]
            acc = acc_fn(stacked_t, tc, n_modes)
            out[c0: c0 + tc.shape[0]] = _apply_mix(acc.T, mix, n_modes).T
    return out


def _check_taps(taps: torch.Tensor, n_modes: int):
    if (taps.dim() != 2 or taps.shape[1] != 16 * n_modes
            or taps.dtype != torch.bfloat16):
        raise ValueError(f"taps must be (N, {16 * n_modes}) bfloat16, got "
                         f"{tuple(taps.shape)} {taps.dtype}")


def stage_ensemble_apply(stacked_t: dict, taps: torch.Tensor, *,
                         n_modes: int, v: int | None = None, mix=None):
    """(N, 16*M) bf16 tap matrix -> (N, 16) ensemble: the sum over modes
    and rotations of round(127 * unit(taps)), lanes already un-rotated.
    Column block (mi*4 + r)*4 .. +4 holds pass (mi, r)'s 4 taps.  v: as
    in `stage_ensemble_apply_w`.

    stacked_t: `transpose_plain_stack` of a `stack_stage_params` (bf16).
    A dense stack runs K4 and its `pair_stage_params` K9; both return the
    raw float32 accumulator (mix None only).  A plain stack runs K8 with
    the head `PLAIN_HEAD` names and the site-major epilogue `mix` (one of
    `SITE_MIXES`): (N, 16) float32 for None and "final", (N, 16) bf16 for
    "final_u8", (N, 1) bf16 for "inner".  A quantized stack
    (`quant.kernel_stack`, key "hwqt") goes to K11,
    `stage_ensemble_apply_q`, as the JAX entry routes it.
    """
    if "hwt" in stacked_t:
        return _plain_site(stacked_t, taps, n_modes=n_modes, v=v, mix=mix)
    if mix is not None:
        raise ValueError("mix is only supported for plain (mxu-arch) stacks")
    if "hwqt" in stacked_t:
        return stage_ensemble_apply_q(stacked_t, taps, n_modes=n_modes, v=v)
    if "hwq" in stacked_t:
        raise ValueError(
            "a quantized stack in the JAX package's layout (hwq); K11 "
            "reads quant.kernel_stack's layout (hwqt)")
    _check_stack(stacked_t, _DENSE_KEYS, "dense")
    _check_taps(taps, n_modes)
    _, paired = _check_dense_stack(stacked_t, n_modes, paired_ok=True)
    dev = _check_device(taps, *(stacked_t[k] for k in _DENSE_KEYS))
    if dev.type == "cpu":
        return stage_ensemble_apply_plain(stacked_t, taps, n_modes=n_modes)
    if taps.data_ptr() % 8:
        raise ValueError("taps must be 8-byte aligned")
    N = taps.shape[0]
    out = torch.empty((N, _LANES), dtype=torch.float32, device=dev)
    _launch_dense("dense_ensemble", stacked_t, taps, out, n=N, modes=n_modes,
                  v=_LANES if v is None else v, arg=int(paired))
    LAUNCHES["stage_ensemble_apply_pair" if paired
             else "stage_ensemble_apply"] += 1
    return out


def _plain_site(st: dict, taps: torch.Tensor, *, n_modes: int, v, mix):
    """`stage_ensemble_apply` over a plain stack (K8)."""
    if mix not in SITE_MIXES:
        raise ValueError(f"the site-major plain kernel's mix must be one of "
                         f"{SITE_MIXES}, got {mix!r}")
    head = _plain_head()
    _check_plain_stack(st, n_modes)
    _check_taps(taps, n_modes)
    dev = _check_device(taps, *st.values())
    if dev.type == "cpu":
        return stage_ensemble_apply_plain(st, taps, n_modes=n_modes, mix=mix)
    if taps.data_ptr() % 8:
        raise ValueError("taps must be 8-byte aligned")
    cols, dtype = _mix_rows(mix)
    N = taps.shape[0]
    out = torch.empty((N, cols), dtype=dtype, device=dev)
    _launch_plain("plain_site", st, taps, out, n=N, modes=n_modes, v=v,
                  mix=mix, head=head)
    LAUNCHES["stage_ensemble_apply_mxu_arch"] += 1
    return out


# K5 (reached through stage_ensemble_apply_w)


def _dense_window(st: dict, plane: torch.Tensor, *, modes: str, width: int,
                  mix, v):
    """`stage_ensemble_apply_w` over a dense stack (K5)."""
    M = len(modes)
    _check_dense_stack(st, M)
    _check_plane(plane)
    dev = _check_device(plane, *(st[k] for k in _DENSE_KEYS))
    if dev.type == "cpu":
        return stage_ensemble_apply_w_plain(st, plane, modes=modes,
                                            width=width, mix=mix)
    rows, dtype = _mix_rows(mix)
    n = plane.shape[0]
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    offs = [o for m in plane_tap_offsets(modes, width) for r in m for o in r]
    _launch_dense("dense_window", st, plane, out, n=n, modes=M,
                  v=_LANES if v is None else v, arg=MIXES.index(mix),
                  offs=offs)
    LAUNCHES["stage_ensemble_apply_w_dense"] += 1
    return out


# K6 and K7


def stage_ensemble_apply_t_plain(stacked_t: dict, taps_t: torch.Tensor, *,
                                 n_modes: int, mix=None) -> torch.Tensor:
    """Plain torch version of `stage_ensemble_apply_t` (same contract, K6
    or K7 by the stack)."""
    acc_fn = _plain_acc if "hwt" in stacked_t else _dense_acc
    n = taps_t.shape[1]
    rows, dtype = _mix_rows(mix)
    out = torch.empty((rows, n), dtype=dtype, device=taps_t.device)
    with full_f32_matmul():
        for c0 in range(0, n, _CHUNK):
            tc = taps_t[:, c0: c0 + _CHUNK].T
            acc = acc_fn(stacked_t, tc, n_modes)
            out[:, c0: c0 + tc.shape[0]] = _apply_mix(acc.T, mix, n_modes)
    return out


def stage_ensemble_apply_t(stacked_t: dict, taps_t: torch.Tensor, *,
                           n_modes: int, mix=None, v: int | None = None):
    """(16*M, N) bf16 feature-major tap matrix (row (mi*4 + r)*4 + k holds
    pass (mi, r)'s tap k) -> (rows, N) per `MIXES`: the function of
    `stage_ensemble_apply` with `stage_ensemble_apply_w`'s epilogues, over
    a plain stack (K6: K3's passes, float32 head) or a dense one (K7).
    """
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    plain = "hwt" in stacked_t
    if plain:
        _check_plain_stack(stacked_t, n_modes)
    else:
        _check_dense_stack(stacked_t, n_modes)
    if (taps_t.dim() != 2 or taps_t.shape[0] != 16 * n_modes
            or taps_t.dtype != torch.bfloat16):
        raise ValueError(f"taps_t must be ({16 * n_modes}, N) bfloat16, got "
                         f"{tuple(taps_t.shape)} {taps_t.dtype}")
    dev = _check_device(taps_t, *stacked_t.values())
    if dev.type == "cpu":
        return stage_ensemble_apply_t_plain(stacked_t, taps_t,
                                            n_modes=n_modes, mix=mix)
    rows, dtype = _mix_rows(mix)
    n = taps_t.shape[1]
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    if plain:
        _launch_plain("plain_feature", stacked_t, taps_t, out, n=n,
                      modes=n_modes, v=v, mix=mix)
        LAUNCHES["stage_ensemble_apply_t_mxu_arch"] += 1
        return out
    _launch_dense("dense_feature", stacked_t, taps_t, out, n=n,
                  modes=n_modes, v=_LANES if v is None else v,
                  arg=MIXES.index(mix))
    LAUNCHES["stage_ensemble_apply_t"] += 1
    return out


# K10


def _unit_stack(params: dict, out_dim: int) -> dict:
    """One dense unit's bf16 params (w1 (4, nf) .. w6 (5nf, out_dim)) as a
    one-mode stack in the kernels' layout, the output head zero-padded to
    max(8, out_dim rounded up to 8) columns, as the JAX kernel pads it."""
    from ..models.blocks import unit_layout

    _check_stack(params, ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
                          "w5", "b5", "w6", "b6"), "dense unit")
    if not unit_layout(params)[0] or params["w6"].shape[1] != out_dim:
        raise ValueError(f"params are not a dense unit with {out_dim} "
                         f"outputs")
    pad = max(8, -(-out_dim // 8) * 8) - out_dim
    st = {"w1t": params["w1"].T, "b1": params["b1"],
          "w6t": torch.nn.functional.pad(params["w6"], (0, pad)).T,
          "b6": torch.nn.functional.pad(params["b6"], (0, pad))}
    for k in (2, 3, 4, 5):
        st[f"w{k}t"], st[f"b{k}"] = params[f"w{k}"].T, params[f"b{k}"]
    return {k: a[None].contiguous() for k, a in st.items()}


def fused_unit_apply_plain(params: dict, taps: torch.Tensor, *,
                           out_dim: int) -> torch.Tensor:
    """Plain torch version of `fused_unit_apply` (same contract)."""
    st = _unit_stack(params, out_dim)
    N = taps.shape[0]
    out = torch.empty((N, out_dim), dtype=torch.bfloat16, device=taps.device)
    with full_f32_matmul():
        for c0 in range(0, N, _CHUNK):
            tc = taps[c0: c0 + _CHUNK]
            o = _dense_pass(st, tc, 0, slice(0, out_dim))
            out[c0: c0 + tc.shape[0]] = _bf(torch.tanh(o))
    return out


def fused_unit_apply(params: dict, taps: torch.Tensor, *,
                     out_dim: int) -> torch.Tensor:
    """(N, 4) bf16 taps -> (N, out_dim) bf16 through one dense-concat unit
    (K10): the dense kernels' pass with the unit's own head (no rotation
    lanes), bf16(tanh(.)) out.  params: the unit's bf16 tensors in the
    `blocks.init_mulut_unit(dense=True)` layout.  The kernel's layout is
    made from them on every call (about 100 KB at nf=64)."""
    st = _unit_stack(params, out_dim)
    if taps.dim() != 2 or taps.shape[1] != 4 or taps.dtype != torch.bfloat16:
        raise ValueError(f"taps must be (N, 4) bfloat16, got "
                         f"{tuple(taps.shape)} {taps.dtype}")
    dev = _check_device(taps, *st.values())
    if dev.type == "cpu":
        return fused_unit_apply_plain(params, taps, out_dim=out_dim)
    if out_dim > _LANES:
        raise NotImplementedError(
            f"the CUDA unit kernel writes at most {_LANES} outputs; got "
            f"{out_dim}")
    if taps.data_ptr() % 8:
        raise ValueError("taps must be 8-byte aligned")
    N = taps.shape[0]
    v = st["w6t"].shape[1]
    out = torch.empty((N, v), dtype=torch.bfloat16, device=dev)
    _launch_dense("dense_unit", st, taps, out, n=N, modes=1, v=v)
    LAUNCHES["fused_unit_apply"] += 1
    return out[:, :out_dim]


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


def w8a8_smem_bytes(nf: int, depth: int, int_requant: bool,
                    modes: int) -> tuple[int, bool]:
    """(dynamic shared memory of a K11 launch, whether it stages all modes
    at once), as csrc/plain_w8a8.cu's `launch` picks them (`smem_bytes`).
    A mode's region: the int8 output head (64 x nf) and `depth` nf x nf
    layers, the head's weights (w1 in 16-byte feature-pair words, b1 in
    pair words), c6 and b6, the requant constants (4 words per column for
    "int", 2 for "f32").  All `modes` regions, each rounded up to 1 KB,
    where they fit a block; else the raw accumulators (16 float per site of
    a 768-site block) and one region.  Plus 1 KB to align the base."""
    region = (64 * nf + depth * nf * nf + 10 * nf + 2 * 64 * 4
              + depth * nf * (4 if int_requant else 2) * 4)
    every = modes * -(-region // 1024) * 1024 + 1024
    if every <= _SMEM_MAX:
        return every, True
    return 768 * 16 * 4 + region + 1024, False


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
    `_plain_q_kernel`, `_plain_qw6_kernel` and `_plain_q2_kernel`.  On the
    card nf is 128 or 256 and one mode's weights must fit a block's shared
    memory (`w8a8_smem_bytes`: depth 2 at nf=256); else NotImplementedError.
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
    if nf not in _W8A8_NF:
        raise NotImplementedError(
            f"the CUDA W8A8 kernel (K11) is built for nf in {_W8A8_NF}; got "
            f"nf={nf}")
    smem, _ = w8a8_smem_bytes(nf, D, rq is _RQ_INT, n_modes)
    if smem > _SMEM_MAX:
        raise NotImplementedError(
            f"the CUDA W8A8 kernel (K11) stages a mode's weights in shared "
            f"memory: {smem} B at nf={nf}, depth {D}, over the {_SMEM_MAX} B "
            "a block can have")
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
