"""SRNets cascades over tap-MLP units: the f32 forward, its band-tiled
form, and the fast (bf16) forward through the stage-ensemble kernels;
one unit over a padded batch (`srnet_apply`), and the task models: the
x1 cascade of denoising and deblocking (`init_dnnets`, `dnnets_predict`)
and the 2x2 bayer-cell demosaic unit (`init_dmnet`, `dmnet_apply`).

Torch twin of the net-mode parts of `mulut_tpu.models.srnet`.  A model is
a params dict {"s{stage}_{mode}": unit params} (tensors, see
`torch_import.params_from_numpy`) plus the static (modes, stages, scale).
The four sampled pixels of every site are four shifted views of the padded
image; the 4-rotation ensemble reads the same all-sides-padded image
through rotated tap offsets and un-rotates the output lanes with a static
permutation (ref: sr/1_train_model.py:26-45).

`srnets_predict_fast` takes the JAX package's kernel routes, chosen by the
same module flags (read at call time):

- plain (mxu-arch) stacks run, with `PLAIN_LAYOUT = "feature"` (the
  default), the window kernel K3 (`PLAIN_WINDOW`) or the feature-major
  tap-matrix kernel K6, both with the stage mix in their epilogue; with
  `PLAIN_LAYOUT = "site"` the site-major tap-matrix kernel K8, its mix in
  the epilogue too and its head per `ops.unit_kernel.PLAIN_HEAD`;
- dense stacks run the site-major ensemble kernel K4 over the tap matrix
  with the mix in torch (`DENSE_LAYOUT = "site"`, the default), or with
  `DENSE_LAYOUT = "feature"` the dense window kernel K5 (`PLAIN_WINDOW`)
  or the feature-major tap-matrix kernel K7, both with the mix in their
  epilogue;
- rotation-paired dense stacks (`stack_srnets_for_fast(paired=True)`) run
  K9 and W8A8 quantized plain stacks (`ops.quant`) K11, both site-major
  whatever `DENSE_LAYOUT` says.

`srnets_predict(unit_impl="pallas")` runs each dense unit through the
single-unit kernel K10.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import unit_kernel as uk
from ..ops.ensemble import _pad_all
from ..ops.simplex import clip, div_add, round_ste
from ..ops.taps import lane_rotation_perm, mode_pad, mode_taps, rotated_taps
from .blocks import apply_mulut_unit, init_mulut_unit, unit_layout


#: Plain-stack layout of `srnets_predict_fast`: "feature" (K3 with
#: `PLAIN_WINDOW`, else K6) or "site" (the (N, 16M) tap matrix, K8), as the
#: JAX package's flag of the same name.
PLAIN_LAYOUT = "feature"

#: Dense-stack layout of `srnets_predict_fast`: "site" (the (N, 16M) tap
#: matrix, K4) or "feature" (K5 with `PLAIN_WINDOW`, else K7), as the JAX
#: package's flag of the same name.
DENSE_LAYOUT = "site"

#: Feature-layout stages read their taps from the padded plane (K3, K5);
#: MULUT_PLAIN_WINDOW=0 pins the feature-major tap-matrix kernels (K6 for
#: plain stacks, K7 for dense), as in the JAX package.
PLAIN_WINDOW = os.environ.get("MULUT_PLAIN_WINDOW", "1") != "0"


def init_srnets(rng: np.random.Generator, *, nf: int = 64, scale: int = 4,
                modes: str = "sdy", stages: int = 2, arch: str = "dense",
                depth: int | None = None) -> dict:
    """Stage x mode registry of MuLUT units (ref: sr/model.py:15-31) as
    float32 NumPy arrays, Kaiming-normal from `rng`.  arch "dense" is the
    reference (depth-4 dense-concat); "mxu" is the plain MLP of depth
    `depth` (default 2; a tuple or list gives each stage its own).  The
    last stage upscales by `scale`."""
    if arch not in ("dense", "mxu"):
        raise ValueError(f"unknown arch {arch!r}: expected 'dense' or 'mxu'")
    dense = arch == "dense"
    if depth is None:
        depth = 4 if dense else 2
    params = {}
    for s in range(stages):
        upscale = scale if s + 1 == stages else 1
        d_s = depth[s] if isinstance(depth, (tuple, list)) else depth
        for mode in modes:
            params[f"s{s + 1}_{mode}"] = init_mulut_unit(
                rng, nf=nf, upscale=upscale, dense=dense, depth=d_s)
    return params


def srnet_apply(unit_params: dict, x: torch.Tensor, *, mode: str,
                upscale: int) -> torch.Tensor:
    """One unit over a padded batch: x (B, C, H, W) in [0, 1], already
    replicate-padded bottom/right by `mode_pad(mode)` (the caller pads,
    ref: sr/1_train_model.py:34) -> (B, C, h*upscale, w*upscale) in
    (-1, 1), h = H - pad, the unit's lanes interleaved as a pixel
    shuffle."""
    pad = mode_pad(mode)
    B, C, H, W = x.shape
    h, w = H - pad, W - pad
    planes = [x[..., dy: dy + h, dx: dx + w] for dy, dx in mode_taps(mode)]
    taps = torch.stack(planes, dim=-1)
    out = apply_mulut_unit(unit_params, taps.reshape(-1, 4))
    return _interleave_nchw(out.reshape(B, C, h, w, upscale * upscale),
                            upscale)


def unit_upscale(stage: int, stages: int, scale: int) -> int:
    return scale if stage == stages else 1


def _rotation_taps_batch(x: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, C, H, W) -> (4, B, C, H, W, 4) tap stacks of the 4 rotations,
    read from the edge-padded image through rotated tap offsets."""
    pad = mode_pad(mode)
    h, w = x.shape[-2], x.shape[-1]
    xp = _pad_all(x, pad)
    rots = []
    for r in range(4):
        planes = [xp[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                  for dy, dx in rotated_taps(mode, r)]
        rots.append(torch.stack(planes, dim=-1))
    return torch.stack(rots, dim=0)


def srnet_rotation_lanes(unit_params: dict, x: torch.Tensor, *, mode: str,
                         upscale: int, unit_impl: str = "xla",
                         precision: str = "f32") -> torch.Tensor:
    """All-4-rotation unit outputs as un-rotated lanes:
    (4, B, C, H, W, upscale**2) in (-1, 1) for an unpadded x.  unit_impl
    "xla" runs `apply_mulut_unit` at `precision` ("f32" or "bf16",
    `blocks.PRECISIONS`); "pallas" runs a dense unit through the
    single-unit kernel K10 (bf16 params and x), and a plain unit through
    `apply_mulut_unit` as the JAX package does."""
    if unit_impl not in ("xla", "pallas"):
        raise ValueError(f"unit_impl must be 'xla' or 'pallas', got "
                         f"{unit_impl!r}")
    taps = _rotation_taps_batch(x, mode)
    shape = taps.shape
    if unit_impl == "pallas" and unit_layout(unit_params)[0]:
        out = uk.fused_unit_apply(unit_params, taps.reshape(-1, 4),
                                  out_dim=upscale * upscale)
    else:
        out = apply_mulut_unit(unit_params, taps.reshape(-1, 4),
                               precision=precision)
    out = out.reshape(*shape[:-1], upscale * upscale)
    if upscale > 1:
        out = torch.stack([
            out[r][..., torch.as_tensor(lane_rotation_perm(upscale, r),
                                        device=x.device)]
            for r in range(4)])
    return out


def _interleave_nchw(out: torch.Tensor, upscale: int) -> torch.Tensor:
    """(B, C, h, w, up*up) -> (B, C, h*up, w*up)."""
    B, C, h, w, _ = out.shape
    out = out.reshape(B, C, h, w, upscale, upscale)
    out = out.permute(0, 1, 2, 4, 3, 5)
    return out.reshape(B, C, h * upscale, w * upscale)


def srnets_predict(params: dict, x: torch.Tensor, *, modes: str, stages: int,
                   scale: int, phase: str = "valid",
                   unit_impl: str = "xla",
                   precision: str = "f32") -> torch.Tensor:
    """Cascade forward (ref: sr/1_train_model.py:26-45): per rotation the
    unit output is scaled by 127 and rounded before accumulating; inner
    stages mix with avg 4M, bias 127, clip and renormalize; the final stage
    mixes with avg M.  x: (B, C, H, W) in [0, 1].

    phase "valid" (the default here, the deployment form the evaluators
    call) returns values in about [0, 255]; phase "train" (the JAX
    package's default) divides them by 255 and is differentiable end to
    end: every round is `round_ste`, the inner mix `round_ste(clip(...))`,
    with JAX's gradients (`ops.simplex`).

    Float32 x and params run the float32 forward (the mixes in XLA's
    jitted form: `uk.inner_mix`, `div_add`).  bf16 x and params
    (`unit_impl="pallas"` on dense units: K10; valid phase only) keep the
    JAX package's dtype flow: every scale, round, sum (over float32 partial
    sums) and mix is a bf16 op.

    `precision` is the float32 units' matmul precision: "f32" (the
    default, the JAX package's Precision.HIGHEST) or "bf16" (its
    Precision.DEFAULT on a TPU, trainPrecision="bf16": matmul inputs
    rounded to bf16, `blocks.Bf16Dot`; everything else float32)."""
    if phase not in ("train", "valid"):
        raise ValueError(f"phase must be 'train' or 'valid', got {phase!r}")
    train = phase == "train"
    bf16 = x.dtype == torch.bfloat16
    if train and bf16:
        raise NotImplementedError(
            "the train phase takes float32 x (trainPrecision='bf16' keeps "
            "float32 tensors and rounds only the matmul inputs: pass "
            "precision='bf16')")
    rnd = round_ste if train else torch.round
    M = len(modes)
    for s in range(stages):
        stage = s + 1
        upscale = unit_upscale(stage, stages, scale)
        pred = 0.0
        for mode in modes:
            lanes = srnet_rotation_lanes(params[f"s{stage}_{mode}"], x,
                                         mode=mode, upscale=upscale,
                                         unit_impl=unit_impl,
                                         precision=precision)
            pred = pred + rnd(lanes * 127.0).sum(dim=0)
        if stage == stages:
            if train:
                x = _interleave_nchw(round_ste(div_add(pred, M, 0.0)),
                                     upscale) * uk._INV255
            else:
                x = _interleave_nchw(uk.final_mix(pred, M), upscale)
        elif train:
            mixed = round_ste(clip(div_add(pred[..., 0], 4 * M, 127.0),
                                   0.0, 255.0))
            x = mixed * uk._INV255
        elif bf16:
            mixed = torch.round(torch.clamp(pred / (4 * M) + 127.0, 0, 255))
            x = mixed[..., 0] / 255.0
        else:
            x = uk.inner_mix(pred[..., 0], M, dtype=torch.float32)
    return x


def srnets_predict_tiled(params: dict, x: torch.Tensor, *, modes: str,
                         stages: int, scale: int, band: int = 32,
                         halo: int = 4, axis: int = 2,
                         unit_impl: str = "xla") -> torch.Tensor:
    """Band-tiled `srnets_predict` for large images, identical to the
    untiled forward: bands of `band` rows (axis 2) or columns (axis 3) are
    evaluated in slabs with `halo` extra lines per side, clamped into the
    image (a true image edge keeps the cascade's own padding), and the
    kept band is written back; a last band that does not fit overlaps the
    previous one with identical values."""
    B, C = x.shape[:2]
    H = x.shape[axis]
    slab_h = band + 2 * halo
    assert H >= slab_h, (H, band, halo)
    n_bands = -(-H // band)
    out = torch.zeros((B, C, x.shape[2] * scale, x.shape[3] * scale),
                      dtype=x.dtype, device=x.device)
    for i in range(n_bands):
        kept0 = min(i * band, H - band)
        start = min(max(kept0 - halo, 0), H - slab_h)
        slab = x.narrow(axis, start, slab_h)
        o = srnets_predict(params, slab, modes=modes, stages=stages,
                           scale=scale, unit_impl=unit_impl)
        o = o.narrow(axis, (kept0 - start) * scale, band * scale)
        out.narrow(axis, kept0 * scale, band * scale).copy_(o)
    return out


def stack_srnets_for_fast(params: dict, *, modes: str, stages: int,
                          scale: int, paired: bool = False) -> list:
    """Per-stage bf16 stacks for `srnets_predict_fast`, in the layout the
    kernels read: `uk.transpose_plain_stack` of `uk.stack_stage_params`,
    made once here rather than on every forward; with `paired`, their
    rotation-pair form (`uk.pair_stage_params`, kernel K9; dense units
    only)."""
    stacks = [uk.transpose_plain_stack(uk.stack_stage_params(
        params, stage=s + 1, modes=modes,
        upscale=unit_upscale(s + 1, stages, scale))) for s in range(stages)]
    if paired:
        stacks = [uk.pair_stage_params(st) for st in stacks]
    return stacks


def _ensemble_taps(x: torch.Tensor, modes: str) -> torch.Tensor:
    """(B, C, H, W) -> (N, 16*M) bf16 tap matrix, column blocks ordered
    [mode][rotation][tap]."""
    N = x.numel()
    per_mode = [_rotation_taps_batch(x, m).reshape(4, N, 4) for m in modes]
    t = torch.stack(per_mode, dim=0).permute(2, 0, 1, 3)   # (N, M, 4, 4)
    return t.reshape(N, -1).to(torch.bfloat16)


def _ensemble_taps_t(x: torch.Tensor, modes: str) -> torch.Tensor:
    """(B, C, H, W) -> (16*M, N) bf16 feature-major tap matrix, rows
    ordered [mode][rotation][tap] (the transpose of `_ensemble_taps`)."""
    N = x.numel()
    rows = [_rotation_taps_batch(x, m).permute(0, 5, 1, 2, 3, 4).reshape(
        16, N) for m in modes]
    return torch.cat(rows, dim=0).to(torch.bfloat16)


def _window_plane(x: torch.Tensor, modes: str):
    """(B, C, H, W) bf16 -> (the flat plane of the image edge-padded by the
    `window_offsets` halo P on all sides, (Hp, Wp, P)).  Site p's tap
    (dy, dx) is plane[p + dy*Wp + dx]."""
    P, _ = uk.window_offsets(modes)
    xp = _pad_all(x, P)
    return xp.reshape(-1), (xp.shape[-2], xp.shape[-1], P)


def srnets_predict_fast(stacked_stages: list, x: torch.Tensor, *,
                        modes: str, stages: int, scale: int,
                        final_clip: bool | str = False) -> torch.Tensor:
    """Fast (bf16) deployment forward, one kernel launch per stage, routed
    as the module docstring says.

    stacked_stages: `stack_srnets_for_fast`, or the W8A8 stacks of
    `ops.quant.quantize_srnets_for_fast`.  x: (B, C, H, W) float in
    [0, 1] (cast to bf16).  Returns (B, C, H*s, W*s): float32
    round(acc / M) (final_clip False); on the routes with the mix in the
    kernel epilogue (plain stacks; dense ones under DENSE_LAYOUT
    "feature"), its clip to [0, 255] as bf16 (True) or, at x4 with
    final_clip "pack" on a feature-major route, uint8 from the kernel's
    packed words (the site-major K8 has no packed epilogue and takes
    "pack" as True); the other routes ignore final_clip, as in JAX.  An
    unknown layout flag raises ValueError.  Stage inputs and all stacks
    must be on one device: CUDA launches the kernels, CPU runs their plain
    versions.
    """
    M = len(modes)
    B, C, H, W = x.shape
    x = x.to(torch.bfloat16)
    for s in range(stages):
        stage = s + 1
        upscale = unit_upscale(stage, stages, scale)
        v = upscale * upscale
        st = stacked_stages[s]
        plain = "hwt" in st
        if plain:
            flag, layout = "PLAIN_LAYOUT", PLAIN_LAYOUT
        elif "w2t" in st and st["w2t"].shape[1] == st["w1t"].shape[1]:
            flag, layout = "DENSE_LAYOUT", DENSE_LAYOUT
        else:   # paired and quantized stacks are site-major forms only
            flag, layout = None, "site"
        if layout not in ("feature", "site"):
            raise ValueError(f"{flag} must be 'feature' or 'site', got "
                             f"{layout!r}")
        if layout == "feature":
            if PLAIN_WINDOW:       # K3 / K5 over the padded plane
                plane, (Hp, Wp, P) = _window_plane(x, modes)

                def run(mix, st=st, plane=plane, Wp=Wp, v=v):
                    return uk.stage_ensemble_apply_w(
                        st, plane, modes=modes, width=Wp, mix=mix, v=v)
            else:          # K6 / K7 over the feature-major tap matrix
                taps_t = _ensemble_taps_t(x, modes)
                Hp, Wp, P = H, W, 0

                def run(mix, st=st, taps_t=taps_t, v=v):
                    return uk.stage_ensemble_apply_t(
                        st, taps_t, n_modes=M, mix=mix, v=v)

            if stage < stages:
                xb = run("inner")[0]
                # pad-band sites hold garbage; the next stage re-pads
                x = xb.reshape(B, C, Hp, Wp)[:, :, P: P + H, P: P + W]
                continue
            if final_clip == "pack" and upscale == 4:
                b = run("final_pack").view(torch.uint8)       # (4, 4N)
                b = b.reshape(upscale, B, C, Hp, Wp, upscale)
                b = b[:, :, :, P: P + H, P: P + W, :]
                o = b.permute(1, 2, 3, 0, 4, 5)
                return o.reshape(B, C, H * upscale, W * upscale)
            o = run("final_u8" if final_clip else "final")[:v]
            o = o.reshape(upscale, upscale, B, C, Hp, Wp)
            o = o[:, :, :, :, P: P + H, P: P + W]
            o = o.permute(2, 3, 4, 0, 5, 1)
            return o.reshape(B, C, H * upscale, W * upscale)
        taps = _ensemble_taps(x, modes)
        if plain:                  # K8, the mix in its epilogue
            mix = ("inner" if stage < stages
                   else "final_u8" if final_clip else "final")
            out = uk.stage_ensemble_apply(st, taps, n_modes=M, v=v, mix=mix)
            if stage < stages:
                x = out[:, 0].reshape(B, C, H, W)
                continue
            out = out[:, :v]
        else:                      # K4, K9, K11: the mix in torch
            acc = uk.stage_ensemble_apply(st, taps, n_modes=M, v=v)
            if stage < stages:
                x = uk.inner_mix(acc[:, 0], M).reshape(B, C, H, W)
                continue
            out = uk.final_mix(acc[:, :v], M)
        out = out.reshape(B, C, H, W, upscale, upscale)
        out = out.permute(0, 1, 2, 4, 3, 5)
        return out.reshape(B, C, H * upscale, W * upscale)


def dnnet_apply(unit_params: dict, x: torch.Tensor, *,
                mode: str) -> torch.Tensor:
    """Denoising/deblocking wrapper: `srnet_apply` at stride 1, no
    upsampling (ref: common/network.py:229-272)."""
    return srnet_apply(unit_params, x, mode=mode, upscale=1)


def init_dnnets(rng: np.random.Generator, *, nf: int = 64,
                modes: str = "sdy", stages: int = 2) -> dict:
    """Stage x mode registry of x1 dense units for denoising/deblocking
    (the DNNet counterpart of SRNets; ref: common/network.py:229-272), as
    float32 NumPy arrays from `rng`."""
    return {f"s{s + 1}_{mode}": init_mulut_unit(rng, nf=nf, upscale=1,
                                                dense=True)
            for s in range(stages) for mode in modes}


def dnnets_predict(params: dict, x: torch.Tensor, *, modes: str,
                   stages: int, phase: str = "train") -> torch.Tensor:
    """The x1 (denoise/deblock) cascade: `srnets_predict` with every stage
    at upscale 1.  The default phase is "train", as in the JAX package
    (`srnets_predict`'s is "valid")."""
    return srnets_predict(params, x, modes=modes, stages=stages, scale=1,
                          phase=phase)


def init_dmnet(rng: np.random.Generator, *, nf: int = 64) -> dict:
    """Demosaicking unit: a 2x2 bayer cell -> a 3-channel 2x2 output, plain
    and of depth 4 (ref: common/network.py:276-317, MuLUTUnit('2x2', nf,
    upscale=2, out_c=3, dense=False)), float32 NumPy arrays from `rng`."""
    return init_mulut_unit(rng, nf=nf, upscale=2, out_c=3, dense=False)


def dmnet_apply(unit_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Demosaic forward: RGGB bayer (B, C, H, W) in [0, 1], H and W even
    (C is usually 1) -> (B, C*3, H, W) in (-1, 1).  Each non-overlapping
    2x2 cell's four pixels are four strided views (ref:
    common/network.py:296-317); the unit's 12 lanes are (out_c, 2, 2) in
    PixelShuffle order, interleaved back to full resolution."""
    B, C, H, W = x.shape
    h, w = H // 2, W // 2
    planes = [x[..., 0::2, 0::2], x[..., 0::2, 1::2],
              x[..., 1::2, 0::2], x[..., 1::2, 1::2]]
    taps = torch.stack(planes, dim=-1)
    out = apply_mulut_unit(unit_params, taps.reshape(-1, 4), dense=False)
    out = out.reshape(B, C, h, w, 3, 2, 2).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(B, C * 3, H, W)
