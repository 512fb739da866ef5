"""Standalone benchmark/demo harness (the counterpart of the fork's
sr/Test.py, ref: sr/Test.py:1-1351 — but driving the REAL MuLUT engine; the
fork demo's per-pixel heuristic LUT application is intentionally not
reproduced, see SURVEY.md §2.4.15), on the CUDA card unless `--device cpu`
is given.

Modes:
    python Test.py --lut_dir ../models/sr_x4sdy --input in.png --output out.png
    python Test.py --lut_dir ... --benchmark_dir ../data/SRBenchmark  # full run

`--yuv` applies the LUT cascade to luma only with bicubic chroma (the fork
demo's YUV pipeline, ref: sr/Test.py:317-398) — faster, slightly lower PSNR.
`--yuv-device` is the same pipeline run on the device with nothing back
on the host in between (color transforms + luma cascade + matmul-bicubic
chroma, uint8 in/out) — the throughput deployment form; works with both
--lut_dir (`LutEvaluator`) and --net (`NetEvaluator`).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from mulut_tpu_torch.pipelines.evaluate import LutEvaluator
from mulut_tpu_torch.utils import load_image, modcrop, psnr_ssim_y, save_image


def upscale_yuv(evaluator, img):
    """LUT cascade on Y; bicubic on U/V (ref: sr/Test.py:317-398)."""
    from PIL import Image

    from mulut_tpu_torch.utils.metrics import rgb2ycbcr, ycbcr2rgb

    scale = evaluator.scale
    ycc = rgb2ycbcr(img)
    # single-channel cascade pass: the engine is channel-agnostic, so luma
    # costs 1/3 of an RGB pass — the YUV mode's ~3x throughput win
    y = np.round(ycc[:, :, 0]).clip(0, 255).astype(np.uint8)
    y_sr = evaluator.upscale(y)
    h, w = img.shape[:2]
    cbcr = np.array(
        Image.fromarray(
            np.round(ycc[:, :, 1:]).clip(0, 255).astype(np.uint8)
        ).resize(
            (w * scale, h * scale), Image.BICUBIC
        )
    )
    out = np.concatenate([y_sr[:, :, None], cbcr], axis=2)
    return ycbcr2rgb(out.astype(np.float64))


def _pick_upscale(evaluator, *, yuv, device_yuv):
    """yuv: host path (PIL chroma — the fork-faithful form, ref:
    sr/Test.py:317-398); device_yuv: the on-device pipeline
    (evaluate.upscale_yuv — color transforms, luma cascade and
    matmul-bicubic chroma on the device; the throughput form)."""
    if device_yuv:
        return evaluator.upscale_yuv
    if yuv:
        return lambda img: upscale_yuv(evaluator, img)
    return evaluator.upscale


def run_benchmark(evaluator, bench_dir, datasets, *, yuv=False,
                  device_yuv=False):
    results = {}
    up = _pick_upscale(evaluator, yuv=yuv, device_yuv=device_yuv)
    for ds in datasets:
        hr_dir = os.path.join(bench_dir, ds, "HR")
        lr_dir = os.path.join(bench_dir, ds, f"LR_bicubic/X{evaluator.scale}")
        if not os.path.isdir(hr_dir):
            continue
        scores, times = [], []
        for f in sorted(os.listdir(hr_dir)):
            lr = load_image(os.path.join(lr_dir, f))
            gt = modcrop(load_image(os.path.join(hr_dir, f)), evaluator.scale)
            t0 = time.time()
            sr = up(lr)
            times.append(time.time() - t0)
            scores.append(psnr_ssim_y(gt, sr, evaluator.scale))
        arr = np.asarray(scores)
        results[ds] = {
            "psnr": round(float(arr[:, 0].mean()), 3),
            "ssim": round(float(arr[:, 1].mean()), 4),
            "avg_time_s": round(float(np.mean(times)), 3),
            "images": len(scores),
        }
        print(f"{ds}: PSNR {results[ds]['psnr']} SSIM {results[ds]['ssim']} "
              f"({results[ds]['avg_time_s']}s/img)")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--lut_dir", default=None,
                   help="LUT folder (required unless --net is given)")
    p.add_argument("--input", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--benchmark_dir", type=str, default=None)
    p.add_argument("--datasets", nargs="+",
                   default=["Set5", "Set14", "B100", "Urban100", "Manga109"])
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--modes", type=str, default="sdy")
    p.add_argument("--lut_name", type=str, default="LUT_ft")
    p.add_argument("--yuv", action="store_true")
    p.add_argument("--yuv-device", action="store_true", dest="yuv_device",
                   help="YUV mode fully on device (color transforms + "
                        "luma cascade + matmul-bicubic chroma) — the "
                        "throughput form of --yuv")
    p.add_argument("--bucket", type=int, default=0,
                   help="pad eval shapes up to multiples of this (one "
                        "dispatch serves many image sizes; output unchanged)")
    p.add_argument("--net", type=str, default=None, metavar="CKPT",
                   help="deploy the trained network (the bf16 stage-ensemble "
                        "kernels on the card) from this checkpoint instead of "
                        "LUT retrieval")
    p.add_argument("--quant", nargs="?", const="int", default=None,
                   choices=["f32", "f32w6", "int"],
                   help="with --net on a plain (mxu-arch) checkpoint: W8A8 "
                        "int8 deployment (ops/quant.py, kernel K11).  Optional value "
                        "selects the inter-layer requant datapath (default "
                        "'int' = integer fixed-point; 'f32'/'f32w6' are the "
                        "measured A/B forms)")
    p.add_argument("--results_json", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' for "
                        "the plain torch path on the host)")
    args = p.parse_args()

    if args.net:
        from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

        ev = NetEvaluator.from_checkpoint(
            args.net, stages=args.stages, modes=args.modes, scale=args.scale,
            fast=True, quant=args.quant or False, device=args.device,
        )
    else:
        if not args.lut_dir:
            p.error("--lut_dir is required unless --net is given")
        ev = LutEvaluator.from_folder(
            args.lut_dir, stages=args.stages, modes=args.modes,
            scale=args.scale, lut_name=args.lut_name, bucket=args.bucket,
            device=args.device,
        )
    if args.input:
        img = load_image(args.input)
        sr = _pick_upscale(ev, yuv=args.yuv, device_yuv=args.yuv_device)(img)
        out_path = args.output or args.input.replace(".", "_sr.", 1)
        save_image(out_path, sr)
        print(f"{args.input} {img.shape} -> {out_path} {sr.shape}")
    if args.benchmark_dir:
        results = run_benchmark(ev, args.benchmark_dir, args.datasets,
                                yuv=args.yuv, device_yuv=args.yuv_device)
        if args.results_json:
            with open(args.results_json, "w") as f:
                json.dump(results, f, indent=2)
