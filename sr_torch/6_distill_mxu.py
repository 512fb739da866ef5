"""Step 6 (beyond the reference): distill a dense checkpoint into mxu units,
on the CUDA card unless `--device cpu` is given.

The reference workflow caches a trained dense network into LUT artifacts
(steps 2-3).  This tool compresses the same checkpoint into the plain-unit
`--arch mxu` deployment network instead — per-unit domain distillation
over the 17^4 transfer lattice + random/correlated samples
(pipelines/distill.py), optionally followed by image-space distillation of
the composed cascade onto the frozen teacher over crops of real LR
training images.  No ground-truth HR and no training dataset are required;
the teacher checkpoint IS the supervision.

Examples:
  python 6_distill_mxu.py --ckpt ../models/sr_x2sdy/Model_200000.pth \
      -e ../models/sr_x4sdy_mxu --depth 3
  python 6_distill_mxu.py --ckpt ... -e ... --e2e-images ../data/DIV2K/LR/X4 \
      --eval ../data/SRBenchmark

The output Model_mxu_*.npz loads through NetEvaluator.from_checkpoint and
trains further / transfers to LUTs exactly like an `--arch mxu` training
run (the unit contract is unchanged); `--eval` serves teacher and student
through `NetEvaluator(fast=True)` (the plain students through the window
kernel K3).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="dense teacher checkpoint (.pth or .npz)")
    p.add_argument("-e", "--expDir", required=True)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--modes", type=str, default="sdy")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--iters", type=int, default=6000,
                   help="per-unit domain-distillation iterations")
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--e2e-images", type=str, default=None,
                   help="directory of real LR TRAINING images for the "
                        "image-space pass (never test images); omit to "
                        "skip the e2e stage")
    p.add_argument("--e2e-iters", type=int, default=3000)
    p.add_argument("--e2e-lr", type=float, default=1e-4)
    p.add_argument("--eval", type=str, default=None,
                   help="SRBenchmark root: score teacher and student on "
                        "Set5 after distillation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' for "
                        "the plain torch path on the host)")
    args = p.parse_args()

    from mulut_tpu_torch.models.torch_import import (
        load_params_npz,
        save_params_npz,
        srnets_params_from_torch,
    )
    from mulut_tpu_torch.pipelines.distill import (
        distill_finetune_cascade,
        distill_srnets,
    )

    if args.ckpt.endswith(".npz"):
        dense = load_params_npz(args.ckpt)
    else:
        dense = srnets_params_from_torch(args.ckpt, modes=args.modes,
                                         stages=args.stages)

    students, metrics = distill_srnets(
        dense, modes=args.modes, stages=args.stages, scale=args.scale,
        nf=args.nf, depth=args.depth, iters=args.iters, batch=args.batch,
        seed=args.seed, verbose=True, device=args.device,
    )

    if args.e2e_images:
        from mulut_tpu_torch.utils import load_image

        files = sorted(os.listdir(args.e2e_images))
        imgs = [load_image(os.path.join(args.e2e_images, f))
                for f in files if f.lower().endswith((".png", ".jpg", ".bmp"))]
        print(f"e2e image-space pass over {len(imgs)} real images ...",
              flush=True)
        students, _ = distill_finetune_cascade(
            students, dense, modes=args.modes, stages=args.stages,
            scale=args.scale, iters=args.e2e_iters, lr0=args.e2e_lr,
            extra_images=imgs, seed=args.seed, verbose=True,
            device=args.device,
        )

    os.makedirs(args.expDir, exist_ok=True)
    out = os.path.join(
        args.expDir, f"Model_mxu_nf{args.nf}_d{args.depth}.npz")
    save_params_npz(out, {k: {n: np.asarray(a) for n, a in u.items()}
                          for k, u in students.items()})
    print(f"saved {out}")

    if args.eval:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from Test import run_benchmark

        from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

        for tag, params in (("teacher", dense), ("student", students)):
            ev = NetEvaluator(params, stages=args.stages, modes=args.modes,
                              scale=args.scale, fast=True,
                              device=args.device)
            print(f"== {tag} ==", flush=True)
            run_benchmark(ev, args.eval, ["Set5"])


if __name__ == "__main__":
    main()
