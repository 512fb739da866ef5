"""LR dataset generator: bicubic X2/X3/X4 pyramids from an HR directory
(CLI-parity with ref: sr/Test_dataset.py:1-42).  Host-side: PNGs through
the port's own codec, the bicubic resize through PIL.

Usage:
    python Test_dataset.py --hr_dir ../data/SRBenchmark/Set5/HR \
        --out_dir ../data/SRBenchmark/Set5/LR_bicubic
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.data.degrade import generate_lr_pyramid

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--hr_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--scales", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--workers", type=int, default=os.cpu_count())
    args = p.parse_args()
    n = generate_lr_pyramid(
        args.hr_dir, args.out_dir, scales=tuple(args.scales),
        workers=args.workers,
    )
    print(f"Generated LR pyramids for {n} images -> {args.out_dir}")
