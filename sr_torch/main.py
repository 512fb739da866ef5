"""Pipeline orchestration CLI (parity with the entry points of the fork's
Colab pipeline script, ref: sr/main.py:1280-1631), on the CUDA card unless
`--device cpu` is given.

Usage:
    python main.py quick   # tiny synthetic end-to-end run
    python main.py test    # medium smoke run
    python main.py full    # full reproduction settings
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.pipelines.orchestrator import run_evaluation

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("mode", nargs="?", default="quick",
                   choices=["quick", "test", "full"])
    p.add_argument("--base_dir", type=str, default="..")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--modes", type=str, default="sdy")
    p.add_argument("--no-synthetic", action="store_true",
                   help="require real datasets instead of fabricating one")
    p.add_argument("--device", type=str, default=None,
                   help="torch device the steps run on (default: the CUDA "
                        "card; 'cpu' for the plain torch path on the host)")
    args = p.parse_args()

    report = run_evaluation(
        args.mode, args.base_dir, synthetic=not args.no_synthetic,
        scale=args.scale, stages=args.stages, modes=args.modes,
        device=args.device,
    )
    print(json.dumps(report, indent=2, default=str))
