"""Convert a reference PyTorch SRNets checkpoint to the native .npz format.

The reference saves whole-model pickles (ref: sr/1_train_model.py:63-64);
this converts them into the flat npz parameter trees both packages'
pipelines load, so steps 2-4 run against shipped reference weights
without retraining.  Host-side (the port's `srnets_params_from_torch`).

Usage:
    python convert_checkpoint.py ../models/sr_x2sdy/Model_200000.pth \
        [out.npz] [--stages 2 --modes sdy]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.models.torch_import import (
    save_params_npz,
    srnets_params_from_torch,
)

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("pth")
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--modes", type=str, default="sdy")
    args = p.parse_args()

    params = srnets_params_from_torch(args.pth, modes=args.modes,
                                      stages=args.stages)
    out = args.out or args.pth.rsplit(".", 1)[0] + ".npz"
    save_params_npz(out, params)
    n = sum(int(a.size) for unit in params.values() for a in unit.values())
    print(f"{args.pth} -> {out}  ({n} params, "
          f"{len(params)} units: {sorted(params)})")
