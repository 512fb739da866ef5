"""Deployment-grade LUT-retrieval evaluation (CLI-parity with ref:
sr/4_test_lut.py, with its LR-path bug fixed per sr/5_test_lut.py:527), on
the CUDA card unless `--device cpu` is given.

Usage example:
    python 4_test_lut.py -e ../models/sr_x4sdy --testDir ../data/SRBenchmark

Reference results for models/sr_x2sdy (x4, sdy, 2 stages, 4-bit):
    Set5 30.61/0.8655  Set14 27.60/0.7544  B100 26.86/0.7112
    Urban100 24.46/0.7196  Manga109 27.92/0.8637
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.pipelines.evaluate import run_test
from mulut_tpu_torch.utils.options import TestOptions

if __name__ == "__main__":
    opt = TestOptions().parse()
    datasets = [
        d for d in ["Set5", "Set14", "B100", "Urban100", "Manga109"]
        if os.path.isdir(os.path.join(opt.testDir, d, "HR"))
    ]
    run_test(opt, datasets=datasets or ["Set5"], device=opt.device)
