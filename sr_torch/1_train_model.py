"""Train the MuLUT network (CLI-parity with ref: sr/1_train_model.py), on
the CUDA card unless `--device cpu` is given.

Usage example (ref: README.md:56):
    python 1_train_model.py --stages 2 --modes sdy -e ../models/sr_x4sdy
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.pipelines.train import train
from mulut_tpu_torch.utils.options import TrainOptions

if __name__ == "__main__":
    opt_inst = TrainOptions()
    opt = opt_inst.parse()
    opt_inst.print_options(opt)
    train(opt, device=opt.device)
