"""Fine-tune cached LUTs with STE (CLI-parity with ref: sr/3_finetune_lut.py),
on the CUDA card unless `--device cpu` is given.

Usage example (ref: README.md:70):
    python 3_finetune_lut.py --stages 2 --modes sdy -e ../models/sr_x4sdy \
        --batchSize 256 --totalIter 2000
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.pipelines.finetune import finetune
from mulut_tpu_torch.utils.options import TrainOptions

if __name__ == "__main__":
    opt_inst = TrainOptions()
    opt = opt_inst.parse()
    opt_inst.print_options(opt)
    finetune(opt, device=opt.device)
