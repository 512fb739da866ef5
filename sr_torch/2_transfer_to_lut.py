"""Cache the trained network into 4-D LUTs (CLI-parity with ref:
sr/2_transfer_to_lut.py), on the CUDA card unless `--device cpu` is given.

Loads Model_{loadIter:06d}.npz (or a reference .pth via the converter) from
expDir and writes LUT_x{scale}_{interval}bit_int8_s{stage}_{mode}.npy.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from mulut_tpu_torch.pipelines.transfer import transfer_to_luts
from mulut_tpu_torch.utils.lut_io import lut_filename, parse_stage_key
from mulut_tpu_torch.utils.options import TestOptions

if __name__ == "__main__":
    opt = TestOptions().parse()

    npz_path = os.path.join(opt.expDir, f"Model_{opt.loadIter:06d}.npz")
    pth_path = os.path.join(opt.expDir, f"Model_{opt.loadIter:06d}.pth")
    if os.path.exists(npz_path):
        from mulut_tpu_torch.models.torch_import import load_params_npz

        params = load_params_npz(npz_path)
    elif os.path.exists(pth_path):
        from mulut_tpu_torch.models.torch_import import srnets_params_from_torch

        params = srnets_params_from_torch(pth_path, modes=opt.modes,
                                          stages=opt.stages)
    else:
        raise FileNotFoundError(f"no checkpoint at {npz_path} or {pth_path}")

    luts = transfer_to_luts(params, modes=opt.modes, stages=opt.stages,
                            interval=opt.interval, device=opt.device)
    for key, arr in luts.items():
        stage, mode = parse_stage_key(key)
        lut_path = os.path.join(
            opt.expDir, lut_filename("LUT", opt.scale, opt.interval, stage, mode)
        )
        np.save(lut_path, arr)
        print("Resulting LUT size: ", arr.shape, "Saved to", lut_path)
