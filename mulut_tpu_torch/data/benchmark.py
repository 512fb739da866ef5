"""SR benchmark evaluation set loader (Set5/Set14/B100/Urban100/Manga109).

Preloads HR (modcropped) and LR_bicubic/X{scale} pairs into a dict, with
grayscale images replicated to 3 channels and LR*scale == HR shape asserted
(ref: sr/data.py:127-168).  Unlike the reference, missing benchmark folders
are skipped by default so partial installs (e.g. Set5 only) still work.
NumPy twin of `mulut_tpu.data.benchmark`.
"""

from __future__ import annotations

import os

from ..utils.imgio import load_image
from ..utils.metrics import modcrop

ALL_BENCHMARKS = ["Set5", "Set14", "B100", "Urban100", "Manga109"]


class SRBenchmark:
    def __init__(self, path: str, scale: int = 4, datasets=None, strict: bool = False):
        self.ims: dict = {}
        self.files: dict = {}
        self.scale = scale
        wanted = datasets or ALL_BENCHMARKS
        for dataset in wanted:
            folder = os.path.join(path, dataset, "HR")
            if not os.path.isdir(folder):
                if strict:
                    raise FileNotFoundError(folder)
                continue
            files = sorted(os.listdir(folder))
            self.files[dataset] = files
            for f in files:
                im_hr = modcrop(load_image(os.path.join(folder, f)), scale)
                key = f"{dataset}_{f[:-4]}"
                self.ims[key] = im_hr

                im_lr = load_image(
                    os.path.join(path, dataset, f"LR_bicubic/X{scale}", f)
                )
                assert im_lr.shape[0] * scale == im_hr.shape[0]
                assert im_lr.shape[1] * scale == im_hr.shape[1]
                assert im_lr.shape[2] == im_hr.shape[2] == 3
                self.ims[key + f"x{scale}"] = im_lr

    @property
    def datasets(self):
        return list(self.files.keys())

    def pairs(self, dataset: str):
        """Yield (name, lr_uint8, hr_uint8) for a dataset."""
        for f in self.files[dataset]:
            key = f"{dataset}_{f[:-4]}"
            yield f[:-4], self.ims[key + f"x{self.scale}"], self.ims[key]
