"""DIV2K training data: whole-dataset npy cache + infinite random patch sampler.

NumPy twin of `mulut_tpu.data.div2k`: the same caches, file list and
seeded draws, so a seed gives the JAX package's batches byte for byte.

Mirrors the reference semantics (ref: sr/data.py:52-124): 900 HR/LR pairs
cached into one pickled-dict .npy per resolution (cache filenames are
compatible, so caches interoperate), random image / patch / *single random
channel* crops, and rigid augmentation (flips + rot90).  RNG parity with
torch DataLoader workers is explicitly out of scope; statistical semantics
match.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.imgio import load_image


class DIV2K:
    def __init__(self, scale: int, path: str, patch_size: int,
                 rigid_aug: bool = True, file_list=None, seed: int = 0):
        self.scale = scale
        self.sz = patch_size
        self.rigid_aug = rigid_aug
        self.path = path
        if file_list is None:
            # The reference hardcodes 0001..0900 (ref: sr/data.py:59-60); we
            # scan the HR dir so partial/synthetic datasets also work, which
            # yields the same list on a full DIV2K install.
            hr_dir = os.path.join(path, "HR")
            file_list = sorted(f[:-4] for f in os.listdir(hr_dir)
                               if f.endswith(".png"))
        self.file_list = file_list
        self.rng = np.random.default_rng(seed)

        hr_cache = os.path.join(path, "cache_hr.npy")
        if not os.path.exists(hr_cache):
            self._build_cache(hr_cache, os.path.join(path, "HR"), "")
        self.hr_ims = np.load(hr_cache, allow_pickle=True).item()

        lr_cache = os.path.join(path, f"cache_lr_x{scale}.npy")
        if not os.path.exists(lr_cache):
            self._build_cache(
                lr_cache, os.path.join(path, "LR", f"X{scale}"), f"x{scale}"
            )
        self.lr_ims = np.load(lr_cache, allow_pickle=True).item()

    def _build_cache(self, cache_path: str, folder: str, suffix: str) -> None:
        ims = {}
        for f in self.file_list:
            ims[f] = load_image(os.path.join(folder, f"{f}{suffix}.png"))
        np.save(cache_path, ims, allow_pickle=True)

    def sample_patch(self):
        """One (im, lb) pair: (1, sz, sz) and (1, sz*scale, sz*scale) uint8.

        Returned as uint8 — the training step normalizes to float32/255 ON
        the card (ref semantics: sr/data.py:118-121), which quarters the
        host-to-device transfer.
        """
        rng = self.rng
        key = self.file_list[int(rng.integers(len(self.file_list)))]
        lb = self.hr_ims[key]
        im = self.lr_ims[key]

        if im.shape[0] < self.sz or im.shape[1] < self.sz:
            raise ValueError(
                f"LR image {key} is {im.shape[:2]}, smaller than the "
                f"requested crop {self.sz} — lower --cropSize or use larger "
                f"training images"
            )
        i = int(rng.integers(0, im.shape[0] - self.sz + 1))
        j = int(rng.integers(0, im.shape[1] - self.sz + 1))
        c = int(rng.integers(0, 3))

        s = self.scale
        lb = lb[i * s : i * s + self.sz * s, j * s : j * s + self.sz * s, c]
        im = im[i : i + self.sz, j : j + self.sz, c]

        if self.rigid_aug:
            if rng.random() < 0.5:
                lb, im = np.fliplr(lb), np.fliplr(im)
            if rng.random() < 0.5:
                lb, im = np.flipud(lb), np.flipud(im)
            k = int(rng.integers(0, 4))
            lb, im = np.rot90(lb, k), np.rot90(im, k)

        return np.ascontiguousarray(im)[None], np.ascontiguousarray(lb)[None]

    def sample_batch(self, batch_size: int):
        ims, lbs = zip(*(self.sample_patch() for _ in range(batch_size)))
        return np.stack(ims), np.stack(lbs)
