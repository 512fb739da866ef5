"""Degradation utilities: bicubic LR pyramid generation.

Host-side preprocessing, the equivalent of the fork's
threaded bicubic downscaler (ref: sr/Test_dataset.py:1-42) using a
thread pool (PIL releases the GIL during resize/IO).  HR images are
modcropped per scale so LR * scale == HR exactly, matching the loader's
shape assertion (ref: sr/data.py:163-166).  NumPy twin of
`mulut_tpu.data.degrade`; PIL is imported inside the functions for the
bicubic resize (and to read an image that is not a PNG), PNGs go through
the port's own codec (`utils.imgio`).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.imgio import as_rgb, read_png, save_image
from ..utils.metrics import modcrop


def bicubic_lr(hr: np.ndarray, scale: int) -> np.ndarray:
    """Bicubic-downscale an HR uint8 array by `scale` (modcrops first)."""
    from PIL import Image

    hr = modcrop(hr, scale)
    h, w = hr.shape[:2]
    pil = Image.fromarray(hr)
    return np.array(pil.resize((w // scale, h // scale), Image.BICUBIC))


def generate_lr_pyramid(hr_dir: str, out_dir: str, *, scales=(2, 3, 4),
                        workers: int | None = None,
                        name_suffix: bool = False) -> int:
    """Write {out_dir}/X{scale}/{name}.png bicubic LRs for every HR image.

    Args:
      name_suffix: append 'x{scale}' to filenames (DIV2K convention
        '0001x4.png') instead of keeping the HR name (benchmark convention).

    Returns the number of HR images processed.
    """
    files = sorted(
        f for f in os.listdir(hr_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    for s in scales:
        os.makedirs(os.path.join(out_dir, f"X{s}"), exist_ok=True)

    def _rgb(path: str) -> np.ndarray:
        img = read_png(path)
        if img is not None:
            return as_rgb(img)
        from PIL import Image

        return np.array(Image.open(path).convert("RGB"))

    def _one(fname: str):
        hr = _rgb(os.path.join(hr_dir, fname))
        stem, _ = os.path.splitext(fname)
        for s in scales:
            lr = bicubic_lr(hr, s)
            out_name = f"{stem}x{s}.png" if name_suffix else f"{stem}.png"
            save_image(os.path.join(out_dir, f"X{s}", out_name), lr)

    with ThreadPoolExecutor(max_workers=workers or os.cpu_count()) as ex:
        list(ex.map(_one, files))
    return len(files)
