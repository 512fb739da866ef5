"""PNG image IO helpers (PIL-backed, host-side).

NumPy twin of `mulut_tpu.utils.imgio`.  PIL is imported inside each
function, so importing this module needs no PIL (the card's machine has
none; the training data there comes from pickled caches).
"""

from __future__ import annotations

import os

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load a PNG as (H, W, 3) uint8; grayscale is replicated to 3 channels
    (ref: sr/4_test_lut.py:268-277)."""
    from PIL import Image

    img = np.array(Image.open(path))
    if img.ndim == 2:
        img = np.stack([img, img, img], axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(img, dtype=np.uint8)).save(path)
