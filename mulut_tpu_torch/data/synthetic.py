"""Synthetic dataset fixtures for pipeline smoke tests.

Fabricates a miniature DIV2K-style training set (structured gradient/texture
images + bicubic LR pyramids) and a tiny benchmark tree, so the full
train -> transfer -> finetune -> test pipeline runs hermetically — the same
role as the fork orchestrator's minimal-dataset generator
(ref: sr/main.py:401-563), implemented independently.  NumPy twin of
`mulut_tpu.data.synthetic`; PNGs go through the port's own codec
(`utils.imgio`) and PIL is imported only inside `_bicubic_down`, the
bicubic resize, so `_synth_image` runs without it.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.imgio import save_image


def _synth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A smooth structured RGB image (gradients + low-freq sinusoids + edges)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    f1, f2 = rng.uniform(2, 8, size=2)
    phase = rng.uniform(0, np.pi * 2, size=3)
    img = np.stack(
        [
            0.5 + 0.25 * np.sin(2 * np.pi * f1 * xx + phase[0]) + 0.25 * yy,
            0.5 + 0.25 * np.cos(2 * np.pi * f2 * yy + phase[1]) + 0.25 * xx,
            0.5 + 0.25 * np.sin(2 * np.pi * (f1 * xx + f2 * yy) + phase[2]),
        ],
        axis=2,
    )
    # a few hard edges so LUT stages see non-smooth content
    for _ in range(4):
        x0 = int(rng.integers(0, size - size // 4))
        y0 = int(rng.integers(0, size - size // 4))
        img[y0 : y0 + size // 8, x0 : x0 + size // 8] = rng.random(3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _bicubic_down(img: np.ndarray, scale: int) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    pil = Image.fromarray(img)
    return np.array(pil.resize((w // scale, h // scale), Image.BICUBIC))


def create_synthetic_dataset(
    root: str,
    *,
    n_train: int = 8,
    n_val: int = 2,
    size: int = 96,
    scales=(2, 3, 4),
    seed: int = 0,
) -> dict:
    """Build {root}/DIV2K/{HR,LR/X*} and {root}/SRBenchmark/Set5/... trees.

    Returns dict with train_dir, val_dir and the file list used.
    """
    rng = np.random.default_rng(seed)
    div2k = os.path.join(root, "DIV2K")
    bench = os.path.join(root, "SRBenchmark")
    os.makedirs(os.path.join(div2k, "HR"), exist_ok=True)
    for s in scales:
        os.makedirs(os.path.join(div2k, "LR", f"X{s}"), exist_ok=True)

    files = [str(i).zfill(4) for i in range(1, n_train + 1)]
    for f in files:
        hr = _synth_image(rng, size)
        save_image(os.path.join(div2k, "HR", f"{f}.png"), hr)
        for s in scales:
            save_image(os.path.join(div2k, "LR", f"X{s}", f"{f}x{s}.png"),
                       _bicubic_down(hr, s))

    os.makedirs(os.path.join(bench, "Set5", "HR"), exist_ok=True)
    for s in scales:
        os.makedirs(os.path.join(bench, "Set5", f"LR_bicubic/X{s}"), exist_ok=True)
    val_names = ["alpha", "beta"][:n_val]
    for name in val_names:
        hr = _synth_image(rng, size)
        save_image(os.path.join(bench, "Set5", "HR", f"{name}.png"), hr)
        for s in scales:
            save_image(
                os.path.join(bench, "Set5", f"LR_bicubic/X{s}", f"{name}.png"),
                _bicubic_down(hr, s))

    return {"train_dir": div2k, "val_dir": bench, "files": files}
