"""Frames from a seed: the one generator that every traffic file feeds.

`synth_frame` is a frozen copy of `mulut_tpu_torch.data.synthetic.
_synth_image` (smooth gradients and low-frequency sinusoids with four
hard-edged blocks), widened from square images to H x W frames.  A
traffic file gives the frame size, the pool size, the frames per batch,
where the frames live (`placement`: "host" or "device") and the loop
(closed, one client).
"""

from __future__ import annotations

import numpy as np

TRAFFIC_KEYS = ("frames_per_batch", "height", "width", "pool", "placement",
                "loop", "clients")


def synth_frame(rng: np.random.Generator, height: int,
                width: int) -> np.ndarray:
    """One structured (height, width, 3) uint8 RGB frame from `rng`."""
    yy = (np.arange(height, dtype=np.float32) / height)[:, None]
    xx = (np.arange(width, dtype=np.float32) / width)[None, :]
    yy, xx = np.broadcast_arrays(yy, xx)
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
    # a few hard edges so the LUT stages see non-smooth content
    bh, bw = height // 8, width // 8
    for _ in range(4):
        x0 = int(rng.integers(0, width - width // 4))
        y0 = int(rng.integers(0, height - height // 4))
        img[y0: y0 + bh, x0: x0 + bw] = rng.random(3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def frame_pool(seed: int, traffic: dict) -> np.ndarray:
    """(pool, H, W, 3) uint8 frames, fixed by `seed`."""
    missing = [k for k in TRAFFIC_KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("only a closed loop with one client is generated")
    if traffic["pool"] % traffic["frames_per_batch"]:
        raise ValueError("the pool must hold whole batches")
    rng = np.random.default_rng(seed)
    return np.stack([synth_frame(rng, traffic["height"], traffic["width"])
                     for _ in range(traffic["pool"])])


def batches(pool: np.ndarray, frames_per_batch: int) -> list:
    """The pool cut into batches, each a contiguous view; the loop sends
    them in turn."""
    return [pool[i: i + frames_per_batch]
            for i in range(0, pool.shape[0], frames_per_batch)]
