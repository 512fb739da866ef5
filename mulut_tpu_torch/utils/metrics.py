"""Image quality metrics and colorspace helpers.

NumPy twin of `mulut_tpu.utils.metrics` (ref: common/utils.py:28-101):
Y-channel PSNR with a shaved border, SSIM with an 11x11 sigma=1.5
Gaussian window, ITU-601 RGB->YCbCr, and modulo cropping; the YCbCr
constants also feed the device YUV pipeline.  Tests hold every copy
equal to its original.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

# ITU-601 YCbCr analog-to-digital conversion matrix (ref: common/utils.py:42-48).
_YCBCR_T = np.array(
    [
        [0.256788235294118, 0.504129411764706, 0.097905882352941],
        [-0.148223529411765, -0.290992156862745, 0.439215686274510],
        [0.439215686274510, -0.367788235294118, -0.071427450980392],
    ]
)
_YCBCR_O = np.array([16.0, 128.0, 128.0])


def rgb2ycbcr(img: np.ndarray, max_val: int = 255) -> np.ndarray:
    """(H, W, 3) RGB -> YCbCr, float64 (ref: common/utils.py:42-60)."""
    offset = _YCBCR_O / 255.0 if max_val == 1 else _YCBCR_O
    flat = img.reshape(-1, img.shape[2]).astype(np.float64)
    out = flat @ _YCBCR_T.T + offset
    return out.reshape(img.shape)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) YCbCr -> RGB uint8 (inverse of `rgb2ycbcr`)."""
    flat = img.reshape(-1, 3).astype(np.float64) - _YCBCR_O
    rgb = flat @ np.linalg.inv(_YCBCR_T).T
    return np.clip(np.round(rgb.reshape(img.shape)), 0, 255).astype(np.uint8)


def modcrop(image: np.ndarray, modulo: int) -> np.ndarray:
    """Crop H and W down to multiples of `modulo` (ref: common/utils.py:28-39)."""
    if image.ndim == 2:
        h, w = image.shape
        return image[: h - h % modulo, : w - w % modulo]
    if image.ndim == 3 and image.shape[2] == 3:
        h, w = image.shape[:2]
        return image[: h - h % modulo, : w - w % modulo, :]
    raise NotImplementedError(f"unsupported image shape {image.shape}")


def psnr(y_true: np.ndarray, y_pred: np.ndarray, shave_border: int = 4) -> float:
    """PSNR over a single channel with border shaving (ref: common/utils.py:63-72)."""
    diff = np.asarray(y_pred, dtype=np.float32) - np.asarray(y_true, dtype=np.float32)
    if shave_border > 0:
        diff = diff[shave_border:-shave_border, shave_border:-shave_border]
    rmse = np.sqrt(np.mean(diff ** 2))
    return float(20 * np.log10(255.0 / rmse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM, 11x11 sigma=1.5 window (ref: common/utils.py:75-101)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    window = _gaussian_window()
    img1 = np.float64(img1)
    img2 = np.float64(img2)

    mu1 = signal.convolve2d(img1, window, "valid")
    mu2 = signal.convolve2d(img2, window, "valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = signal.convolve2d(img1 * img1, window, "valid") - mu1_sq
    sigma2_sq = signal.convolve2d(img2 * img2, window, "valid") - mu2_sq
    sigma12 = signal.convolve2d(img1 * img2, window, "valid") - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(np.mean(ssim_map))


def psnr_ssim_y(img_gt: np.ndarray, img_out: np.ndarray, scale: int):
    """Y-channel PSNR (shave=scale) + SSIM, the reference's reporting pair."""
    y_gt = rgb2ycbcr(img_gt)[:, :, 0]
    y_out = rgb2ycbcr(img_out)[:, :, 0]
    return psnr(y_gt, y_out, scale), ssim(y_gt, y_out)
