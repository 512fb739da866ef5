"""LUT artifact IO, image IO, metrics, logging, options and profiling."""

from .imgio import load_image, save_image
from .lut_io import load_luts, lut_filename, lut_key, save_lut
from .metrics import modcrop, psnr, psnr_ssim_y, rgb2ycbcr, ssim, ycbcr2rgb

__all__ = [
    "load_image",
    "save_image",
    "load_luts",
    "lut_filename",
    "lut_key",
    "save_lut",
    "modcrop",
    "psnr",
    "psnr_ssim_y",
    "rgb2ycbcr",
    "ssim",
    "ycbcr2rgb",
]
