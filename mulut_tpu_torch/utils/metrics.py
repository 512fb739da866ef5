"""ITU-601 YCbCr constants for the device YUV pipeline.

Copies of `_YCBCR_T` and `_YCBCR_O` in `mulut_tpu.utils.metrics` (ref:
common/utils.py:42-48); tests hold the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np

# ITU-601 YCbCr analog-to-digital conversion matrix (ref: common/utils.py:42-48).
_YCBCR_T = np.array(
    [
        [0.256788235294118, 0.504129411764706, 0.097905882352941],
        [-0.148223529411765, -0.290992156862745, 0.439215686274510],
        [0.439215686274510, -0.367788235294118, -0.071427450980392],
    ]
)
_YCBCR_O = np.array([16.0, 128.0, 128.0])
