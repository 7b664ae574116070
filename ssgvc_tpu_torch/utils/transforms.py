"""BT.709 colour transforms on numpy (..., 3) arrays in [0, 1]: Kr=0.2126,
Kg=0.7152, Kb=0.0722, chroma offset +0.5."""

from __future__ import annotations

import numpy as np

KR, KG, KB = 0.2126, 0.7152, 0.0722


def rgb2ycbcr_np(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB -> YCbCr, float32."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1.0 - KB) + 0.5
    cr = 0.5 * (r - y) / (1.0 - KR) + 0.5
    return np.stack([y, cb, cr], axis=-1).astype(np.float32)


def ycbcr2rgb_np(ycbcr: np.ndarray) -> np.ndarray:
    """(..., 3) YCbCr -> RGB clamped to [0, 1], float32."""
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    r = y + (2.0 - 2.0 * KR) * (cr - 0.5)
    b = y + (2.0 - 2.0 * KB) * (cb - 0.5)
    g = (y - KR * r - KB * b) / KG
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)
