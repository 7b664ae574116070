"""BT.709 colour transforms: Kr=0.2126, Kg=0.7152, Kb=0.0722, chroma offset
+0.5. ``rgb2ycbcr`` / ``ycbcr2rgb`` take (..., 3) tensors, the ``_np``
forms numpy arrays, all in [0, 1]; ``yuv_444_to_420`` and
``ycbcr420_to_444_np`` convert between 4:4:4 and 4:2:0 chroma."""

from __future__ import annotations

import numpy as np
import torch

KR, KG, KB = 0.2126, 0.7152, 0.0722


def rgb2ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> YCbCr."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1.0 - KB) + 0.5
    cr = 0.5 * (r - y) / (1.0 - KR) + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr2rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """(..., 3) YCbCr -> RGB clamped to [0, 1]."""
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    r = y + (2.0 - 2.0 * KR) * (cr - 0.5)
    b = y + (2.0 - 2.0 * KB) * (cb - 0.5)
    g = (y - KR * r - KB * b) / KG
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


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


def yuv_444_to_420(ycbcr: np.ndarray):
    """(H, W, 3) 4:4:4 -> (y (H, W), uv (H/2, W/2, 2)), chroma by 2x2
    means."""
    y = ycbcr[..., 0]
    h, w = y.shape
    uv = ycbcr[:, :, 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    return y, uv


def ycbcr420_to_444_np(y: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """(y, uv) 4:2:0 -> (H, W, 3) 4:4:4, chroma nearest-upsampled, float32."""
    uv_full = np.repeat(np.repeat(uv, 2, axis=0), 2, axis=1)
    return np.concatenate([y[..., None], uv_full], axis=-1).astype(np.float32)
