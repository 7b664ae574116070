"""Quality metrics on numpy arrays: PSNR (clamped at 99.9 dB), SSIM with an
11-tap Gaussian window (sigma 1.5) as separable 'valid' filters, and
MS-SSIM with 2x average pooling between levels."""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

#: 5-level MS-SSIM weights, planes of 176 px or more on each side.
MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
#: 4-level weights below 176 px (a fifth level's 11x11 window would not fit
#: after four halvings).
MSSSIM_WEIGHTS_SMALL = np.array([0.0517, 0.3295, 0.3462, 0.2726])


def calc_psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0.0:
        return 99.9
    return float(min(99.9, 10.0 * np.log10(data_range ** 2 / mse)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution with a 1-D kernel along H, then W."""
    n = len(k)
    out = sliding_window_view(img, n, axis=0) @ k
    return sliding_window_view(out, n, axis=1) @ k


def calc_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0):
    """(mean SSIM, mean contrast-structure) of one 2-D plane."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = _filter2_sep(a, k)
    mu_b = _filter2_sep(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2_sep(a * a, k) - mu_aa
    s_bb = _filter2_sep(b * b, k) - mu_bb
    s_ab = _filter2_sep(a * b, k) - mu_ab

    cs_map = (2 * s_ab + c2) / (s_aa + s_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs_map
    return float(ssim_map.mean()), float(cs_map.mean())


def calc_msssim(a: np.ndarray, b: np.ndarray,
                data_range: float = 1.0) -> float:
    """MS-SSIM of one 2-D plane: 5 levels at 176 px or more on each side, 4
    below; planes under 88 px are refused."""
    h0, w0 = a.shape
    if h0 < 88 or w0 < 88:
        raise ValueError(
            f"MS-SSIM needs planes >=88px on each side, got {h0}x{w0}")
    weights = (MSSSIM_WEIGHTS if h0 >= 176 and w0 >= 176
               else MSSSIM_WEIGHTS_SMALL)
    levels = len(weights)
    vals = []
    for i in range(levels):
        ssim, cs = calc_ssim(a, b, data_range)
        vals.append(ssim if i == levels - 1 else cs)
        if i < levels - 1:
            h, w = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
            a = a[:h, :w].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
            b = b[:h, :w].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    vals = np.clip(np.asarray(vals), 1e-7, None)
    return float(np.prod(vals ** weights))


def calc_msssim_rgb(a: np.ndarray, b: np.ndarray,
                    data_range: float = 1.0) -> float:
    """Mean MS-SSIM over the channel planes of an (H, W, C) image."""
    return float(np.mean([calc_msssim(a[..., c], b[..., c], data_range)
                          for c in range(a.shape[-1])]))
