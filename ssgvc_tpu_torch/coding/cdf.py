"""Quantized-CDF tables of the rANS coder and the scale-index builders.

  * ``build_z_cdf_tables``: the trained per-QP factorized CDF of z
    (``models.entropy.BitEstimator``) on an integer grid, each (qp, channel)
    row cut to the support where its mass lies, pmf + tail quantized;
  * ``build_y_cdf_tables``: zero-mean Gaussian (or Laplace) tables over a
    log-spaced scale table, in numpy;
  * ``build_indexes_decoder`` / ``build_indexes_encoder``: scale -> table
    row (and the fused (symbol << 8) | index words), in torch, fp32.

The tables are the JAX package's: the same numpy code over the same fp32
CDF values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.entropy import BitEstimator, scale_index_params
from .rans import pmf_to_quantized_cdf


class CdfTables(NamedTuple):
    cdfs: np.ndarray      # (rows, max_len + 2) int32
    lengths: np.ndarray   # (rows,) int32, used entries per row
    offsets: np.ndarray   # (rows,) int32


def _quantize_rows(pmf: np.ndarray, tail: np.ndarray, lengths: np.ndarray,
                   offsets: np.ndarray, precision: int = 16) -> CdfTables:
    rows = pmf.shape[0]
    max_len = int(lengths.max())
    out = np.zeros((rows, max_len + 2), np.int32)
    cdf_lengths = np.zeros(rows, np.int32)
    for r in range(rows):
        n = int(lengths[r])
        full = np.concatenate([pmf[r, :n], [max(tail[r], 0.0)]]).astype(
            np.float32)
        cdf = pmf_to_quantized_cdf(full, precision)
        out[r, : len(cdf)] = cdf
        cdf_lengths[r] = len(cdf)  # = n + 2
    return CdfTables(out, cdf_lengths, offsets.astype(np.int32))


def build_z_cdf_tables(bit_estimator: BitEstimator, scan_range: int = 16,
                       precision: int = 16) -> CdfTables:
    """Per-(qp, channel) factorized-prior tables, rows ordered qp * C + c
    (the coder's ``start_offset = qp * C``). The CDF is evaluated on a CPU
    fp32 copy of ``bit_estimator``'s parameters, whatever device it is on,
    so an encoder on the card and a decoder elsewhere build the same
    tables."""
    qp_num, channel = bit_estimator.f1.h.shape
    be = BitEstimator(qp_num, channel, device="cpu")
    be.load_state_dict({k: v.detach().float().cpu()
                        for k, v in bit_estimator.state_dict().items()})
    index = torch.arange(qp_num)

    def cdf_at(x_grid: np.ndarray) -> np.ndarray:
        # x_grid: (L,) -> evaluated per (qp, c) as a (Q, 1, L, C) batch
        x = torch.from_numpy(np.asarray(x_grid, np.float32))
        x = x[None, None, :, None].expand(qp_num, 1, len(x_grid), channel)
        with torch.no_grad():
            return be.get_cdf(x, index).numpy()[:, 0]   # (Q, L, C)

    ints = np.arange(-scan_range, scan_range + 1)
    cdf_lo = cdf_at(ints - 0.5)
    cdf_hi = cdf_at(ints + 0.5)

    # support per (q, c): minima = smallest i in [2, scan] with cdf(-i) <
    # 1e-4, maxima = smallest i with cdf(+i) > 0.9999, else scan_range
    cdf_points = cdf_at(ints.astype(np.float64))
    center = scan_range
    minima = np.full((qp_num, channel), scan_range, np.int32)
    maxima = np.full((qp_num, channel), scan_range, np.int32)
    for i in range(scan_range, 1, -1):
        minima = np.where(cdf_points[:, center - i, :] < 1e-4, i, minima)
        maxima = np.where(cdf_points[:, center + i, :] > 0.9999, i, maxima)

    pmf_all = np.clip(cdf_hi - cdf_lo, 0.0, 1.0)   # (Q, L, C)

    rows = qp_num * channel
    lengths = np.zeros(rows, np.int32)
    offsets = np.zeros(rows, np.int32)
    max_len = int((minima + maxima + 1).max())
    pmf = np.zeros((rows, max_len), np.float64)
    tail = np.zeros(rows, np.float64)
    for q in range(qp_num):
        for c in range(channel):
            lo, hi = int(minima[q, c]), int(maxima[q, c])
            n = lo + hi + 1
            r = q * channel + c
            seg = pmf_all[q, center - lo: center + hi + 1, c]
            pmf[r, :n] = seg
            lengths[r] = n
            offsets[r] = -lo
            tail[r] = max(0.0, 1.0 - seg.sum())
    return _quantize_rows(pmf, tail, lengths, offsets, precision)


#: The wide scale tables of the refactor coder profiles: 256 log-spaced
#: levels up to 64, Laplace reaching down to 0.01. The default coder uses
#: (0.11, 16, 128).
REFRACTOR_PROFILES = {
    "gaussian": dict(scale_min=0.11, scale_max=64.0, levels=256),
    "laplace": dict(scale_min=0.01, scale_max=64.0, levels=256),
}


def build_y_cdf_tables(scale_min: float = 0.11, scale_max: float = 16.0,
                       levels: int = 128, scan_range: int = 8,
                       precision: int = 16,
                       distribution: str = "gaussian") -> CdfTables:
    """Zero-mean Gaussian or Laplace tables over the log-spaced scale
    table; each row's support is the smallest i in [2, scan_range] with
    cdf(i) > 0.9999."""
    scales = np.exp(np.linspace(math.log(scale_min), math.log(scale_max),
                                levels))

    if distribution == "laplace":
        def ncdf(x, s):
            x = np.asarray(x, np.float64)
            e = 0.5 * np.exp(-np.abs(x) / s)  # branch-free: no exp overflow
            return np.where(x < 0, e, 1.0 - e)
    elif distribution == "gaussian":
        def ncdf(x, s):
            return 0.5 * (1 + np.vectorize(math.erf)(x / (s * math.sqrt(2.0))))
    else:
        raise ValueError(f"unknown distribution {distribution!r}")

    centers = np.full(levels, scan_range, np.int32)
    for i in range(scan_range, 1, -1):
        centers = np.where(ncdf(float(i), scales) > 0.9999, i, centers)

    lengths = 2 * centers + 1
    max_len = int(lengths.max())
    pmf = np.zeros((levels, max_len), np.float64)
    tail = np.zeros(levels, np.float64)
    offsets = -centers.astype(np.int32)
    for r in range(levels):
        c = int(centers[r])
        xs = np.arange(-c, c + 1, dtype=np.float64)
        upper = ncdf(xs + 0.5, scales[r])
        lower = ncdf(xs - 0.5, scales[r])
        pmf[r, : 2 * c + 1] = upper - lower
        tail[r] = 2 * lower[0]
    return _quantize_rows(pmf, tail, lengths, offsets, precision)


def build_indexes_decoder(scales: torch.Tensor, scale_min: float = 0.11,
                          scale_max: float = 16.0,
                          levels: int = 128) -> torch.Tensor:
    """Scale -> int32 table row: clamp, then the log-scale index, in fp32
    whatever the scales' dtype. A NaN scale takes row 0, as XLA's float to
    int conversion gives it in the JAX package (torch's gives INT_MIN, a
    row outside the table). The JAX package's public scale -> index map,
    ported as ``models/entropy.build_scale_indexes`` and run by no path,
    takes the same bins from :func:`scale_index_params`."""
    log_min, log_step = scale_index_params(scale_min, scale_max, levels)
    recip = 1.0 / log_step
    s = torch.clamp(scales.float(), scale_min, scale_max)
    idx = torch.nan_to_num((torch.log(s) - log_min) * recip, nan=0.0)
    return idx.to(torch.int32)


def build_indexes_encoder(symbols: torch.Tensor, scales: torch.Tensor,
                          scale_min: float = 0.11, scale_max: float = 16.0,
                          levels: int = 128) -> torch.Tensor:
    """The fused int16 words (symbol << 8) + index, symbols rounded and
    clamped to +-127."""
    idx = build_indexes_decoder(scales, scale_min, scale_max, levels)
    sym = torch.clamp(torch.round(symbols), -127, 127).to(torch.int32)
    return ((sym << 8) + idx).to(torch.int16)
