"""GOP evaluation on the estimated-rate path: the I-frame codec on frame 0,
the P-frame codec on the rest, carrying the DPB, with per-frame bpp, PSNR,
ROI-PSNR (inside the segmentation mask) and MS-SSIM. Rates are estimated,
not entropy-coded; the metrics run on the host, in RGB.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils.metrics import calc_msssim_rgb, calc_psnr
from ..utils.transforms import ycbcr2rgb_np


def _roi_psnr(ref: np.ndarray, rec: np.ndarray, mask: np.ndarray) -> float:
    m = mask > 0
    if not m.any():
        return calc_psnr(ref, rec)
    m3 = np.broadcast_to(m, ref.shape)
    mse = float(np.mean((ref[m3].astype(np.float64)
                         - rec[m3].astype(np.float64)) ** 2))
    if mse == 0:
        return 99.9
    return float(min(99.9, 10 * np.log10(1.0 / mse)))


def evaluate_gop_estimated(dmci, dmc, frames, masks, qp: int,
                           index_map: Sequence[int],
                           qp_shift: Sequence[int]) -> List[Dict]:
    """GOP rollout on the estimated-bpp path. ``dmci`` and ``dmc`` are the
    port's modules with their weights loaded, on the device the GOP runs
    on (the P-frame codec with raw io: ``packed_io=False``).

    frames: (T, H, W, 3) numpy YCbCr; masks: (T, H, W, 1). Frame t > 0 is
    coded at ``qp + qp_shift[index_map[t % len(index_map)]]``. Returns
    per-frame dicts {frame_type, bpp, psnr, roi_psnr, msssim, enc_time,
    dec_time}.
    """
    device = next(dmci.parameters()).device
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        device)
    host = lambda t: t[0].float().cpu().numpy()
    results = []
    out = dmci(dev(frames[0]), qp)
    results.append(_frame_metrics("I", float(out["bpp"][0]), frames[0],
                                  host(out["dpb"]["frame"]), masks[0]))
    dpb = {"frame": out["dpb"]["frame"],
           "feature": torch.zeros((1, frames.shape[1] // 8,
                                   frames.shape[2] // 8, dmc.cfg.ch_d),
                                  device=device)}
    propagated = dmc.cfg.mask_source == "propagated"
    mask_carry = None
    for t in range(1, frames.shape[0]):
        curr_qp = qp + qp_shift[index_map[t % len(index_map)]]
        # a propagated mask chain takes the GT mask at the first P-frame
        # only, then the decoder-side prediction; metrics always score
        # against the GT mask
        m = (mask_carry if propagated and mask_carry is not None
             else dev(masks[t]))
        out = dmc(dev(frames[t]), curr_qp, dpb, after_i=(t == 1), mask=m)
        if propagated:
            mask_carry = m if t == 1 else out["mask_pred"]
        results.append(_frame_metrics("P", float(out["bpp"][0]), frames[t],
                                      host(out["dpb"]["frame"]), masks[t]))
        dpb = out["dpb"]
    return results


def _frame_metrics_fast(bpp: float, ref_ycbcr, rec_ycbcr, mask) -> Dict:
    """PSNR and ROI-PSNR only."""
    ref_rgb = ycbcr2rgb_np(np.asarray(ref_ycbcr))
    rec_rgb = ycbcr2rgb_np(np.asarray(rec_ycbcr))
    return {"bpp": float(bpp),
            "psnr": calc_psnr(ref_rgb, rec_rgb),
            "roi_psnr": _roi_psnr(ref_rgb, rec_rgb, np.asarray(mask)),
            "msssim": None}


def _frame_metrics(frame_type: str, bpp: float, ref_ycbcr, rec_ycbcr, mask,
                   enc_time: float = 0.0, dec_time: float = 0.0) -> Dict:
    ref_rgb = ycbcr2rgb_np(np.asarray(ref_ycbcr))
    rec_rgb = ycbcr2rgb_np(np.asarray(rec_ycbcr))
    return {
        "frame_type": frame_type,
        "bpp": float(bpp),
        "psnr": calc_psnr(ref_rgb, rec_rgb),
        "roi_psnr": _roi_psnr(ref_rgb, rec_rgb, np.asarray(mask)),
        # MS-SSIM needs 88 px on each side: None below that, not a number
        "msssim": calc_msssim_rgb(ref_rgb, rec_rgb)
        if min(ref_rgb.shape[:2]) >= 88 else None,
        "enc_time": enc_time,
        "dec_time": dec_time,
    }
