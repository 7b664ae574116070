"""GOP evaluation: the I-frame codec on frame 0, the P-frame codec on the
rest, carrying the DPB, with per-frame bpp, PSNR, ROI-PSNR (inside the
segmentation mask) and MS-SSIM, on the estimated-rate path
(``evaluate_gop_estimated``) or through the real coder
(``evaluate_gop_coded``, bpp from the stream's bytes); a batch of clips'
GOPs at once (``make_batched_gop_eval``) and its RD curve
(``evaluate_rd_batched``); RD curves over QPs (``rd_sweep``) and the
Bjontegaard deltas between two curves (``bd_rate``, ``bd_psnr``); the
collapse tripwire of from-scratch training (``latent_liveness``,
``liveness_collapsed``). The metrics run on the host, in RGB.
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


@torch.no_grad()
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


def make_batched_gop_eval(dmci, dmc, index_map: Sequence[int],
                          qp_shift: Sequence[int], seq_len: int):
    """A whole batch of GOPs at one QP in one call. ``dmci`` and ``dmc`` are
    the port's modules with their weights loaded, on the device the GOPs
    run on (the P-frame codec with raw io).

    Returns ``run(frames, masks, qp) -> (recons, bpps)``: frames (B, T, H,
    W, 3) and masks (B, T, H, W, 1) tensors on that device, recons (B, T,
    H, W, 3) and bpps (B, T) left there (one copy to the host per GOP
    batch, by the caller). Frame 0 is coded by ``dmci``; frame t > 0 at
    ``qp + qp_shift[index_map[t % len(index_map)]]`` by ``dmc``, the DPB
    carried from frame to frame (its feature starts at zero). A propagated
    mask chain takes the GT mask at the first P-frame only, then the
    decoder-side prediction. Runs without grad (not ``inference_mode``:
    the blocks' packed-weight caches built here are reused by training).
    """
    index_map = list(index_map)
    qp_shift = list(qp_shift)

    @torch.no_grad()
    def run(frames: torch.Tensor, masks: torch.Tensor, qp: int):
        out = dmci(frames[:, 0], qp)
        recons = [out["dpb"]["frame"]]
        bpps = [out["bpp"]]
        ps = dmc.cfg.patch_size
        dpb = {"frame": out["dpb"]["frame"],
               "feature": torch.zeros(
                   (frames.shape[0], frames.shape[2] // ps,
                    frames.shape[3] // ps, dmc.cfg.ch_d),
                   dtype=torch.float32, device=frames.device)}
        propagated = dmc.cfg.mask_source == "propagated"
        mask_carry = None
        for t in range(1, seq_len):
            curr_qp = qp + qp_shift[index_map[t % len(index_map)]]
            m = (mask_carry if propagated and mask_carry is not None
                 else masks[:, t])
            o = dmc(frames[:, t], curr_qp, dpb, after_i=(t == 1), mask=m)
            if propagated:
                mask_carry = m if t == 1 else o["mask_pred"]
            recons.append(o["dpb"]["frame"])
            bpps.append(o["bpp"])
            dpb = o["dpb"]
        return torch.stack(recons, 1), torch.stack(bpps, 1)

    return run


def evaluate_rd_batched(run_fn, clips, qps: Sequence[int],
                        compute_msssim: bool = False,
                        device=None) -> Dict:
    """RD curve over ``qps`` from a :func:`make_batched_gop_eval` callable.

    ``clips``: list of (frames (T, H, W, 3), masks (T, H, W, 1)) numpy
    pairs of equal shapes; they go to ``device`` (by default the card) once.
    Aggregates the P-frames of every clip as :func:`rd_sweep` does;
    MS-SSIM (host scipy) only with ``compute_msssim``, else None.
    """
    frames = np.stack([np.asarray(c[0], np.float32) for c in clips])
    masks = np.stack([np.asarray(c[1], np.float32) for c in clips])
    device = torch.device("cuda" if device is None else device)
    fr_d = torch.from_numpy(frames).to(device)
    ms_d = torch.from_numpy(masks).to(device)
    curve = {"qp": [], "bpp": [], "psnr": [], "roi_psnr": [], "msssim": []}
    for qp in qps:
        recons, bpps = run_fn(fr_d, ms_d, int(qp))
        recons = recons.float().cpu().numpy()
        bpps = bpps.double().cpu().numpy()
        rows = []
        for b in range(frames.shape[0]):
            for t in range(1, frames.shape[1]):
                rows.append(_frame_metrics(
                    "P", float(bpps[b, t]), frames[b, t], recons[b, t],
                    masks[b, t]) if compute_msssim else
                    _frame_metrics_fast(float(bpps[b, t]), frames[b, t],
                                        recons[b, t], masks[b, t]))
        curve["qp"].append(int(qp))
        curve["bpp"].append(float(np.mean([r["bpp"] for r in rows])))
        curve["psnr"].append(float(np.mean([r["psnr"] for r in rows])))
        curve["roi_psnr"].append(
            float(np.mean([r["roi_psnr"] for r in rows])))
        ms = [r["msssim"] for r in rows if r.get("msssim") is not None]
        curve["msssim"].append(float(np.mean(ms)) if ms else None)
    return curve


@torch.no_grad()
def latent_liveness(dmc, clip_a, clip_b,
                    qps: Sequence[int] = (8, 32, 56)) -> Dict:
    """Collapse tripwire of from-scratch training: per QP, the fraction of
    quantized latent positions != 0 (``alive_y`` / ``alive_z``) and the
    PSNR between the reconstructions of two different clips
    (``recon_cross_clip_psnr``: high means the decoder emits a
    near-constant image, the collapse).

    ``dmc``: the port's P-frame codec (raw io) on its device. clip_a /
    clip_b: (frames, masks) with frames (T, H, W, 3) numpy YCbCr; frame 1
    is coded on frame 0 as the DPB frame. y and z are the encoder's and
    the hyper encoder's outputs, tapped by forward hooks; z times
    ``z_gain``, as the codec scales it.
    """
    device = next(dmc.parameters()).device
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        device)
    taps = {}

    def tap(name):
        def hook(module, args, out):
            taps[name] = out.float().cpu().numpy()
        return hook

    handles = [dmc.encoder.register_forward_hook(tap("y")),
               dmc.hyper_encoder.register_forward_hook(tap("z"))]
    z_gain = dmc.z_gain.detach().float().cpu().numpy()

    def run(frames, masks, qp):
        ps = dmc.cfg.patch_size
        dpb = {"frame": dev(frames[0]),
               "feature": torch.zeros(
                   (1, frames.shape[1] // ps, frames.shape[2] // ps,
                    dmc.cfg.ch_d), device=device)}
        out = dmc(dev(frames[1]), qp, dpb, after_i=True, mask=dev(masks[1]))
        z = taps["z"] * z_gain
        return (out["dpb"]["frame"][0].float().cpu().numpy(),
                float(np.mean(np.round(taps["y"]) != 0)),
                float(np.mean(np.round(z) != 0)))

    report = {}
    try:
        for qp in qps:
            ra, alive_y, alive_z = run(*clip_a, qp)
            rb, _, _ = run(*clip_b, qp)
            mse = float(np.mean((ra.astype(np.float64)
                                 - rb.astype(np.float64)) ** 2))
            report[str(qp)] = {
                "alive_y": alive_y, "alive_z": alive_z,
                "recon_cross_clip_psnr": float(min(
                    99.9, 10 * np.log10(1.0 / max(mse, 1e-10)))),
            }
    finally:
        for h in handles:
            h.remove()
    return report


def liveness_collapsed(report: Dict, cross_clip_db: float = 25.0) -> bool:
    """The verdict over a :func:`latent_liveness` report: True when the
    decoder is input-independent (the reconstructions of different clips
    closer than ``cross_clip_db`` at every QP) or the quantized latent is
    all zero at every QP."""
    cross = [r["recon_cross_clip_psnr"] for r in report.values()]
    alive = [r["alive_y"] for r in report.values()]
    return min(cross) > cross_clip_db or max(alive) == 0.0


def evaluate_gop_coded(codec, frames, masks, qp: int,
                       index_map: Sequence[int],
                       qp_shift: Sequence[int]) -> List[Dict]:
    """GOP rollout through the real coder: ``codec`` is a
    ``coding.codec.VideoCodec``; bpp comes from the stream's bytes, and
    every decoded frame must equal the encoder's reconstruction bit for bit
    (AssertionError otherwise). frames / masks as for
    ``evaluate_gop_estimated``."""
    h, w = frames.shape[1:3]
    pixel_num = h * w
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        codec.device)
    host = lambda t: t[0].float().cpu().numpy()

    def same(enc, dec, what):
        if not torch.equal(enc, dec):
            raise AssertionError(f"{what}: the decoder's output differs "
                                 "from the encoder's")

    results = []
    enc = codec.dmci_compress(dev(frames[0]), qp)
    dec = codec.dmci_decompress(enc["bit_stream"], h, w, qp)
    same(enc["x_hat"], dec["x_hat"], "I-frame")
    results.append(_frame_metrics(
        "I", len(enc["bit_stream"]) * 8 / pixel_num, frames[0],
        host(dec["x_hat"]), masks[0], enc_time=codec.enc_time,
        dec_time=codec.dec_time))

    feat0 = torch.zeros((1, h // 8, w // 8, codec.dmc.cfg.ch_d),
                        dtype=codec.dmc.dtype, device=codec.device)
    dpb_e = {"frame": enc["x_hat"], "feature": feat0}
    dpb_d = {"frame": dec["x_hat"], "feature": feat0}
    # mask_prop: both sides carry the mask chain, GT only at the first
    # P-frame
    propagated = codec.dmc.cfg.mask_source == "propagated"
    m_e = m_d = None
    for t in range(1, frames.shape[0]):
        curr_qp = qp + qp_shift[index_map[t % len(index_map)]]
        m = dev(masks[t])
        out = codec.dmc_compress(dev(frames[t]), curr_qp, dpb_e,
                                 after_i=(t == 1),
                                 mask=m_e if m_e is not None else m)
        dec = codec.dmc_decompress(
            out["bit_stream"], h, w, curr_qp, dpb_d, after_i=(t == 1),
            mask=(m_d if m_d is not None else m) if propagated else None)
        same(out["x_hat"], dec["x_hat"], f"P-frame {t}")
        if propagated:
            m_e, m_d = out["mask_out"], dec["mask_out"]
            same(m_e, m_d, f"P-frame {t} mask")
        results.append(_frame_metrics(
            "P", len(out["bit_stream"]) * 8 / pixel_num, frames[t],
            host(dec["x_hat"]), masks[t], enc_time=codec.enc_time,
            dec_time=codec.dec_time))
        dpb_e, dpb_d = out["dpb"], dec["dpb"]
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


def rd_sweep(eval_fn, qps: Sequence[int]) -> Dict[str, List[float]]:
    """eval_fn(qp) -> per-frame results; aggregates the P-frames (all
    frames if there is none) into an RD curve."""
    curve = {"qp": [], "bpp": [], "psnr": [], "roi_psnr": [], "msssim": []}
    for qp in qps:
        results = eval_fn(qp)
        p_frames = [r for r in results if r["frame_type"] == "P"] or results
        curve["qp"].append(qp)
        curve["bpp"].append(float(np.mean([r["bpp"] for r in p_frames])))
        curve["psnr"].append(float(np.mean([r["psnr"] for r in p_frames])))
        curve["roi_psnr"].append(
            float(np.mean([r["roi_psnr"] for r in p_frames])))
        ms = [r["msssim"] for r in p_frames if r["msssim"] is not None]
        curve["msssim"].append(float(np.mean(ms)) if ms else None)
    return curve


def _bd_average(x_a, y_a, x_t, y_t) -> float:
    """Mean of (fit_t - fit_a) over the overlap of the x ranges, each curve
    a polynomial fit of y in x (cubic, or lower with fewer points)."""
    order_a, order_t = np.argsort(x_a), np.argsort(x_t)
    x_a, y_a = x_a[order_a], y_a[order_a]
    x_t, y_t = x_t[order_t], y_t[order_t]
    lo = max(x_a.min(), x_t.min())
    hi = min(x_a.max(), x_t.max())
    if hi <= lo:
        return float("nan")
    int_a = np.polyint(np.polyfit(x_a, y_a, min(3, len(x_a) - 1)))
    int_t = np.polyint(np.polyfit(x_t, y_t, min(3, len(x_t) - 1)))
    avg_a = (np.polyval(int_a, hi) - np.polyval(int_a, lo)) / (hi - lo)
    avg_t = (np.polyval(int_t, hi) - np.polyval(int_t, lo)) / (hi - lo)
    return float(avg_t - avg_a)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Bjontegaard delta rate (%) of the test curve against the anchor:
    log-rate fitted in PSNR, averaged over the overlapping PSNR range."""
    delta = _bd_average(np.asarray(psnr_anchor, np.float64),
                        np.log(np.asarray(rate_anchor, np.float64)),
                        np.asarray(psnr_test, np.float64),
                        np.log(np.asarray(rate_test, np.float64)))
    return float((np.exp(delta) - 1) * 100.0)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Bjontegaard delta PSNR (dB): the test curve's mean quality gain over
    the anchor at matched rate, over the overlapping log-rate range."""
    return _bd_average(np.log(np.asarray(rate_anchor, np.float64)),
                       np.asarray(psnr_anchor, np.float64),
                       np.log(np.asarray(rate_test, np.float64)),
                       np.asarray(psnr_test, np.float64))
