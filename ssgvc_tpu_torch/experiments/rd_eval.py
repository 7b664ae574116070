"""Standalone RD evaluation from the harness's checkpoints.

rd_full / rd_tpu save ``artifacts/torch/rd_ckpt_{performance,plain}_<tag>``
(params_p + params_i). This script rebuilds the models and sweeps RD curves
at one or more eval resolutions: training used 64px crops, so curves at
64px measure the trained operating point while 192px (MS-SSIM-capable)
probes generalization. At the smallest crop it also codes clip 0 through
the real rANS coder at every QP (the decoder checked against the encoder
frame by frame) and records the estimate-vs-real bpp gap.

    python3 -m ssgvc_tpu_torch.experiments.rd_eval [--profile tiny]
        [--crops 64,192] [--qps 8,20,...] [--device=cpu] ...

Writes artifacts/torch/rd_eval.json.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import ARTIFACTS, rd_full, split_device, write_json
from .rd_full import EVAL_QPS


def _trivial_bounds(clips):
    """Zero-rate reference points on the SAME eval clips: copy-previous-frame
    PSNR over the P positions, and the per-clip-mean (DC) PSNR. A codec
    P-frame is only interesting above copy-prev; rate only trades visibly
    once the model clears these."""
    def psnr(mse):
        return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))

    copy_mse, dc_mse = [], []
    for frames, _ in clips:
        f = np.asarray(frames, np.float32)
        copy_mse.extend(((f[1:] - f[:-1]) ** 2).reshape(len(f) - 1, -1)
                        .mean(axis=1).tolist())
        dc = f.mean(axis=(0, 1, 2), keepdims=True)
        dc_mse.append(float(((f - dc) ** 2).mean()))
    return {"copy_prev_psnr_db": round(psnr(float(np.mean(copy_mse))), 2),
            "dc_psnr_db": round(psnr(float(np.mean(dc_mse))), 2)}


def main(argv=None):
    rd_full.DEVICE, argv = split_device(sys.argv[1:] if argv is None
                                        else argv)
    profile = (argv[argv.index("--profile") + 1]
               if "--profile" in argv else "tiny")
    crops = ([int(c) for c in argv[argv.index("--crops") + 1].split(",")]
             if "--crops" in argv else [64, 192])
    # full-range sweep: the trained model is variable-rate over qp 0..63
    qps = ([int(q) for q in argv[argv.index("--qps") + 1].split(",")]
           if "--qps" in argv else EVAL_QPS)
    # --ckpt-extra "-roisub" evaluates a namespaced checkpoint family. MUST
    # be set before the recon-skip autodetection below: it probes
    # ckpt_path(), which bakes the namespace into the tag.
    if "--ckpt-extra" in argv:
        rd_full.CKPT_EXTRA = argv[argv.index("--ckpt-extra") + 1]
    # shares rd_full's dims + checkpoint-path tag (tiny/mid/half); default
    # to the recon-skip recipe when its checkpoints exist, falling back to
    # the plain tag
    rd_full.set_profile(profile)
    rd_full.RECON_SKIP = True
    any_skip = any(os.path.exists(rd_full.ckpt_path(v))
                   for v in ("performance", "plain"))
    recon_skip = ("--recon-skip" in argv
                  or ("--no-recon-skip" not in argv and any_skip))
    rd_full.RECON_SKIP = recon_skip

    from ..training.evaluate import (evaluate_gop_coded,
                                     evaluate_gop_estimated, latent_liveness)
    from ..utils.checkpoint import restore_checkpoint

    # --roi-subset switches the eval distribution to class-filter masks to
    # match the -roisub checkpoints; --variants widens the sweep beyond
    # performance,plain
    roi_subset = "--roi-subset" in argv
    variants = (argv[argv.index("--variants") + 1].split(",")
                if "--variants" in argv else ["performance", "plain"])

    results = {"profile": profile, "crops": {},
               "ckpt_extra": rd_full.CKPT_EXTRA, "roi_subset": roi_subset}
    for crop in crops:
        # default matches the training distribution of every current
        # checkpoint (rd_full/rd_continue train on texture="smooth")
        clips = rd_full.eval_clip_set(
            crop, roi_subset=roi_subset,
            texture="noise" if "--noise" in argv else "smooth")
        per_variant = {"trivial_bounds": _trivial_bounds(clips)}
        for variant in variants:
            path = rd_full.ckpt_path(variant)
            if not os.path.exists(path):
                print(f"[skip] no checkpoint at {path}")
                continue
            ck = restore_checkpoint(path)
            tr = rd_full.variant_trainer(variant, 10, False)
            tr.dmc.load_state_dict(ck["params_p"], strict=True)
            tr.dmci.load_state_dict(ck["params_i"], strict=True)
            index_map = list(tr.cfg.compression.index_map)
            qp_shift = list(tr.dmc_cfg.qp_shift)

            curve = rd_full.estimated_curve(tr, clips, qps)

            # collapse tripwire
            curve["liveness"] = latent_liveness(tr.dmc, clips[0], clips[1])

            # estimate-vs-real bpp gap per QP. Only at the smallest crop:
            # the gap is resolution-independent to first order.
            if crop == min(crops) and "--no-coded" not in argv:
                from ..coding.codec import VideoCodec
                codec = VideoCodec(tr.dmci.eval(), tr.dmc.eval())
                gaps = {}
                for qp in qps:
                    frames, masks = clips[0]
                    coded = evaluate_gop_coded(codec, frames, masks, qp=qp,
                                               index_map=index_map,
                                               qp_shift=qp_shift)
                    real = float(np.mean([r["bpp"] for r in coded
                                          if r["frame_type"] == "P"]))
                    # est must be the SAME clip the coded path ran on:
                    # curve["bpp"] averages all 6 clips, and per-clip rate
                    # variance once masqueraded as a coder gap
                    est_clip = evaluate_gop_estimated(
                        tr.dmci, tr.dmc, frames, masks, qp, index_map,
                        qp_shift)
                    est = float(np.mean([r["bpp"] for r in est_clip
                                         if r["frame_type"] == "P"]))
                    gaps[qp] = {"estimated": est, "real": real,
                                "gap_pct": round(100.0 * (real - est)
                                                 / max(est, 1e-9), 1)}
                curve["est_vs_real_bpp"] = gaps
                print(f"[{crop}px {variant}] est-vs-real gap%: "
                      f"{[gaps[q]['gap_pct'] for q in qps]}")

            per_variant[variant] = curve
            print(f"[{crop}px {variant}] bpp="
                  f"{[round(b, 4) for b in curve['bpp']]}")
            print(f"[{crop}px {variant}] psnr="
                  f"{[round(p, 2) for p in curve['psnr']]}")
            print(f"[{crop}px {variant}] roi="
                  f"{[round(p, 2) for p in curve['roi_psnr']]}", flush=True)
        if {"performance", "plain"} <= set(per_variant):
            per_variant.update(rd_full.bd_fields(
                per_variant["performance"], per_variant["plain"],
                "bd_rate_roi_psnr_pct", "bd_rate_psnr_pct",
                "bd_psnr_roi_db"))
            print(f"[{crop}px] BD-rate ROI {per_variant['bd_rate_roi_psnr_pct']:+.1f}%"
                  f"  global {per_variant['bd_rate_psnr_pct']:+.1f}%"
                  f"  ROI BD-PSNR {per_variant['bd_psnr_roi_db']:+.2f} dB")
        results["crops"][str(crop)] = per_variant

    out_path = f"{ARTIFACTS}/rd_eval.json"
    write_json(out_path, results)
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
