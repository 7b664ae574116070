"""Quantify mask_prop's trade: ROI quality lost to predicted masks against
the mask-transmission bits a transmit-masks design would pay.

The reference's mask_prop exists so P-frames need no per-frame
segmentation at the encoder and no mask side-channel
(src/refactor/mask_prop_seg_video_model.py:365-368), but it never
quantifies the trade. This script does, on the roi_subset eval
distribution (where the mask carries class-subset information that pixels
cannot):

  * ``fast``: the GT mask every P-frame (the transmit / segment-always
    anchor, the same FiLM conditioning site as mask_prop);
  * ``mask_prop``: the GT mask only at the first P-frame, decoder-side
    propagation after (``evaluate_gop_estimated`` carries the chain);
  * the mask side-channel's cost: zlib bits of the packed binary GT mask
    per P-frame (the bound a transmit-masks design pays).

    python3 -m ssgvc_tpu_torch.experiments.mask_prop_value
        [--qps 8,20,32,44,56] [--profile mid] [--crop 192]
        [--ckpt-extra -roisub] [--device=cpu]

Each variant's checkpoint is ``rd_full.ckpt_path(variant)``; a variant
without one is skipped. Writes ``artifacts/torch/mask_prop_value.json``.
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np
import torch

from . import ARTIFACTS, rd_full, split_device, write_json

#: the held-out clips the curves are taken on (of the pinned set)
CLIPS = 6


def mask_side_channel_bpp(masks: np.ndarray) -> float:
    """zlib bits per source pixel of the packed binary masks (T, H, W,
    1)."""
    bits = 0
    for t in range(masks.shape[0]):
        bits += len(zlib.compress(
            np.packbits(masks[t].astype(np.uint8)).tobytes(), 9)) * 8
    return bits / (masks.shape[0] * masks.shape[1] * masks.shape[2])


def variant_curve(variant: str, ck, clips, qps):
    """rd_sweep over ``qps`` of evaluate_gop_estimated on ``clips`` with
    the checkpoint ``ck``'s weights in the profile's ``variant`` models
    (recon_residual on, as the checkpoints were trained)."""
    from ..config import DMCConfig, DMCIConfig, TrainConfig
    from ..models.dmc import DMC
    from ..models.dmci import DMCI
    from ..training.evaluate import evaluate_gop_estimated, rd_sweep

    dmc = DMC(DMCConfig.variant(variant, recon_residual=True,
                                **rd_full.MID_DMC), device=rd_full.DEVICE)
    dmci = DMCI(DMCIConfig(**rd_full.MID_DMCI), device=rd_full.DEVICE)
    dmc.load_state_dict(ck["params_p"], strict=True)
    dmci.load_state_dict(ck["params_i"], strict=True)
    index_map = list(TrainConfig().compression.index_map)
    qp_shift = list(dmc.cfg.qp_shift)

    def eval_qp(qp):
        out = []
        with torch.no_grad():
            for frames, masks in clips:
                out.extend(evaluate_gop_estimated(
                    dmci.eval(), dmc.eval(), frames, masks, qp, index_map,
                    qp_shift))
        return out

    return rd_sweep(eval_qp, qps=qps)


def main(argv=None):
    rd_full.DEVICE, argv = split_device(sys.argv[1:] if argv is None
                                        else argv)
    qps = ([int(q) for q in argv[argv.index("--qps") + 1].split(",")]
           if "--qps" in argv else [8, 20, 32, 44, 56])
    profile = (argv[argv.index("--profile") + 1]
               if "--profile" in argv else "mid")
    crop = int(argv[argv.index("--crop") + 1]) if "--crop" in argv else 192

    rd_full.set_profile(profile)
    rd_full.RECON_SKIP = True
    rd_full.CKPT_EXTRA = (argv[argv.index("--ckpt-extra") + 1]
                          if "--ckpt-extra" in argv else "-roisub")

    from ..data.dataset import SyntheticClipDataset
    from ..utils.checkpoint import restore_checkpoint

    # the pinned roi_subset eval distribution of rd_tpu (seed 777, 900 + i)
    eval_ds = SyntheticClipDataset(num_clips=8, seq_len=4, crop_size=crop,
                                   seed=777, texture="smooth",
                                   roi_subset=True)
    clips = [eval_ds.__getitem__(i, rng=np.random.default_rng(900 + i))
             for i in range(CLIPS)]

    results = {"profile": profile, "crop": crop, "qps": qps,
               "mask_side_channel_bpp_zlib": float(np.mean(
                   [mask_side_channel_bpp(np.asarray(m)) for _, m in clips])),
               "variants": {}}

    for variant in ("fast", "mask_prop"):
        path = rd_full.ckpt_path(variant)
        if not os.path.exists(path):
            print(f"[skip] no checkpoint at {path}")
            continue
        curve = variant_curve(variant, restore_checkpoint(path), clips, qps)
        results["variants"][variant] = curve
        print(f"[{variant}] bpp={[round(b, 4) for b in curve['bpp']]}")
        print(f"[{variant}] roi={[round(p, 2) for p in curve['roi_psnr']]}",
              flush=True)

    if {"fast", "mask_prop"} <= set(results["variants"]):
        f, m = results["variants"]["fast"], results["variants"]["mask_prop"]
        results["summary"] = {
            # what predicted masks cost in ROI quality, per QP
            "roi_psnr_delta_fast_minus_maskprop": [
                round(a - b, 3) for a, b in zip(f["roi_psnr"],
                                                m["roi_psnr"])],
            # what a transmit-masks design would add to fast's rate
            "fast_bpp_with_mask_channel": [
                round(b + results["mask_side_channel_bpp_zlib"], 4)
                for b in f["bpp"]],
            "note": ("mask_prop's value = fast's ROI quality minus the "
                     "delta, at a rate that never pays the mask channel "
                     "and an encoder that segments only the first P-frame"),
        }

    out = f"{ARTIFACTS}/mask_prop_value.json"
    write_json(out, results)
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
