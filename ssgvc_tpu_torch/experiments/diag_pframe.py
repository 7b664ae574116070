"""Diagnostic: why is P-frame eval PSNR flat/low (~11 dB) while DMCI
reaches 22+ dB? Loads the RD harness's rd-tiny checkpoints and reports, per
GOP position and QP:

  - I-frame (DMCI) PSNR: is the intra anchor itself healthy at eval res?
  - P-frame PSNR with the model's own DPB (the real rollout)
  - P-frame PSNR with an ORACLE DPB (ground-truth previous frame): if this
    is far higher, recon-feedback compounding is the problem; if it's also
    low, the conditional synthesis path itself is the bottleneck
  - copy-previous-frame PSNR per position (trivial temporal bound)

The checkpoint is the one ``rd_tpu --profile tiny`` (without
``--recon-skip``) writes, ``rd_full.ckpt_path(variant)`` under
``artifacts/torch/``; one whose keys or shapes do not fit the rd-tiny
models is refused with its path named.

    python3 -m ssgvc_tpu_torch.experiments.diag_pframe [--res 64]
        [--variant performance] [--device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import rd_full, restore_fitting, split_device

QPS = (8, 32, 56)
N_CLIPS = 4


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float32) -
                         np.asarray(b, np.float32)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def tiny_ckpt_path(variant: str) -> str:
    """``rd_full.ckpt_path(variant)`` as ``rd_tpu --profile tiny`` without
    ``--recon-skip`` or a namespace writes it (rd_full's globals set so)."""
    rd_full.set_profile("tiny")
    rd_full.RECON_SKIP = False
    rd_full.CKPT_EXTRA = ""
    return rd_full.ckpt_path(variant)


def restore_models(variant: str, device: str):
    """(DMCI, DMC) at the rd-tiny widths on ``device``, holding the
    checkpoint of ``variant`` that the harness writes at ``--profile tiny``
    without ``--recon-skip``."""
    from ..config import DMCConfig, DMCIConfig
    from ..models.dmc import DMC
    from ..models.dmci import DMCI

    path = tiny_ckpt_path(variant)
    dmci = DMCI(DMCIConfig(**rd_full.MID_DMCI), device=device)
    dmc = DMC(DMCConfig.variant(variant, **rd_full.MID_DMC), device=device)
    ck = restore_fitting(path, params_i=dmci, params_p=dmc)
    dmci.load_state_dict(ck["params_i"], strict=True)
    dmc.load_state_dict(ck["params_p"], strict=True)
    return dmci, dmc


@torch.no_grad()
def clip_row(dmci, dmc, frames, masks, qp: int) -> dict:
    """One clip at ``qp``: the I-frame's PSNR and bpp, then for each
    P-frame its PSNR and bpp on the model's DPB, its PSNR on an oracle DPB
    (the ground-truth previous frame, the same feature) and the PSNR of
    copying the previous frame."""
    device = next(dmc.parameters()).device
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        device)
    res = frames.shape[1]
    host = lambda t: t[0].float().cpu().numpy()
    out = dmci(dev(frames[0]), qp, train=False)
    row = {"I": psnr(frames[0], host(out["dpb"]["frame"])),
           "I_bpp": float(out["bpp"][0])}
    ps = dmc.cfg.patch_size
    dpb = {"frame": out["dpb"]["frame"],
           "feature": torch.zeros((1, res // ps, res // ps, dmc.cfg.ch_d),
                                  device=device)}
    for t in range(1, frames.shape[0]):
        x, m = dev(frames[t]), dev(masks[t])
        o = dmc(x, qp, dpb, after_i=(t == 1), mask=m, train=False)
        row[f"P{t}"] = psnr(frames[t], host(o["dpb"]["frame"]))
        row[f"P{t}_bpp"] = float(o["bpp"][0])
        # oracle DPB: ground-truth previous frame as reference
        od = {"frame": dev(frames[t - 1]), "feature": dpb["feature"]}
        oo = dmc(x, qp, od, after_i=(t == 1), mask=m, train=False)
        row[f"P{t}_oracle"] = psnr(frames[t], host(oo["dpb"]["frame"]))
        row[f"copy{t}"] = psnr(frames[t], frames[t - 1])
        dpb = o["dpb"]
    return row


def aggregate(rows) -> dict:
    """Each key's mean over the clips' rows."""
    return {k: float(np.mean([r[k] for r in rows]))
            for k in sorted(rows[0].keys())}


def main(argv=None):
    """Print the JAX script's lines; return {qp: the aggregated row}."""
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    res = int(argv[argv.index("--res") + 1]) if "--res" in argv else 64
    variant = (argv[argv.index("--variant") + 1]
               if "--variant" in argv else "performance")
    dmci, dmc = restore_models(variant, device)
    # the pinned clips: seed 777, smooth, clip i drawn with rng 900 + i
    clips = rd_full.eval_clip_set(res, N_CLIPS)

    report = {}
    for qp in QPS:
        agg = aggregate([clip_row(dmci, dmc, frames, masks, qp)
                         for frames, masks in clips])
        report[qp] = agg
        print(f"qp={qp} res={res} variant={variant}")
        for k in ["I", "I_bpp"]:
            print(f"  {k:10s} {agg[k]:8.3f}")
        for t in (1, 2, 3):
            print(f"  P{t}: model {agg[f'P{t}']:6.2f}  "
                  f"oracle-dpb {agg[f'P{t}_oracle']:6.2f}  "
                  f"copy-prev {agg[f'copy{t}']:6.2f}  "
                  f"bpp {agg[f'P{t}_bpp']:.4f}", flush=True)
    return report


if __name__ == "__main__":
    main()
