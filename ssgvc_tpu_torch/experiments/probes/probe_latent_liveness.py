"""Does calibrated-init P-frame training keep the latent ALIVE?

A fresh init yields latent std ~0.07, round(y) == 0 everywhere, and the
decoder learns an input-independent mean image: PSNR then never responds
to QP. ``training/calibrate.py`` fixes the INIT; this probe verifies
training does not re-collapse it: after N steps it reports, per QP,

  - alive_y / alive_z: fraction of quantized latent positions != 0
  - bpp and PSNR (rate must spread across QP; PSNR responding comes later)
  - input-dependence: PSNR between recons of two DIFFERENT clips (high
    value == decoder emits a near-constant image == collapse)
  - DPB-dependence: recon PSNR delta between model DPB and a zeroed DPB

    python3 -m ssgvc_tpu_torch.experiments.probes.probe_latent_liveness
        [steps] [--device=cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import rd_full, split_device
from ..diag_pframe import psnr

QPS = (8, 32, 56)


def trainer(steps: int, device: str):
    """The probe's Trainer: the performance variant at the rd-tiny widths,
    fp32, accumulation 1, lr 7e-4 cosine-decayed to 5e-5, ROI weight 100,
    the lambda-normalized loss (``rd_full.variant_trainer``'s recipe)."""
    rd_full.set_profile("tiny")
    rd_full.RECON_SKIP = False
    rd_full.DEVICE = device
    return rd_full.variant_trainer("performance", steps, lnorm=True)


def liveness_rows(dmc, clips) -> dict:
    """The probe's table on two distinct clips: {qp: {bpp, psnr, alive_y,
    alive_z, dpb_dep, inp_dep}}, frame 1 of each coded on a reference
    frame by ``code_tapped`` (the JAX script's ``run``: y and z taken by
    forward hooks). dpb_dep > 0: the model uses the reference frame;
    inp_dep LOW: the recons of the two clips differ (healthy)."""
    from ...training.evaluate import code_tapped as run

    (f0, m0), (f1, m1) = clips
    rows = {}
    for qp in QPS:
        r0, bpp, ay, az = run(dmc, f0, m0, qp, f0[0])
        r0z = run(dmc, f0, m0, qp, np.zeros_like(f0[0]))[0]
        r1 = run(dmc, f1, m1, qp, f1[0])[0]
        p = psnr(f0[1], r0)
        rows[qp] = dict(bpp=bpp, psnr=p, alive_y=ay, alive_z=az,
                        dpb_dep=p - psnr(f0[1], r0z),
                        inp_dep=psnr(r0, r1))
    return rows


def main(argv=None):
    """Train, then print the JAX script's lines; return {"steps", "train":
    the step lines' numbers, "rows": :func:`liveness_rows`}."""
    from ...data.dataset import ClipDataModule, SyntheticClipDataset

    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    steps = int(argv[0]) if argv else 1500
    tr = trainer(steps, device)
    ds = SyntheticClipDataset(num_clips=512, seq_len=4, crop_size=64,
                              seed=3, texture="smooth")
    dm = ClipDataModule(ds, batch_size=4, split=(0.95, 0.05, 0.0), seed=3)
    it = dm.train_iter()
    state = tr.init_state(torch.Generator().manual_seed(0), next(it))
    noise = torch.Generator().manual_seed(1)
    host = np.random.default_rng(2)
    train = []
    t0 = time.perf_counter()
    for i in range(steps):
        qp = int(host.integers(0, 64))
        state, aux = tr.train_step(state, next(it), qp, noise)
        if i % 250 == 0 or i == steps - 1:
            row = {k: float(aux[k]) for k in ("loss", "bpp", "psnr")}
            row.update(step=i, s=time.perf_counter() - t0)
            train.append(row)
            print(f"step {i}: loss {row['loss']:.4f} "
                  f"bpp {row['bpp']:.4f} "
                  f"psnr {row['psnr']:.2f} "
                  f"({row['s']:.0f}s)", flush=True)

    # ---- liveness diagnostics on two distinct eval clips ----
    # the pinned clips: seed 777, smooth, clip i drawn with rng 900 + i
    rows = liveness_rows(tr.dmc, rd_full.eval_clip_set(64, 2))
    print("\nqp |   bpp  | psnr | alive_y | alive_z | dpb_dep | inp_dep")
    for qp, r in rows.items():
        print(f"{qp:2d} | {r['bpp']:.4f} | {r['psnr']:5.2f} | "
              f"{r['alive_y']:7.3f} | {r['alive_z']:7.3f} | "
              f"{r['dpb_dep']:+7.2f} | {r['inp_dep']:7.2f}", flush=True)
    return {"steps": steps, "train": train, "rows": rows}


if __name__ == "__main__":
    main()
