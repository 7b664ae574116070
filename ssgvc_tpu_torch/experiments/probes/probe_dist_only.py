"""Probe: can the P-model learn to beat frame-copy when rate pressure is
negligible? Pins lambda to a huge constant so the RD loss is effectively
pure distortion. If PSNR climbs past the ~26 dB copy baseline the machinery
is fine and flat-RD is a staged-training problem; if it stalls ~13 dB there
is a structural bug.

The intra model is the performance checkpoint's (``params_i``) that
``rd_tpu --profile tiny`` (without ``--recon-skip``) writes; one whose keys
or shapes do not fit the rd-tiny DMCI is refused with its path named.

    python3 -m ssgvc_tpu_torch.experiments.probes.probe_dist_only
        [variant] [steps] [--device=cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import rd_full, restore_fitting, split_device
from ..diag_pframe import tiny_ckpt_path

LAMBDA = 1e5   # lambda_min = lambda_max: distortion only
QP = 32


def train_config(variant: str):
    """fp32, accumulation 1, lr 7e-4 (the schedule's other defaults), ROI
    weight 1, lambda pinned at :data:`LAMBDA`."""
    from ...config import TrainConfig

    cfg = TrainConfig(dmc_variant=variant, accumulation_steps=1)
    cfg.precision = "fp32"
    cfg.optimizer.base_lr = 7e-4
    cfg.roi_weight = 1.0
    cfg.compression.lambda_min = LAMBDA   # distortion-only probe
    cfg.compression.lambda_max = LAMBDA
    return cfg


def trainer(variant: str, steps: int, device: str):
    """The probe's Trainer at the rd-tiny widths."""
    from ...config import DMCConfig, DMCIConfig
    from ...training.trainer import Trainer

    rd_full.set_profile("tiny")
    return Trainer(train_config(variant), total_iters=steps,
                   dmc_cfg=DMCConfig.variant(variant, **rd_full.MID_DMC),
                   dmci_cfg=DMCIConfig(**rd_full.MID_DMCI), device=device)


def copy_baseline_psnr(frames) -> float:
    """PSNR of copying the previous frame over a (B, T, H, W, 3) batch."""
    f = np.asarray(frames)
    return 10 * np.log10(1.0 / np.mean((f[:, 1:] - f[:, :-1]) ** 2))


def main(argv=None):
    """Print the JAX script's lines; return {"copy_baseline_psnr",
    "steps": the step lines' numbers}."""
    from ...data.dataset import ClipDataModule, SyntheticClipDataset

    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    variant = argv[0] if argv else "plain"
    steps = int(argv[1]) if len(argv) > 1 else 1500
    tr = trainer(variant, steps, device)
    ds = SyntheticClipDataset(num_clips=512, seq_len=4, crop_size=64, seed=3,
                              texture="smooth")
    dm = ClipDataModule(ds, batch_size=4, split=(0.95, 0.05, 0.0), seed=3)
    it = dm.train_iter()
    first = next(it)

    # copy-baseline on this data
    cp = copy_baseline_psnr(first["frames"])
    print(f"copy-baseline psnr on train batch: {cp:.2f} dB", flush=True)

    path = tiny_ckpt_path("performance")
    ck = restore_fitting(path, params_i=tr.dmci)
    state = tr.init_state(torch.Generator().manual_seed(0), first,
                          params_i=ck["params_i"])
    noise = torch.Generator().manual_seed(1)
    rows = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, aux = tr.train_step(state, next(it), QP, noise)
        if i % 100 == 0:
            mse = float(aux["mse"])
            row = dict(step=i, loss=float(aux["loss"]),
                       bpp=float(aux["bpp"]),
                       psnr=float(10 * np.log10(1.0 / max(mse, 1e-9))),
                       s=time.perf_counter() - t0)
            rows.append(row)
            print(f"step {i}: loss {row['loss']:.1f} bpp {row['bpp']:.4f} "
                  f"P-psnr {row['psnr']:.2f} ({row['s']:.0f}s)", flush=True)
    return {"copy_baseline_psnr": float(cp), "steps": rows}


if __name__ == "__main__":
    main()
