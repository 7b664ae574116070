"""MASK_TRAIN phase for a trained mask_prop checkpoint.

The reference trains mask_prop in a dedicated phase where the loss is the
BCE between MaskPredictor logits and the GT mask and only mask_predictor's
parameters update (``training/trainer.py``'s ``mask_train``). The RD
marathons train with the plain RD loss, which reaches the predictor only
through the FiLM conditioning, so its mask accuracy is untrained. This
phase trains it after the fact:

    python3 -m ssgvc_tpu_torch.experiments.mask_train_phase [steps]
        [--profile mid] [--ckpt-extra -roisub] [--crop 64] [--batch 8]
        [--lr 1e-3] [--budget-min 20] [--no-recon-skip] [--device=cpu]

Loads ``rd_full.ckpt_path('mask_prop')``, runs BCE-only steps on fresh
roi_subset synthetic clips, reports mask IoU before and after on held-out
clips (seed 777, clip i drawn with rng 900 + i), and saves the checkpoint
back in place, keeping a ``.premask`` copy of the one it loaded. Writes
``artifacts/torch/mask_train_phase.json``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import ARTIFACTS, copy_checkpoint, rd_full, split_device, write_json


@torch.no_grad()
def mask_iou(model, params_p, clips) -> float:
    """Mean IoU of the predicted next-frame mask against the GT over
    held-out clips (the prediction from the previous frame's GT mask, the
    chain's first hop). ``params_p`` (a state dict) is loaded into
    ``model`` first unless None."""
    if params_p is not None:
        model.load_state_dict(params_p, strict=True)
    device = next(model.parameters()).device
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        device)
    ious = []
    for frames, masks in clips:
        dpb = {"frame": dev(frames[0]),
               "feature": torch.zeros((1, frames.shape[1] // 8,
                                       frames.shape[2] // 8,
                                       model.cfg.ch_d), device=device)}
        for t in range(1, frames.shape[0]):
            out = model(dev(frames[t]), 32, dpb, after_i=False,
                        mask=dev(masks[t - 1]), train=False)
            pred = out["mask_pred"][0].float().cpu().numpy() > 0.0  # logits
            gt = np.asarray(masks[t]) > 0.5
            inter = np.logical_and(pred, gt).sum()
            union = np.logical_or(pred, gt).sum()
            if union:
                ious.append(inter / union)
            dpb = out["dpb"]
    return float(np.mean(ious)) if ious else float("nan")


def eval_clips(crop: int):
    """The held-out clips: three roi_subset clips of the pinned set."""
    from ..data.dataset import SyntheticClipDataset

    ds = SyntheticClipDataset(num_clips=4, seq_len=4, crop_size=crop,
                              seed=777, texture="smooth", roi_subset=True)
    return [ds.__getitem__(i, rng=np.random.default_rng(900 + i))
            for i in range(3)]


def trainer(steps: int, lr: float):
    """The mask_train Trainer of the profile (``rd_full.set_profile``)."""
    from ..config import DMCConfig, DMCIConfig, TrainConfig
    from ..training.trainer import Trainer

    cfg = TrainConfig(dmc_variant="mask_prop", mask_train=True,
                      accumulation_steps=1)
    cfg.optimizer.base_lr = lr
    return Trainer(cfg, total_iters=steps,
                   dmc_cfg=DMCConfig.variant(
                       "mask_prop", recon_residual=rd_full.RECON_SKIP,
                       **rd_full.MID_DMC),
                   dmci_cfg=DMCIConfig(**rd_full.MID_DMCI),
                   device=rd_full.DEVICE)


def main(argv=None):
    rd_full.DEVICE, argv = split_device(sys.argv[1:] if argv is None
                                        else argv)
    steps = int(argv[0]) if argv and not argv[0].startswith("-") else 2000

    def arg(name, default, cast=str):
        return cast(argv[argv.index(name) + 1]) if name in argv else default

    profile = arg("--profile", "mid")
    rd_full.set_profile(profile)
    rd_full.RECON_SKIP = "--no-recon-skip" not in argv
    rd_full.CKPT_EXTRA = arg("--ckpt-extra", "-roisub")
    crop = arg("--crop", 64, int)
    bs = arg("--batch", 8, int)
    lr = arg("--lr", 1e-3, float)
    budget_s = arg("--budget-min", 20.0, float) * 60.0

    from ..data.dataset import SyntheticClipDataset
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint

    path = rd_full.ckpt_path("mask_prop")
    if not os.path.exists(path):
        raise SystemExit(f"no mask_prop checkpoint at {path}")
    ck = restore_checkpoint(path)
    tr = trainer(steps, lr)

    clips = eval_clips(crop)
    iou_before = mask_iou(tr.dmc, ck["params_p"], clips)
    print(f"[mask_train] IoU before: {iou_before:.3f}", flush=True)

    state = tr.init_state(torch.Generator().manual_seed(0),
                          params_p=ck["params_p"], params_i=ck["params_i"])
    host = np.random.default_rng(7)
    ds = SyntheticClipDataset(num_clips=64, seq_len=4, crop_size=crop,
                              seed=1234, texture="smooth", roi_subset=True)
    t0 = time.perf_counter()
    i = 0
    while i < steps and time.perf_counter() - t0 < budget_s:
        idx = host.integers(0, 64, bs)
        fr, mk = [], []
        for j in idx:
            f, m = ds.__getitem__(int(j), rng=np.random.default_rng(
                int(host.integers(0, 2**31))))
            fr.append(f)
            mk.append(m)
        batch = {"frames": np.stack(fr), "masks": np.stack(mk)}
        qp = int(host.integers(0, 64))
        noise = torch.Generator().manual_seed(int(host.integers(0, 2**31)))
        state, aux = tr.train_step(state, batch, qp, noise)
        if i % 100 == 0:
            print(f"[mask_train] step {i}: loss {float(aux['loss']):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        i += 1

    params_p = rd_full.cpu_state(tr.dmc)
    iou_after = mask_iou(tr.dmc, None, clips)
    print(f"[mask_train] IoU after {i} steps: {iou_after:.3f}", flush=True)

    backup = path + ".premask"
    if not os.path.exists(backup):
        copy_checkpoint(path, backup)
    save_checkpoint(path, {"params_p": params_p,
                           "params_i": ck["params_i"]})
    out = f"{ARTIFACTS}/mask_train_phase.json"
    result = {"steps": i, "iou_before": iou_before, "iou_after": iou_after,
              "crop": crop, "profile": profile}
    write_json(out, result)
    print(f"[mask_train] saved to {path} (backup at {backup}); {out} "
          "written")
    return result


if __name__ == "__main__":
    main()
