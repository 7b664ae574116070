"""End-to-end RD demonstration: train -> RD sweep -> real bitstreams.

Trains a small codec on synthetic driving-like clips (moving textured
objects with exact masks), then produces:
  * an estimated-bpp RD curve over QPs (training path)
  * a REAL-bitstream RD point (rANS coded, the decoder checked bit for bit
    against the encoder)
  * the ROI-PSNR comparison between the 'performance' (mask-SFT) variant
    and the 'plain' baseline at matched training budget

Writes artifacts/torch/rd_demo.json.

    python3 -m ssgvc_tpu_torch.experiments.rd_demo [steps] [--device=cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import ARTIFACTS, rd_full, split_device, write_json

EVAL_QPS = np.asarray([8, 24, 40, 56])
DEMO_DMC = dict(ch_d=32, ch_y=16, ch_z=16, ch_recon=32)
DEMO_DMCI = dict(enc_dec=48, N=32, z_channel=16)
#: the intra pretrain's least number of steps; a short run may lower it
DMCI_MIN_STEPS = 800


def _demo_qp(host) -> int:
    """An eval QP +- 2, from the numpy Generator ``host``."""
    return int(np.clip(host.choice(EVAL_QPS) + host.integers(-2, 3), 0, 63))


def pretrain_dmci(steps: int, dm, seed: int = 17):
    """A small DMCI pretrained on the demo frames, so the GOP is not floored
    by a garbage I-frame: (model, params_i)."""
    from ..config import DMCIConfig
    from ..models.dmci import DMCI
    from ..training.loss import psnr_from_mse

    model = DMCI(DMCIConfig(**DEMO_DMCI), device=rd_full.DEVICE)
    it = dm.train_iter()
    next(it)
    dev = torch.device(rd_full.DEVICE)
    model.init_(torch.Generator().manual_seed(seed))
    tx = rd_full.dmci_tx(model, 1e-3)
    noise = torch.Generator(device=dev).manual_seed(seed)
    host = np.random.default_rng(seed)
    for i in range(steps):
        batch = next(it)
        t = int(host.integers(0, batch["frames"].shape[1]))
        x = torch.from_numpy(batch["frames"][:, t]).to(dev)
        mse, bpp = rd_full.dmci_step(model, tx, x, _demo_qp(host), False,
                                     noise)
        if i % 200 == 0:
            print(f"[dmci] step {i}: psnr "
                  f"{float(psnr_from_mse(mse)):.2f} bpp {float(bpp):.4f}",
                  flush=True)
    return model, rd_full.cpu_state(model)


def train_variant(variant: str, steps: int, dm, seed: int = 0,
                  params_i=None):
    """One DMC variant trained ``steps`` steps: (trainer, state)."""
    from ..config import DMCConfig, DMCIConfig, TrainConfig
    from ..training.trainer import Trainer

    cfg = TrainConfig(dmc_variant=variant)
    cfg.precision = "fp32"
    cfg.optimizer.base_lr = 1e-3
    cfg.roi_weight = 100.0
    trainer = Trainer(cfg, total_iters=steps,
                      dmc_cfg=DMCConfig.variant(variant, **DEMO_DMC),
                      dmci_cfg=DMCIConfig(**DEMO_DMCI), device=rd_full.DEVICE)
    it = dm.train_iter()
    first = next(it)
    state = trainer.init_state(torch.Generator().manual_seed(seed), first,
                               params_i=params_i)
    noise = torch.Generator().manual_seed(seed + 1)
    host_rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    # concentrate qp sampling on the eval set (+- jitter): at demo budgets
    # uniform qp in [0, 64) gives each per-QP table row only ~steps/64
    # updates and the RD curve stays flat
    for i in range(steps):
        qp = _demo_qp(host_rng)
        state, aux = trainer.train_step(state, next(it), qp, noise)
        if i % 100 == 0:
            print(f"[{variant}] step {i}: loss {float(aux['loss']):.3f} "
                  f"bpp {float(aux['bpp']):.4f} psnr {float(aux['psnr']):.2f}",
                  flush=True)
    print(f"[{variant}] {steps} steps in {time.perf_counter()-t0:.1f}s")
    return trainer, state


def main(argv=None):
    rd_full.DEVICE, argv = split_device(sys.argv[1:] if argv is None
                                        else argv)
    steps = int(argv[0]) if argv else 1500
    from ..coding.codec import VideoCodec
    from ..data.dataset import ClipDataModule, SyntheticClipDataset
    from ..training.evaluate import evaluate_gop_coded

    ds = SyntheticClipDataset(num_clips=64, seq_len=4, crop_size=64, seed=3)
    dm = ClipDataModule(ds, batch_size=8, split=(0.9, 0.1, 0.0), seed=3)

    results = {"steps": steps, "variants": {}}
    eval_clips = [ds.__getitem__(i, rng=np.random.default_rng(100 + i))
                  for i in range(58, 62)]

    _, params_i = pretrain_dmci(max(DMCI_MIN_STEPS, steps // 2), dm)

    codecs = {}
    for variant in ("performance", "plain"):
        trainer, state = train_variant(variant, steps, dm, params_i=params_i)
        curve = rd_full.estimated_curve(trainer, eval_clips,
                                        [8, 24, 40, 56])
        results["variants"][variant] = {"estimated_rd": curve}
        codecs[variant] = trainer
        print(f"[{variant}] RD: bpp={curve['bpp']}")
        print(f"[{variant}]     psnr={curve['psnr']}")
        print(f"[{variant}]     roi_psnr={curve['roi_psnr']}", flush=True)

    # real coded path for the flagship variant at one qp
    trainer = codecs["performance"]
    codec = VideoCodec(trainer.dmci.eval(), trainer.dmc.eval())
    frames, masks = eval_clips[0]
    coded = evaluate_gop_coded(codec, frames, masks, qp=24,
                               index_map=list(trainer.cfg.compression.index_map),
                               qp_shift=list(trainer.dmc_cfg.qp_shift))
    results["coded_gop_qp24"] = [
        {k: round(float(v), 5) if isinstance(v, float) else v
         for k, v in r.items()} for r in coded]
    est_bpp = results["variants"]["performance"]["estimated_rd"]["bpp"][1]
    real_bpp = float(np.mean([r["bpp"] for r in coded
                              if r["frame_type"] == "P"]))
    results["estimate_vs_real_bpp_qp24"] = {"estimated": est_bpp,
                                            "real": real_bpp}
    print(f"[coded] estimated bpp {est_bpp:.4f} vs real stream bpp "
          f"{real_bpp:.4f} (decoder verified bit-exact)")

    out_path = f"{ARTIFACTS}/rd_demo.json"
    write_json(out_path, results)
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
