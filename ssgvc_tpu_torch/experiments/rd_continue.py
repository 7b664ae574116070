"""Continue RD training from the harness's checkpoints.

Loads ``artifacts/torch/rd_ckpt_{variant}_<tag>``, trains each variant for
another budget slice on the smooth-texture host data, saves the checkpoints
back, and re-runs the RD sweep + BD/monotonicity summary, so long RD
budgets accumulate across runs. Each cycle first snapshots the
checkpoint to ``.prev`` and restores it when the liveness gate finds the
warm restart collapsed.

    python3 -m ssgvc_tpu_torch.experiments.rd_continue [steps]
        [--budget-min 120] [--profile tiny] [--seed N] [--data-seed N]
        [--base-lr X] [--sched-steps N] [--lnorm] [--recon-skip]
        [--device=cpu]

Writes artifacts/torch/rd_continued.json.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import ARTIFACTS, copy_checkpoint, rd_full, split_device, write_json
from .rd_full import EVAL_QPS, liveness_gate, sample_qp

OUT_JSON = f"{ARTIFACTS}/rd_continued.json"


def main(argv=None):
    rd_full.DEVICE, argv = split_device(sys.argv[1:] if argv is None
                                        else argv)
    steps = int(argv[0]) if argv and not argv[0].startswith("-") else 30000
    budget_min = (float(argv[argv.index("--budget-min") + 1])
                  if "--budget-min" in argv else 120.0)
    # vary per marathon cycle so continuation cycles see fresh data/QP orders
    cycle_seed = (int(argv[argv.index("--seed") + 1])
                  if "--seed" in argv else 0)
    profile = (argv[argv.index("--profile") + 1]
               if "--profile" in argv else "tiny")
    tiny = profile == "tiny"
    # shares rd_full's dims + checkpoint-path tag (tiny/mid/half)
    rd_full.set_profile(profile)
    recon_skip = "--recon-skip" in argv
    rd_full.RECON_SKIP = recon_skip

    from ..data.dataset import ClipDataModule, SyntheticClipDataset
    from ..training.evaluate import latent_liveness
    from ..utils.checkpoint import restore_checkpoint

    crop, bs = (64, 4) if tiny else (128, 8)
    # --data-seed regenerates the procedural TRAIN clips (default 3, the
    # fresh run's set); a new seed per cycle gives the model effectively
    # infinite data. Eval clips stay pinned (seed=777) either way.
    data_seed = (int(argv[argv.index("--data-seed") + 1])
                 if "--data-seed" in argv else 3)
    train_ds = SyntheticClipDataset(num_clips=512, seq_len=4, crop_size=crop,
                                    seed=data_seed, texture="smooth")
    dm = ClipDataModule(train_ds, batch_size=bs, split=(0.95, 0.05, 0.0),
                        seed=3)
    eval_clips = rd_full.eval_clip_set(192)
    # gate clips at the train crop: a warm restart at LR 7e-4 CAN re-collapse
    # a healthy model, so every continuation cycle is gated too
    gate_clips = rd_full.gate_clip_set(crop)

    results = {"continued_steps": steps, "budget_min": budget_min,
               "variants": {}}
    per_variant_s = budget_min * 60.0 / 2

    def aborted(variant, path, prev, what):
        # restore the pre-cycle copy: the warm restart collapsed the
        # model, so the cycle's periodic saves are poison
        copy_checkpoint(prev, path)
        print(f"[gate][{variant}+] {what}; checkpoint restored from {prev}",
              flush=True)
        results["variants"][variant] = {
            "gate": "aborted_collapse_restored_prev"}
        write_json(OUT_JSON, results)

    for variant in ("performance", "plain"):
        path = rd_full.ckpt_path(variant)
        if not os.path.exists(path):
            print(f"[skip] no checkpoint at {path}")
            continue
        ck = restore_checkpoint(path)
        # keep the pre-cycle params: a diverging warm restart overwrites
        # `path` every <=10 min, so `.prev` is the recovery copy
        prev = path + ".prev"
        copy_checkpoint(path, prev)
        # Default 7e-4 = the fresh run's LR (SGDR warm restart); late cycles
        # pass --base-lr ~2e-4 for an annealed polish from the peak pair.
        base_lr = (float(argv[argv.index("--base-lr") + 1])
                   if "--base-lr" in argv else 7e-4)
        # SGDR semantics need the cosine to ANNEAL within the cycle:
        # --sched-steps sizes it to the realistic step count; past it the
        # schedule clamps at min_lr (warmup_cosine).
        sched_steps = (int(argv[argv.index("--sched-steps") + 1])
                       if "--sched-steps" in argv else 7000)
        trainer = rd_full.variant_trainer(variant, min(steps, sched_steps),
                                          "--lnorm" in argv, base_lr)
        it = dm.train_iter()
        first = next(it)
        state = trainer.init_state(torch.Generator().manual_seed(1), first,
                                   params_i=ck["params_i"],
                                   params_p=ck["params_p"])
        noise = torch.Generator().manual_seed(100 + 7919 * cycle_seed)
        host_rng = np.random.default_rng(101 + 7919 * cycle_seed)
        t0 = time.perf_counter()
        last_save = t0
        gate_pending = True
        stopped = False
        for i in range(steps):
            qp = sample_qp(host_rng)
            state, aux = trainer.train_step(state, next(it), qp, noise)
            if i % 250 == 0:
                print(f"[{variant}+] step {i}: loss {float(aux['loss']):.3f} "
                      f"bpp {float(aux['bpp']):.4f} "
                      f"psnr {float(aux['psnr']):.2f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            # read through rd_full so harness overrides reach this module
            if gate_pending and i >= rd_full.GATE_STEP:
                gate_pending = False
                ok, _ = liveness_gate(trainer, state, gate_clips[0],
                                      gate_clips[1], variant, i)
                if not ok:
                    aborted(variant, path, prev,
                            f"cycle aborted at step {i}")
                    stopped = True
                    break
            if time.perf_counter() - last_save > 600.0:
                rd_full.save_variant(path, trainer)
                last_save = time.perf_counter()
            if time.perf_counter() - t0 > per_variant_s:
                print(f"[{variant}+] budget hit at step {i}")
                break
        if stopped:
            continue
        if gate_pending:
            # budget expired before GATE_STEP: gate NOW, never save ungated
            # (a collapsed save would poison .prev on the next cycle)
            ok, _ = liveness_gate(trainer, state, gate_clips[0],
                                  gate_clips[1], variant, -1)
            if not ok:
                aborted(variant, path, prev, "end-of-budget gate failed")
                continue
        rd_full.save_variant(path, trainer)

        curve = rd_full.estimated_curve(trainer, eval_clips, EVAL_QPS)
        results["variants"][variant] = {"estimated_rd": curve}
        # collapse tripwire: alive latent fractions + cross-clip recon PSNR
        # (high == constant decoder output)
        results["variants"][variant]["liveness"] = latent_liveness(
            trainer.dmc, eval_clips[0], eval_clips[1])
        print(f"[{variant}+] liveness="
              f"{results['variants'][variant]['liveness']}")
        print(f"[{variant}+] bpp={[round(b, 4) for b in curve['bpp']]}")
        print(f"[{variant}+] psnr={[round(p, 2) for p in curve['psnr']]}")
        print(f"[{variant}+] roi={[round(p, 2) for p in curve['roi_psnr']]}",
              flush=True)
        write_json(OUT_JSON, results)

    ok_variants = {v for v, c in results["variants"].items()
                   if "estimated_rd" in c}
    if {"performance", "plain"} <= ok_variants:
        results.update(rd_full.bd_fields(
            results["variants"]["performance"]["estimated_rd"],
            results["variants"]["plain"]["estimated_rd"],
            "bd_rate_roi_psnr_pct", "bd_psnr_roi_db", "bd_rate_psnr_pct",
            "bd_psnr_db"))
        for v, c in results["variants"].items():
            bpps = c["estimated_rd"]["bpp"]
            c["bpp_monotone_increasing_in_qp"] = all(
                bpps[i] < bpps[i + 1] for i in range(len(bpps) - 1))
        write_json(OUT_JSON, results)
    print(f"wrote {OUT_JSON}")
    return results


if __name__ == "__main__":
    main()
