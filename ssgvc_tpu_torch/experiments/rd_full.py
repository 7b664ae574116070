"""Full-scale RD experiment on host data: mid-profile codec, long training
budget, QP-monotone RD curves, matched-rate ROI comparison (BD-rate),
MS-SSIM at 192 px, and real-bitstream verification.

The mask-SFT ('performance') variant is compared against 'plain' at
matched rate via BD-rate on ROI PSNR, and coded streams are checked
against the differentiable bpp estimates.

This module also holds what every RD entry point shares: the size
profiles (:func:`set_profile`), the checkpoint paths (:func:`ckpt_path`,
:func:`dmci_ckpt_path`), the training QP sampler (:func:`sample_qp`), the
intra model's RD loss and optimizer step (:func:`dmci_loss`,
:func:`dmci_step`) and the liveness gate (:func:`liveness_gate`).

    python3 -m ssgvc_tpu_torch.experiments.rd_full [steps] [--budget-min 90]
        [--profile tiny] [--lnorm] [--recon-skip] [--reuse-dmci]
        [--device=cpu]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config import MODEL_PROFILES
from . import ARTIFACTS, split_device, write_json

EVAL_QPS = [8, 20, 32, 44, 56]
LNORM = False  # --lnorm: lambda-normalized RD loss (see loss.py)
RECON_SKIP = False  # --recon-skip: recon_residual from-scratch training aid
PROFILE = "mid"
MID_DMC = MODEL_PROFILES["rd-mid"]["dmc"]
MID_DMCI = MODEL_PROFILES["rd-mid"]["dmci"]
TINY_DMC = MODEL_PROFILES["rd-tiny"]["dmc"]
TINY_DMCI = MODEL_PROFILES["rd-tiny"]["dmci"]
#: where the models live: "cuda" unless an entry point is given --device=cpu
DEVICE = "cuda"

CKPT_EXTRA = ""  # extra namespace tag (e.g. "-roisub" for class-filter masks)

#: CLI profile name -> MODEL_PROFILES key for the RD harness size tiers
RD_PROFILES = {"tiny": "rd-tiny", "mid": "rd-mid", "half": "rd-half"}

#: the intra model's AdamW weight decay (optax.adamw's default)
DMCI_WEIGHT_DECAY = 1e-4
DMCI_GRAD_CLIP = 5.0


def set_profile(profile: str) -> None:
    """One place every RD entry point (rd_tpu/rd_eval/rd_continue) resolves
    --profile: sets the model dims AND the checkpoint-path tag together so a
    profile switch can never restore shape-mismatched params."""
    global MID_DMC, MID_DMCI, PROFILE
    if profile not in RD_PROFILES:
        raise SystemExit(f"--profile must be one of {sorted(RD_PROFILES)}, "
                         f"got {profile}")
    p = MODEL_PROFILES[RD_PROFILES[profile]]
    MID_DMC, MID_DMCI = p["dmc"], p["dmci"]
    PROFILE = profile


def ckpt_path(variant: str) -> str:
    """The checkpoint file's name encodes profile + recipe so a --profile or
    --recon-skip switch can never restore shape- or semantics-mismatched
    params."""
    tag = f"{PROFILE}-skip" if RECON_SKIP else PROFILE
    return f"{ARTIFACTS}/rd_ckpt_{variant}_{tag}{CKPT_EXTRA}"


def sample_qp(host_rng) -> int:
    """55% near the eval QPs (so their table rows get dense updates), 25%
    uniform (so every row trains), 20% at the ladder extremes ([0,8) and
    [56,64)): data.device_synth.sample_qp's distribution, drawn from a
    numpy Generator."""
    u = host_rng.uniform()
    if u < 0.55:
        return int(np.clip(host_rng.choice(EVAL_QPS) + host_rng.integers(-3, 4),
                           0, 63))
    if u < 0.80:
        return int(host_rng.integers(0, 64))
    e = int(host_rng.integers(0, 8))
    return e if host_rng.uniform() < 0.5 else 63 - e


def dmci_ckpt_path() -> str:
    # DMCI has no recon_residual (intra), so only the profile tags it
    # (CKPT_EXTRA applies: namespacing keeps the headline anchor immutable
    # during side experiments)
    return f"{ARTIFACTS}/rd_ckpt_dmci_{PROFILE}{CKPT_EXTRA}"


def cpu_state(module) -> dict:
    """A snapshot of ``module``'s weights: CPU copies, which later
    optimizer steps (in place on the live tensors) do not touch."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def dmci_loss(model, x: torch.Tensor, qp: int, lnorm: bool, generator,
              train: bool = True):
    """The intra model's RD loss ``mean(bpp) + lambda(qp) * mse`` (divided by
    lambda under ``lnorm``): (loss, (mse, mean bpp))."""
    from ..training.loss import compute_lambda

    out = model(x, qp, train=train, generator=generator)
    mse = torch.mean((out["dpb"]["frame"].float() - x) ** 2)
    lam = compute_lambda(qp, 50.0, 38400.0, 64).to(x.device)
    bpp = torch.mean(out["bpp"])
    loss = bpp + lam * mse
    if lnorm:
        loss = loss / lam
    return loss, (mse, bpp)


def dmci_tx(model, lr):
    """optax.chain(clip_by_global_norm(5.0), adamw(lr)) over every DMCI
    parameter; ``lr`` a float or a schedule of the update count."""
    from ..training.optimizers import TrainOptimizer

    lr_fn = lr if callable(lr) else (lambda _s: lr)
    return TrainOptimizer(model.named_parameters(), lambda _path: "main",
                          {"main": (lr_fn, DMCI_WEIGHT_DECAY)}, "adamw",
                          DMCI_GRAD_CLIP)


def dmci_step(model, tx, x: torch.Tensor, qp: int, lnorm: bool, generator):
    """One optimizer step of the intra model on ``x``: (mse, bpp), detached
    tensors on the model's device."""
    from ..layers.blocks import cudnn_fp32

    tx.zero_grad()
    with cudnn_fp32(model.dtype, x.device):
        loss, (mse, bpp) = dmci_loss(model, x, qp, lnorm, generator)
        loss.backward()
    tx.step()
    return mse.detach(), bpp.detach()


def pretrain_dmci(steps: int, dm, budget_s: float, seed: int = 17,
                  reuse: bool = False):
    """The intra model pretrained on the data module's frames (a random
    frame of each clip, a :func:`sample_qp` QP): (model, params_i)."""
    from ..config import DMCIConfig
    from ..models.dmci import DMCI
    from ..training.calibrate import calibrate_dmci
    from ..training.loss import psnr_from_mse
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint

    model = DMCI(DMCIConfig(**MID_DMCI), device=DEVICE)
    if reuse and os.path.exists(dmci_ckpt_path()):
        ck = restore_checkpoint(dmci_ckpt_path())
        model.load_state_dict(ck["params_i"], strict=True)
        print(f"[dmci] reused pretrained params from {dmci_ckpt_path()}")
        return model, ck["params_i"]
    it = dm.train_iter()
    first = next(it)
    dev = torch.device(DEVICE)
    x0 = torch.from_numpy(first["frames"][:, 0]).to(dev)
    model.init_(torch.Generator().manual_seed(seed))
    calibrate_dmci(model, x0)
    tx = dmci_tx(model, 1e-3)
    noise = torch.Generator(device=dev).manual_seed(seed)

    host = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(it)
        t = int(host.integers(0, batch["frames"].shape[1]))
        x = torch.from_numpy(batch["frames"][:, t]).to(dev)
        qp = sample_qp(host)
        mse, bpp = dmci_step(model, tx, x, qp, LNORM, noise)
        if i % 250 == 0:
            print(f"[dmci] step {i}: psnr {float(psnr_from_mse(mse)):.2f} "
                  f"bpp {float(bpp):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if time.perf_counter() - t0 > budget_s:
            print(f"[dmci] budget hit at step {i}")
            break
    params = cpu_state(model)
    save_checkpoint(dmci_ckpt_path(), {"params_i": params})
    print(f"[dmci] saved pretrain checkpoint to {dmci_ckpt_path()}")
    return model, params


GATE_STEP = 1000          # run the collapse gate once, this many steps in
GATE_CROSS_CLIP_DB = 25.0  # recons of different clips more similar than this
#                            at EVERY QP == input-independent decoder


def liveness_gate(trainer, state, clip_a, clip_b, variant, step_no):
    """Go/no-go collapse gate: abort a long cycle early instead of burning
    the full budget on a collapsed run. The weights are ``trainer.dmc``'s
    (``state`` holds the step and the ALM scalars). Returns (ok,
    report)."""
    from ..training.evaluate import latent_liveness, liveness_collapsed

    report = latent_liveness(trainer.dmc, clip_a, clip_b)
    cross = [r["recon_cross_clip_psnr"] for r in report.values()]
    alive = [r["alive_y"] for r in report.values()]
    collapsed = liveness_collapsed(report, GATE_CROSS_CLIP_DB)
    status = "COLLAPSED" if collapsed else "alive"
    print(f"[gate][{variant}] step {step_no}: {status} "
          f"cross_clip_psnr={[round(c, 1) for c in cross]} "
          f"alive_y={[round(a, 3) for a in alive]}", flush=True)
    return not collapsed, report


def variant_trainer(variant: str, total_iters: int, lnorm: bool,
                    base_lr: float = 7e-4, roi_weight: float = 100.0):
    """The RD recipe's Trainer for ``variant``: fp32, accumulation 1,
    ``base_lr`` cosine-decayed to 5e-5 over ``total_iters``, ROI weight,
    the profile's widths and the recon-skip switch."""
    from ..config import DMCConfig, DMCIConfig, TrainConfig
    from ..training.trainer import Trainer

    cfg = TrainConfig(dmc_variant=variant, accumulation_steps=1)
    cfg.precision = "fp32"
    cfg.optimizer.base_lr = base_lr
    cfg.optimizer.min_lr = 5e-5
    cfg.roi_weight = roi_weight
    cfg.lambda_normalize = lnorm
    return Trainer(cfg, total_iters=total_iters,
                   dmc_cfg=DMCConfig.variant(variant,
                                             recon_residual=RECON_SKIP,
                                             **MID_DMC),
                   dmci_cfg=DMCIConfig(**MID_DMCI), device=DEVICE)


def save_variant(path: str, trainer, params_p=None) -> None:
    """The variant checkpoint: ``params_p`` (by default the live DMC's) and
    the trainer's DMCI, as CPU copies."""
    from ..utils.checkpoint import save_checkpoint

    save_checkpoint(path, {
        "params_p": params_p if params_p is not None
        else cpu_state(trainer.dmc),
        "params_i": cpu_state(trainer.dmci)})


def train_variant(variant: str, steps: int, dm, budget_s: float,
                  seed: int = 0, params_i=None, gate_clips=None):
    """Train one DMC variant on the data module's batches: (trainer, state,
    ok); ok is False when the liveness gate aborted the run."""
    trainer = variant_trainer(variant, steps, LNORM)
    it = dm.train_iter()
    first = next(it)
    params_p = None
    path = ckpt_path(variant)
    if os.path.exists(path):
        # resume an interrupted run's periodic checkpoint (params only;
        # optimizer state restarts, which the cosine schedule tolerates)
        from ..utils.checkpoint import restore_checkpoint
        ck = restore_checkpoint(path)
        params_i, params_p = ck["params_i"], ck["params_p"]
        print(f"[{variant}] resuming params from {path}")
    state = trainer.init_state(torch.Generator().manual_seed(seed), first,
                               params_i=params_i, params_p=params_p)
    noise = torch.Generator().manual_seed(seed + 1)
    host_rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    last_save = t0
    gate_pending = gate_clips is not None and params_p is None
    for i in range(steps):
        qp = sample_qp(host_rng)
        state, aux = trainer.train_step(state, next(it), qp, noise)
        if i % 250 == 0:
            print(f"[{variant}] step {i}: loss {float(aux['loss']):.3f} "
                  f"bpp {float(aux['bpp']):.4f} psnr {float(aux['psnr']):.2f}"
                  f" ({time.perf_counter() - t0:.0f}s)", flush=True)
        if gate_pending and i >= GATE_STEP:
            gate_pending = False
            ok, _ = liveness_gate(trainer, state, gate_clips[0],
                                  gate_clips[1], variant, i)
            if not ok:
                print(f"[gate][{variant}] aborting cycle at step {i} — "
                      f"collapsed run, checkpoint NOT saved", flush=True)
                return trainer, state, False
        # periodic checkpoint: an interrupted run loses <=10 min, and
        # rd_continue can always pick up from ckpt_path(variant)
        if time.perf_counter() - last_save > 600.0:
            save_variant(path, trainer)
            last_save = time.perf_counter()
        if time.perf_counter() - t0 > budget_s:
            print(f"[{variant}] budget hit at step {i}")
            break
    if gate_pending:
        # budget expired before GATE_STEP: gate before the caller saves
        ok, _ = liveness_gate(trainer, state, gate_clips[0], gate_clips[1],
                              variant, -1)
        if not ok:
            print(f"[gate][{variant}] end-of-budget gate failed — "
                  f"checkpoint NOT saved", flush=True)
            return trainer, state, False
    print(f"[{variant}] trained in {time.perf_counter() - t0:.1f}s")
    return trainer, state, True


def eval_clip_set(crop: int, n: int = 6, roi_subset: bool = False,
                  texture: str = "smooth"):
    """The pinned held-out clips: seed 777, clip i drawn with rng 900 + i."""
    from ..data.dataset import SyntheticClipDataset

    ds = SyntheticClipDataset(num_clips=8, seq_len=4, crop_size=crop,
                              seed=777, texture=texture,
                              roi_subset=roi_subset)
    return [ds.__getitem__(i, rng=np.random.default_rng(900 + i))
            for i in range(n)]


def gate_clip_set(crop: int, roi_subset: bool = False):
    """The gate's two clips at the train crop: seed 555, rng 600 + i."""
    from ..data.dataset import SyntheticClipDataset

    ds = SyntheticClipDataset(num_clips=4, seq_len=2, crop_size=crop,
                              seed=555, texture="smooth",
                              roi_subset=roi_subset)
    return [ds.__getitem__(i, rng=np.random.default_rng(600 + i))
            for i in range(2)]


def estimated_curve(trainer, clips, qps):
    """rd_sweep over ``qps`` of evaluate_gop_estimated on every clip with
    the trainer's models."""
    from ..training.evaluate import evaluate_gop_estimated, rd_sweep

    index_map = list(trainer.cfg.compression.index_map)
    qp_shift = list(trainer.dmc_cfg.qp_shift)

    def eval_qp(qp):
        out = []
        for frames, masks in clips:
            out.extend(evaluate_gop_estimated(
                trainer.dmci, trainer.dmc, frames, masks, qp, index_map,
                qp_shift))
        return out

    return rd_sweep(eval_qp, qps=qps)


def bd_fields(perf: dict, plain: dict, *names) -> dict:
    """The BD numbers of ``perf`` against ``plain`` by their JSON keys."""
    from ..training.evaluate import bd_psnr, bd_rate

    fns = {"bd_rate_roi_psnr_pct": (bd_rate, "roi_psnr"),
           "bd_psnr_roi_db": (bd_psnr, "roi_psnr"),
           "bd_rate_psnr_pct": (bd_rate, "psnr"),
           "bd_psnr_db": (bd_psnr, "psnr")}
    return {k: fns[k][0](plain["bpp"], plain[fns[k][1]], perf["bpp"],
                         perf[fns[k][1]]) for k in names}


def main(argv=None):
    global LNORM, RECON_SKIP, DEVICE
    DEVICE, argv = split_device(sys.argv[1:] if argv is None else argv)
    LNORM = "--lnorm" in argv
    RECON_SKIP = "--recon-skip" in argv
    steps = int(argv[0]) if argv and not argv[0].startswith("-") else 12000
    budget_min = (float(argv[argv.index("--budget-min") + 1])
                  if "--budget-min" in argv else 120.0)
    tiny = "--profile" in argv and argv[argv.index("--profile") + 1] == "tiny"
    # rd-tiny, else rd-mid (any other --profile too), whatever an earlier
    # entry point in this process set
    set_profile("tiny" if tiny else "mid")
    # budget split: ~20% DMCI, ~40% each DMC variant
    total_s = budget_min * 60.0

    from ..coding.codec import VideoCodec
    from ..data.dataset import ClipDataModule, SyntheticClipDataset
    from ..training.evaluate import evaluate_gop_coded

    crop, bs = (64, 4) if tiny else (128, 8)
    train_ds = SyntheticClipDataset(num_clips=512, seq_len=4, crop_size=crop,
                                    seed=3, texture="smooth")
    dm = ClipDataModule(train_ds, batch_size=bs, split=(0.95, 0.05, 0.0),
                        seed=3)
    # eval clips: 192 px so MS-SSIM is computed
    eval_clips = eval_clip_set(192)
    # gate clips at the train crop (cheap: 2 clips x 3 QPs forward passes)
    gate_clips = gate_clip_set(crop)

    results = {"steps": steps, "budget_min": budget_min,
               "lambda_normalize": LNORM, "recon_residual": RECON_SKIP,
               "profile": PROFILE,
               "model": {"dmc": MID_DMC, "dmci": MID_DMCI}, "variants": {}}
    out_path = f"{ARTIFACTS}/rd_full.json"

    _, params_i = pretrain_dmci(max(1500, steps // 4), dm, total_s * 0.2,
                                reuse="--reuse-dmci" in argv)

    trained = {}
    for variant in ("performance", "plain"):
        trainer, state, ok = train_variant(variant, steps, dm, total_s * 0.4,
                                           params_i=params_i,
                                           gate_clips=gate_clips)
        if not ok:
            results["variants"][variant] = {"gate": "aborted_collapse"}
            write_json(out_path, results)
            continue
        curve = estimated_curve(trainer, eval_clips, EVAL_QPS)
        results["variants"][variant] = {"estimated_rd": curve}
        trained[variant] = trainer
        save_variant(ckpt_path(variant), trainer)
        write_json(out_path, results)  # partial artifact survives a crash
        print(f"[{variant}] RD: bpp={[round(b,4) for b in curve['bpp']]}")
        print(f"[{variant}]     psnr={[round(p,2) for p in curve['psnr']]}")
        print(f"[{variant}]     roi_psnr="
              f"{[round(p,2) for p in curve['roi_psnr']]}")
        print(f"[{variant}]     msssim="
              f"{[round(m, 4) if m is not None else None for m in curve['msssim']]}",
              flush=True)

    if len(trained) < 2:
        print("[bd] skipped: a variant was gate-aborted")
        write_json(out_path, results)
        return results

    # matched-rate comparison: BD-rate of performance vs plain on ROI PSNR
    perf = results["variants"]["performance"]["estimated_rd"]
    plain = results["variants"]["plain"]["estimated_rd"]
    results.update(bd_fields(perf, plain, "bd_rate_roi_psnr_pct",
                             "bd_rate_psnr_pct", "bd_psnr_roi_db"))
    print(f"[bd] ROI-PSNR BD-rate (performance vs plain): "
          f"{results['bd_rate_roi_psnr_pct']:+.1f}% "
          f"(negative = rate saved at equal ROI quality)")
    print(f"[bd] global-PSNR BD-rate: {results['bd_rate_psnr_pct']:+.1f}%")
    print(f"[bd] ROI BD-PSNR (performance vs plain at matched rate): "
          f"{results['bd_psnr_roi_db']:+.2f} dB")

    # QP monotonicity check: lambda(qp) interpolates 50 -> 38400 with QP, so
    # HIGHER qp = heavier distortion weight = HIGHER rate; bpp must rise
    for v, c in results["variants"].items():
        bpps = c["estimated_rd"]["bpp"]
        mono = all(bpps[i] < bpps[i + 1] for i in range(len(bpps) - 1))
        results["variants"][v]["bpp_monotone_increasing_in_qp"] = mono
        print(f"[mono] {v}: bpp monotone (rising) over QP: {mono} {bpps}")

    # real coded path: est vs real bpp at three QPs
    trainer = trained["performance"]
    codec = VideoCodec(trainer.dmci.eval(), trainer.dmc.eval())
    est_vs_real = {}
    for qp in (20, 32, 44):
        frames, masks = eval_clips[0]
        coded = evaluate_gop_coded(
            codec, frames, masks, qp=qp,
            index_map=list(trainer.cfg.compression.index_map),
            qp_shift=list(trainer.dmc_cfg.qp_shift))
        real_bpp = float(np.mean([r["bpp"] for r in coded
                                  if r["frame_type"] == "P"]))
        est_bpp = perf["bpp"][EVAL_QPS.index(qp)] if qp in EVAL_QPS else None
        est_vs_real[qp] = {"real": real_bpp, "estimated": est_bpp}
        print(f"[coded] qp={qp}: real {real_bpp:.4f} bpp"
              + (f" vs est {est_bpp:.4f}" if est_bpp else ""))
    results["estimate_vs_real_bpp"] = est_vs_real

    write_json(out_path, results)
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
