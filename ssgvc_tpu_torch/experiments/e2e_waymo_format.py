"""End-to-end Waymo-format user journey, chained for real in one script:

  1. synthesize Waymo-format TFRecord segments (JPEG front-camera frames in
     the proto layout the data module and the reference's vendored reader
     parse),
  2. build the segmentation-mask cache with ``build_cache`` (a pluggable
     segmenter stands in for YOLO, whose weights are not shipped),
  3. pretrain the tiny intra model and train through the port's video CLI
     (``ssgvc_tpu_torch.trainer_seg_video_model``, a child process) on that
     data,
  4. restore the written checkpoint and run a real-bitstream coded eval
     (every decoded frame checked against the encoder's).

Reference journey: trainer_seg_video_model.py:1412-1510 of the reference
(build cache -> datamodule -> fit -> checkpoint).

    python3 -m ssgvc_tpu_torch.experiments.e2e_waymo_format [--device=cpu]

Runs on the card unless given ``--device=cpu`` (the CLI child too). The
intra pretrain stops at ``E2E_DMCI_BUDGET_S`` seconds (default 300) after
its first step. Writes ``artifacts/torch/e2e_waymo_format.json``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import ARTIFACTS, split_device, write_json

#: the directory that holds the ssgvc_tpu_torch package
ROOT = str(Path(__file__).resolve().parents[2])


def synth_frame(t: int, hw, seed: int):
    """Driving-like frame: smooth gradient background + a moving 'car' box;
    returns (rgb uint8, gt box in pixel coords)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([
        0.35 + 0.3 * yy / h,
        0.45 + 0.2 * xx / w,
        0.55 - 0.25 * yy / h,
    ], axis=-1)
    bh, bw = h // 4, w // 5
    top = int((h - bh) * 0.5 + 0.25 * h * np.sin(0.4 * t))
    left = int((t * w * 0.06 + rng.uniform(0, 4)) % max(w - bw, 1))
    top = int(np.clip(top, 0, h - bh))
    frame = bg.copy()
    ys, xs = np.mgrid[0:bh, 0:bw].astype(np.float32)
    tex = 0.5 + 0.4 * np.sin(ys / 6.0) * np.cos(xs / 7.0)
    frame[top:top + bh, left:left + bw] = np.stack(
        [tex, 0.9 - 0.5 * tex, 0.3 + 0.3 * tex], axis=-1)
    rgb = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return rgb, (top, left, bh, bw)


def make_segment(path: str, n_frames: int, hw, seed: int):
    """A TFRecord of ``n_frames`` Waymo frame protos; returns each frame's
    box."""
    from ..data import tfrecord, waymo_proto

    boxes = []
    records = []
    for t in range(n_frames):
        rgb, box = synth_frame(t, hw, seed * 1000 + t)
        boxes.append(box)
        records.append(waymo_proto.build_frame_proto(
            waymo_proto.encode_jpeg(rgb, quality=95),
            context_name=f"e2e-seg-{seed}"))
    tfrecord.write_records(path, records)
    return boxes


def segmenter_for(boxes):
    """The stand-in segmenter of one segment: frame i's box as a car."""
    state = {"i": 0}

    def seg(rgb):
        top, left, bh, bw = boxes[state["i"]]
        state["i"] += 1
        m = np.zeros(rgb.shape[:2], np.float32)
        m[top:top + bh, left:left + bw] = 1.0
        return [(m, 2)]  # COCO class 2 = car

    return seg


def pretrain_dmci(ds, device: str, steps: int, budget_s: float):
    """The tiny intra model, calibrated on one frame and trained on batches
    of 4 random crops (loss mean(bpp) / lambda + mse, clip 5, AdamW 1e-3);
    the budget counts from the first step's end. Returns (model, steps run,
    the last mse)."""
    from ..config import MODEL_PROFILES, DMCIConfig
    from ..models.dmci import DMCI
    from ..training.calibrate import calibrate_dmci
    from ..training.loss import compute_lambda
    from .rd_full import dmci_tx

    dev = torch.device(device)
    # the CLI's model_profile=tiny
    dmci = DMCI(DMCIConfig(**MODEL_PROFILES["tiny"]["dmci"]), device=dev)
    rng_np = np.random.default_rng(7)
    x0 = torch.from_numpy(ds.__getitem__(0, rng=rng_np)[0]).to(dev)
    dmci.init_(torch.Generator().manual_seed(7))
    calibrate_dmci(dmci, x0)
    tx = dmci_tx(dmci, 1e-3)
    noise = torch.Generator(device=dev).manual_seed(8)

    def batch4():
        xs = [ds.__getitem__(int(rng_np.integers(0, len(ds))),
                             rng=rng_np)[0][0] for _ in range(4)]
        return torch.from_numpy(np.stack(xs)).to(dev)

    mse, t_train, i = None, None, 0
    for i in range(steps):
        x = batch4()
        qp = int(rng_np.integers(0, 64))
        tx.zero_grad()
        out = dmci(x, qp, train=True, generator=noise)
        mse = torch.mean((out["dpb"]["frame"].float() - x) ** 2)
        lam = compute_lambda(qp, 50.0, 38400.0).to(dev)
        (torch.mean(out["bpp"]) / lam + mse).backward()
        tx.step()
        mse = mse.detach()
        if t_train is None:
            float(mse)
            t_train = time.perf_counter()
        elif time.perf_counter() - t_train > budget_s:
            break
    return dmci, i + 1, float(mse)


def main(argv=None, *, hw=(128, 192), n_frames=12, segments=2,
         dmci_steps=4000, epochs=2, batch_size=2, seq_len=3, crop=64):
    """The journey; the keyword arguments size it (their defaults are the
    reference journey's)."""
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="e2e_waymo_")
    data_dir = os.path.join(work, "waymo")
    cache_dir = os.path.join(work, "seg_cache")
    log_dir = os.path.join(work, "logs")
    os.makedirs(data_dir)
    result = {"work_dir": work, "stages": {}}

    # -- 1. Waymo-format TFRecords ------------------------------------------
    all_boxes = {}
    for seg in range(segments):
        p = os.path.join(data_dir, f"segment_{seg}.tfrecord")
        all_boxes[p] = make_segment(p, n_frames, hw, seed=seg + 1)
    result["stages"]["tfrecords"] = {
        "segments": segments, "frames_per_segment": n_frames,
        "hw": list(hw)}

    # -- 2. mask cache (a stand-in segmenter for YOLO) ----------------------
    from ..data.build_cache import build_cache

    written = 0
    for p in sorted(all_boxes):
        stats = build_cache(p, cache_dir, segmenter=segmenter_for(
            all_boxes[p]))
        written += stats["written"]
    if written != segments * n_frames:
        raise RuntimeError(f"mask cache: {written} masks written, want "
                           f"{segments * n_frames}")
    result["stages"]["cache"] = {"masks_written": written}

    # -- 2.5 pretrain the intra model (the reference's journey loads a
    # pretrained image checkpoint and freezes it; a random frozen DMCI caps
    # the pipeline at garbage PSNR), saved as a port checkpoint that
    # image_checkpoint_path accepts ----------------------------------------
    from ..data.dataset import WaymoClipDataset
    from ..utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    ds = WaymoClipDataset(sorted(all_boxes), seg_cache_dir=cache_dir,
                          seq_len=1, slide=1, crop_size=crop,
                          strict_masks=True)
    budget = float(os.environ.get("E2E_DMCI_BUDGET_S", "300"))
    dmci, steps, mse = pretrain_dmci(ds, device, dmci_steps, budget)
    dmci_psnr = float(-10.0 * np.log10(max(mse, 1e-12)))
    dmci_ckpt = os.path.join(work, "dmci_pretrain")
    save_checkpoint(dmci_ckpt, {"params_i": {
        k: v.detach().cpu() for k, v in dmci.state_dict().items()}})
    result["stages"]["dmci_pretrain"] = {
        "seconds": round(time.perf_counter() - t0, 1), "steps": steps,
        "train_psnr_db": round(dmci_psnr, 2)}
    del dmci

    # -- 3. train through the port's CLI ------------------------------------
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    overrides = [
        f"dataset.data_dir={data_dir}",
        f"dataset.seg_cache_dir={cache_dir}",
        f"image_checkpoint_path={dmci_ckpt}",
        f"dataset.batch_size={batch_size}", f"dataset.seq_len={seq_len}",
        f"dataset.crop_size={crop}",
        "dataset.strict_masks=true",
        f"epochs={epochs}", "model_profile=tiny", "precision=fp32",
        # from-scratch recipe: start at the copy-prev bound + balanced
        # per-QP gradients
        "recon_residual=true", "lambda_normalize=true",
        "accumulation_steps=1", "num_devices=1",
        f"log_dir={log_dir}", "log_interval=5",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ssgvc_tpu_torch.trainer_seg_video_model",
         f"--device={device}"] + overrides,
        env=env, cwd=work, capture_output=True, text=True, timeout=3000)
    sys.stdout.write(proc.stdout[-2000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"trainer CLI failed rc={proc.returncode}")
    ckpt = None
    for line in proc.stdout.splitlines():
        if line.startswith("[done] checkpoint at "):
            ckpt = line.split("[done] checkpoint at ")[1].split(" (")[0]
    if not (ckpt and os.path.isfile(ckpt)):
        raise RuntimeError(f"no checkpoint file: {ckpt}")
    result["stages"]["train"] = {
        "seconds": round(time.perf_counter() - t0, 1), "checkpoint": ckpt}

    # -- 4. coded eval from the written checkpoint --------------------------
    from ..coding.codec import VideoCodec
    from ..config import load_config
    from ..training.evaluate import evaluate_gop_coded
    from ..training.trainer import Trainer
    from ..utils.checkpoint import restore_checkpoint

    cfg = load_config(os.path.join(work, "video_compression_config.yaml"),
                      overrides)
    trainer = Trainer(cfg, total_iters=1, device=device)
    trainer.init_state(torch.Generator().manual_seed(0))
    restore_checkpoint(ckpt, trainer)

    ds = WaymoClipDataset(sorted(all_boxes), seg_cache_dir=cache_dir,
                          seq_len=seq_len, slide=1, crop_size=crop,
                          strict_masks=True)
    frames, masks = ds.__getitem__(0, rng=np.random.default_rng(0))
    codec = VideoCodec(trainer.dmci.eval(), trainer.dmc.eval())
    with torch.no_grad():
        coded = evaluate_gop_coded(
            codec, frames, masks, qp=32,
            index_map=list(cfg.compression.index_map),
            qp_shift=list(trainer.dmc_cfg.qp_shift))
    result["stages"]["coded_eval"] = {
        "frames": [{k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in r.items()} for r in coded],
        "mean_p_bpp": round(float(np.mean(
            [r["bpp"] for r in coded if r["frame_type"] == "P"])), 4),
        "mean_p_psnr": round(float(np.mean(
            [r["psnr"] for r in coded if r["frame_type"] == "P"])), 2),
    }

    result["total_seconds"] = round(time.perf_counter() - t_start, 1)
    out = f"{ARTIFACTS}/e2e_waymo_format.json"
    write_json(out, result)
    print(f"wrote {out} ({result['total_seconds']}s)")
    shutil.rmtree(work, ignore_errors=True)
    return result


if __name__ == "__main__":
    main()
