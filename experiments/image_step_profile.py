#!/usr/bin/env python3
"""Where does the image trainer's step go on the host and on the card?

    python3 experiments/image_step_profile.py [--seed 0]     # on the card

The image CLI's step (``trainer_image_model.train_step``: ``image_loss``
with train=True, the backward, then ``make_tx``'s clip and AdamW) on the
full DMCI in bf16, B=16 random 256x256 frames, the default
``TrainConfig`` optimizer: WARMUP steps, then STEPS steps with CUDA events
and the host clock at each boundary (forward, backward, optimizer; no
synchronisation inside a step, so the host clock shows when the host had
queued each part and the events when the card finished it), then PROFILED
steps under ``torch.profiler``: host and device self time per operator,
the largest of each printed. One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

B, HW, QP, WARMUP, STEPS, PROFILED = 16, 256, 32, 2, 6, 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from ssgvc_tpu_torch.config import DMCIConfig, TrainConfig
    from ssgvc_tpu_torch.layers.blocks import cudnn_fp32
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.trainer_image_model import (image_loss, make_tx,
                                                     train_step)

    if not torch.cuda.is_available():
        print("image_step_profile: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.phase_device(torch)[0]
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    cfg = TrainConfig()
    model = DMCI(DMCIConfig(dtype="bfloat16"), device=dev)
    model.init_(torch.Generator().manual_seed(args.seed))
    tx = make_tx(model, cfg, total_iters=100)
    comp = cfg.compression
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((B, HW, HW, 3), device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())

    def step(marks):
        """One step, recording (host clock, CUDA event) at each boundary."""
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((time.perf_counter(), e))

        mark()
        tx.zero_grad()
        loss, _ = image_loss(model, x, QP, comp, True, gen)
        mark()
        with cudnn_fp32(model.dtype, dev):
            loss.backward()
        mark()
        tx.step()
        mark()

    for _ in range(WARMUP):
        train_step(model, tx, x, QP, comp, gen)
    torch.cuda.synchronize()
    rows = []
    for _ in range(STEPS):
        marks = []
        step(marks)
        marks[-1][1].synchronize()
        t_end = time.perf_counter()
        (h0, e0), (h1, e1), (h2, e2), (h3, e3) = marks
        rows.append(dict(
            host_queued_ms=dict(forward=1e3 * (h1 - h0),
                                backward=1e3 * (h2 - h1),
                                optimizer=1e3 * (h3 - h2)),
            device_ms=dict(forward=e0.elapsed_time(e1),
                           backward=e1.elapsed_time(e2),
                           optimizer=e2.elapsed_time(e3)),
            step_ms=e0.elapsed_time(e3), wall_ms=1e3 * (t_end - h0)))
        torch.cuda.synchronize()
    med = {k: {p: float(np.median([r[k][p] for r in rows]))
               for p in ("forward", "backward", "optimizer")}
           for k in ("host_queued_ms", "device_ms")}
    med["step_ms"] = float(np.median([r["step_ms"] for r in rows]))
    med["wall_ms"] = float(np.median([r["wall_ms"] for r in rows]))
    print(f"image step, B={B} {HW}x{HW} full DMCI bf16 ({n_params} "
          f"parameters), median of {STEPS}: events {med['step_ms']:.1f} ms "
          f"(forward {med['device_ms']['forward']:.1f}, backward "
          f"{med['device_ms']['backward']:.1f}, optimizer "
          f"{med['device_ms']['optimizer']:.1f}); host queued forward "
          f"{med['host_queued_ms']['forward']:.1f}, backward "
          f"{med['host_queued_ms']['backward']:.1f}, optimizer "
          f"{med['host_queued_ms']['optimizer']:.1f}; wall "
          f"{med['wall_ms']:.1f} [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(PROFILED):
            train_step(model, tx, x, QP, comp, gen)
        torch.cuda.synchronize()
    prof = {e.key: (e.self_cpu_time_total / 1e3 / PROFILED,
                    getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    / 1e3 / PROFILED, e.count / PROFILED)
            for e in p.key_averages()}
    tot = [sum(v[i] for v in prof.values()) for i in range(3)]
    print(f"under the profiler, per step: host self time {tot[0]:.1f} ms, "
          f"device self time {tot[1]:.1f} ms, {tot[2]:.0f} events")
    top = {}
    for i, what in ((0, "host"), (1, "device")):
        keys = sorted(prof, key=lambda k: -prof[k][i])[:20]
        top[what] = [(k, *prof[k]) for k in keys]
        print(f"largest {what} self time per step:")
        for k in keys:
            h, d, n = prof[k]
            print(f"  {k[:70]:70s} host {h:8.3f} ms  device {d:8.3f} ms  "
                  f"calls {n:7.1f}")
    print(json.dumps({"image_step_profile": dict(
        card=card, batch=B, crop=HW, parameters=n_params, median=med,
        runs=rows, profiled_totals=tot, top=top)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
