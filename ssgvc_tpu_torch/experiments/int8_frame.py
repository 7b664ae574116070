"""The int8 bench frame split into the host's queueing and the card's work:
what ``SSGVC_INT8=2 python3 -m ssgvc_tpu_torch.bench`` times, taken apart.

    python3 -m ssgvc_tpu_torch.experiments.int8_frame [--frames 8]
        [--seed 0] [trace_dir]

The bench's int8 model and inputs (``bench.measure``: performance, bf16,
packed io, 1088x1920, ``DMC.init_`` from the seed, scales calibrated by
``bench.calibrate_int8``), one warm-up GOP through ``bench.gop``, then
(1) three GOPs: host ms a frame until ``gop`` returns (the queueing) and
until its bpp sum is read (the synchronised frame), the least of each;
(2) one GOP under ``torch.profiler``: device busy ms a frame (the union of
the device intervals), the int8 conv's kernels' device ms a frame (names
holding ``qconv``) and launches, every other kernel's, and the traced
window. Card only; prints one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import torch

from . import ARTIFACTS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir", nargs="?",
                    default=os.path.join(ARTIFACTS, "int8_frame"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("int8_frame: no CUDA device")
    from ..bench import CALIB_HW, WARMUP_QP, calibrate_int8, gop, int8_mode
    from ..config import DMCConfig
    from ..models.dmc import DMC
    from ..utils.profiling import profiled
    from .bench_sweep import make_gop_inputs
    from .profile_stages import card_line
    from .trace_bench import busy_share, kernel_table

    dev, h, w, n = "cuda", 1088, 1920, args.frames
    cfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=True)
    with int8_mode(True):
        model = DMC(cfg, device=dev).init_(
            torch.Generator().manual_seed(args.seed + 4)).eval()
        g = torch.Generator(device=dev).manual_seed(args.seed)
        frames, masks, dpb0 = make_gop_inputs(cfg, 1, h, w, n, g, dev)
        g = torch.Generator(device=dev).manual_seed(args.seed + 7)
        cal, cal_mask, cal_dpb = make_gop_inputs(cfg, 1, CALIB_HW, CALIB_HW,
                                                 1, g, dev)
        calibrate_int8(model, cal[0], cal_mask[0], cal_dpb)
        float(gop(model, frames, masks, WARMUP_QP, dpb0)[0])
        queued, total = [], []
        for r in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gop(model, frames, masks, 33 + r, dpb0)
            t1 = time.perf_counter()
            float(out[0])
            t2 = time.perf_counter()
            queued.append(1e3 * (t1 - t0) / n)
            total.append(1e3 * (t2 - t0) / n)
        before = set(glob.glob(os.path.join(args.trace_dir, "*.json")))
        with profiled(args.trace_dir) as prof:
            float(gop(model, frames, masks, 33, dpb0)[0])
    trace = (set(glob.glob(os.path.join(args.trace_dir, "*.json")))
             - before).pop()
    busy, window = busy_share(trace)
    table = kernel_table(prof)
    if not table:
        raise RuntimeError("int8_frame: the profiler shows no device time")
    q = {k: v for k, v in table.items() if "qconv" in k}
    q_ms = sum(ms for _, ms in q.values())
    other_ms = sum(ms for k, (_, ms) in table.items() if k not in q)
    out = dict(card=card_line(dev), frames=n,
               host_queued_ms_per_frame=min(queued),
               synced_ms_per_frame=min(total),
               device_busy_ms_per_frame=busy / n,
               traced_window_ms_per_frame=window / n,
               qconv_device_ms_per_frame=q_ms / n,
               qconv_launches_per_frame=sum(c for c, _ in q.values()) / n,
               qconv_kernels={k: [c, ms] for k, (c, ms) in q.items()},
               other_kernels_device_ms_per_frame=other_ms / n,
               other_launches_per_frame=sum(
                   c for k, (c, _) in table.items() if k not in q) / n)
    print(json.dumps({"int8_frame": out}))
    return out


if __name__ == "__main__":
    main()
