#!/usr/bin/env python3
"""Where does a P-frame's time go on the host and on the card, for this
checkout's DMC and another checkout's, on the same weights?

    python3 experiments/host_turns.py --prev-port _prev/ssgvc_tpu_torch

Needs one CUDA card. Builds the full-width performance-variant DMC (bf16,
packed io) of both checkouts, this one first or the other first
(``--prev-first``), with ``chip_smoke.random_weights``, and times 8-frame
GOPs from a random DPB in turns (prev, new, new, prev) x ROUNDS: for each
GOP the host clock to the end of the queueing loop ("queued"), to the
synchronised end ("total"), and the CUDA-event span from the first to the
last operation of the GOP ("device span"). Then one GOP of each under
``torch.profiler``: host and device time summed per operator, the largest
differences printed. One JSON line at the end.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

H, W, FRAMES, QP, ROUNDS = 1088, 1920, 8, 32, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", required=True)
    ap.add_argument("--prev-first", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    if not torch.cuda.is_available():
        print("host_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.load_prev_port(args.prev_port)
    prev_cfg = importlib.import_module("prev_port.config")
    prev_dmc = importlib.import_module("prev_port.models.dmc")
    dev = torch.device("cuda")

    def build(which):
        if which == "new":
            cfg = DMCConfig.variant("performance", dtype="bfloat16",
                                    packed_io=True)
            return DMC(cfg, device=dev)
        cfg = prev_cfg.DMCConfig.variant("performance", dtype="bfloat16",
                                         packed_io=True)
        return prev_dmc.DMC(cfg, device=dev)

    order = ("prev", "new") if args.prev_first else ("new", "prev")
    models = {k: build(k) for k in order}
    chip_smoke.random_weights(torch, models["new"], args.seed)
    models["prev"].load_state_dict(models["new"].state_dict(), strict=True)
    for m in models.values():
        m.eval()

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(args.seed)
    frames = pixel_unshuffle(torch.rand((FRAMES, H, W, 3), generator=g,
                                        device=dev), 8).to(bf16)
    masks = pixel_unshuffle((torch.rand((FRAMES, H, W, 1), generator=g,
                                        device=dev) > 0.8).float(),
                            8).to(bf16)
    dpb0 = {"frame": pixel_unshuffle(torch.rand((1, H, W, 3), generator=g,
                                                device=dev), 8).to(bf16),
            "feature": torch.zeros((1, H // 8, W // 8, 256), dtype=bf16,
                                   device=dev)}

    def gop(model):
        dpb = dpb0
        for i in range(FRAMES):
            dpb = model(frames[i:i + 1], QP, dpb, after_i=(i == 0),
                        mask=masks[i:i + 1])["dpb"]

    def timed(model):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        gop(model)
        end.record()
        t_queued = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return dict(total=1e3 * (t1 - t0) / FRAMES,
                    queued=1e3 * (t_queued - t0) / FRAMES,
                    device_span=start.elapsed_time(end) / FRAMES)

    with torch.no_grad():
        for k in order:
            gop(models[k])
            gop(models[k])
        runs = {"prev": [], "new": []}
        for _ in range(ROUNDS):
            for who in ("prev", "new", "new", "prev"):
                runs[who].append(timed(models[who]))
        med = {who: {m: float(np.median([r[m] for r in rs]))
                     for m in ("total", "queued", "device_span")}
               for who, rs in runs.items()}
        for who in ("prev", "new"):
            print(f"{who}: ms/frame median of {2 * ROUNDS} GOPs in turns: "
                  + ", ".join(f"{m} {v:.3f}" for m, v in med[who].items()))

        from torch.profiler import ProfilerActivity, profile

        prof = {}
        for who in ("prev", "new"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                gop(models[who])
                torch.cuda.synchronize()
            ka = p.key_averages()
            prof[who] = {e.key: (e.self_cpu_time_total / 1e3 / FRAMES,
                                 getattr(e, "self_device_time_total",
                                         getattr(e, "self_cuda_time_total",
                                                 0)) / 1e3 / FRAMES,
                                 e.count / FRAMES) for e in ka}
        tot = {who: (sum(v[0] for v in d.values()),
                     sum(v[1] for v in d.values()),
                     sum(v[2] for v in d.values()))
               for who, d in prof.items()}
        for who in ("prev", "new"):
            print(f"{who} under the profiler, per frame: host self time "
                  f"{tot[who][0]:.3f} ms, device self time "
                  f"{tot[who][1]:.3f} ms, {tot[who][2]:.0f} events")
        keys = set(prof["prev"]) | set(prof["new"])
        diff = sorted(keys, key=lambda k: -abs(
            prof["new"].get(k, (0, 0, 0))[0]
            - prof["prev"].get(k, (0, 0, 0))[0]))
        for k in diff[:15]:
            a, b = prof["prev"].get(k, (0, 0, 0)), prof["new"].get(k,
                                                                (0, 0, 0))
            print(f"  {k[:60]:60s} host ms/frame prev {a[0]:.3f} new "
                  f"{b[0]:.3f}; device prev {a[1]:.3f} new {b[1]:.3f}; "
                  f"calls prev {a[2]:.1f} new {b[2]:.1f}")
    print(json.dumps({"host_turns": dict(built_first=order[0], median=med,
                                         runs=runs, profiled=tot)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
