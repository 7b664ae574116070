"""Capture a ``torch.profiler`` trace of the 1080p P-frame loop and print
the device time by kernel.

The GOP of ``bench_sweep`` (batch 1, ``SSGVC_PACKED``, ``SSGVC_FRAMES``
frames, 16 by default), one warm-up, then two reps under
``utils/profiling.profiled``. The Chrome trace lands in the trace
directory (``artifacts/torch/trace_bench`` by default); the script prints
``key_averages()``' device time and count by kernel name, the port's
kernels named as their launch counters name them ("dcb", "dcb_chain"), and
the device's busy and idle share of the traced window (the union of the
trace's device intervals over its first to last event). Where
``key_averages()`` shows no device time it fails, rather than print zeros.
The profiler can miss a launch or two of a window: on the H100 two
4-frame traces held 142 and 143 of their 144 ``dcb`` launches, a 16-frame
one all 576.

    python3 -m ssgvc_tpu_torch.experiments.trace_bench [trace_dir]
        [--seed 0] [--device=cpu]

``--growth`` (card only) asks instead why the bench's 48-frame GOP reads
slower a frame than its 8-frame one, on ``ssgvc_tpu_torch.bench``'s model
and inputs (performance, bf16, packed io, 1088x1920), every GOP through
``bench.gop``: (1) GOPs of 8, 48, 8, 16 and 48 frames, three timed each,
the host's queueing and the synchronised total a frame; (2) one GOP of 48
with a CUDA event after each frame (frame 0's time holds the ingest
permutation): device ms, host ms and the DPB feature's max |x| a frame;
(3) ``torch.profiler`` over frames 2-7 and over frames 40-45: device ms a
frame by kernel, the largest changes first, with ``nvidia-smi``'s SM
clock, power and temperature sampled every 200 ms beside it. Prints one
JSON object last.

    python3 -m ssgvc_tpu_torch.experiments.trace_bench --growth [--seed 0]
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

from . import ARTIFACTS, split_device

#: the port's kernels by their CUDA names, as the launch counters name them
PORT_KERNELS = {"dcb_kernel": "dcb", "chain_kernel": "dcb_chain"}
_PORT_RE = re.compile(r"\b(dcb_kernel|chain_kernel)\b")
#: the trace's device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: --growth: the GOP lengths timed, and the windows of frames profiled
GROWTH_LENGTHS = (8, 48, 8, 16, 48)
GROWTH_WINDOWS = ((2, 8), (40, 46))
GROWTH_QP = 33


def build(seed: int = 0, device="cuda", n_frames: int = 16, b: int = 1,
          h: int = 1088, w: int = 1920, packed: bool = False):
    """(gop, (model, frames, masks, dpb0)): the bench's GOP
    (:func:`ssgvc_tpu_torch.bench.gop`, batched ingest) on the performance
    variant in bf16, weights and inputs from ``seed``."""
    from ..bench import gop
    from ..config import DMCConfig
    from ..models.dmc import DMC
    from .bench_sweep import make_gop_inputs

    cfg = DMCConfig.variant("performance", dtype="bfloat16",
                            packed_io=packed)
    model = DMC(cfg, device=device).init_(
        torch.Generator().manual_seed(seed + 4)).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    frames, masks, dpb0 = make_gop_inputs(cfg, b, h, w, n_frames, g, device)
    return gop, (model, frames, masks, dpb0)


def port_name(kernel: str) -> str:
    """The launch counter's name of a port kernel, else the kernel's own."""
    m = _PORT_RE.search(kernel)
    return PORT_KERNELS[m.group(1)] if m else kernel


def kernel_table(prof) -> Dict[str, Tuple[int, float]]:
    """{kernel: (count, device ms)} from ``prof.key_averages()``: the
    entries that ran on the card, port kernels merged under their
    counters' names."""
    from torch.autograd import DeviceType

    rows: Dict[str, Tuple[int, float]] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        name = port_name(e.key)
        n, ms = rows.get(name, (0, 0.0))
        rows[name] = (n + e.count, ms + us / 1e3)
    return rows


def busy_share(trace_file: str) -> Tuple[float, float]:
    """(device busy ms, window ms) of an exported Chrome trace: the union
    of its device intervals, and the span from its first event to its
    last."""
    with open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise RuntimeError(f"trace_bench: {trace_file} holds no event")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    spans: List[Tuple[float, float]] = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, None
    for s, t in spans:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy / 1e3, (t1 - t0) / 1e3


def growth(seed: int = 0, device="cuda") -> dict:
    """``--growth`` (module docstring): the numbers it prints, as a dict."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_stages import card_line

    if torch.device(device).type != "cuda":
        raise RuntimeError("trace_bench --growth times frames with CUDA "
                           "events: it needs a CUDA device")
    n = max(GROWTH_LENGTHS)
    gop, (model, frames, masks, dpb) = build(seed, device, n, packed=True)
    card = card_line(device)
    out = {"card": card, "lengths": []}
    # 1. by GOP length: the host's queueing and the synchronised total
    for k in GROWTH_LENGTHS:
        f, m = frames[:k], masks[:k]
        float(gop(model, f, m, 32, dpb)[0])
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gop(model, f, m, GROWTH_QP + rep, dpb)
            t1 = time.perf_counter()
            float(res[0])
            t2 = time.perf_counter()
            row = dict(frames=k, queue_ms=(t1 - t0) / k * 1e3,
                       total_ms=(t2 - t0) / k * 1e3)
            out["lengths"].append(row)
            print(f"{k} frames, GOP {rep}: queue {row['queue_ms']:.3f} ms a "
                  f"frame, total {row['total_ms']:.3f} [{card}]", flush=True)
    # 2. frame by frame
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host, dmax, last = [], [], [0.0]

    def timed(t, d):
        ev[t + 1].record()
        now = time.perf_counter()
        host.append((now - last[0]) * 1e3)
        last[0] = now
        dmax.append(d["feature"].abs().amax())

    torch.cuda.synchronize()
    ev[0].record()
    last[0] = time.perf_counter()
    float(gop(model, frames, masks, GROWTH_QP, dpb, each=timed)[0])
    out["device_ms"] = [ev[t].elapsed_time(ev[t + 1]) for t in range(n)]
    out["host_ms"] = host
    out["dpb_feature_max"] = [float(x) for x in dmax]
    print(f"device ms by frame {[round(x, 2) for x in out['device_ms']]}\n"
          f"host ms by frame {[round(x, 2) for x in host]}\nDPB feature max "
          f"|x| by frame {[float(f'{x:.3g}') for x in dmax]} [{card}]",
          flush=True)
    # 3. by kernel, early against late, the clock sampled beside
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    tabs = {}
    try:
        for lo, hi in GROWTH_WINDOWS:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])

            def window(t, d, lo=lo, hi=hi, prof=prof):
                if t in (lo - 1, hi - 1):
                    torch.cuda.synchronize()
                    (prof.start if t == lo - 1 else prof.stop)()

            float(gop(model, frames[:hi], masks[:hi], GROWTH_QP, dpb,
                      each=window)[0])
            tabs[lo] = kernel_table(prof)
    finally:
        smi.terminate()
        samples = smi.communicate()[0].strip().splitlines()
    (a, b), (c, e) = GROWTH_WINDOWS
    early, late = tabs[a], tabs[c]
    per = {a: b - a, c: e - c}
    totals = {k: sum(v[1] for v in tabs[k].values()) / per[k] for k in tabs}
    keys = sorted(set(early) | set(late), key=lambda k: -(
        late.get(k, (0, 0))[1] / per[c] - early.get(k, (0, 0))[1] / per[a]))
    out["kernels"] = [dict(name=k, early_ms=early.get(k, (0, 0))[1] / per[a],
                           late_ms=late.get(k, (0, 0))[1] / per[c])
                      for k in keys[:10]]
    out["device_ms_per_frame"] = {f"{a}-{b - 1}": totals[a],
                                  f"{c}-{e - 1}": totals[c]}
    out["smi_samples"] = samples
    print(f"device ms a frame under the profiler: frames {a}-{b - 1} "
          f"{totals[a]:.3f}, frames {c}-{e - 1} {totals[c]:.3f} [{card}]")
    for k in out["kernels"]:
        print(f"  {k['name'][:80]}: {k['early_ms']:.3f} -> "
              f"{k['late_ms']:.3f} ms a frame")
    print("nvidia-smi (timestamp, SM clock, power, temperature):\n  "
          + "\n  ".join(samples))
    print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    seed = 0
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "--growth" in argv:
        return growth(seed, device)
    trace_dir = argv[0] if argv else f"{ARTIFACTS}/trace_bench"
    from ..utils.profiling import profiled

    gop, (model, frames, masks, dpb0) = build(
        seed, device, int(os.environ.get("SSGVC_FRAMES", 16)),
        packed=os.environ.get("SSGVC_PACKED", "0") == "1")
    out = gop(model, frames, masks, 32, dpb0)
    float(out[0])

    reps = 2
    with profiled(trace_dir) as prof:
        for r in range(reps):
            out = gop(model, frames, masks, 40 + r, dpb0)
            float(out[0])
    files = sorted(glob.glob(os.path.join(
        trace_dir, f"{os.getpid()}.*.pt.trace.json")), key=os.path.getmtime)
    print("trace files:", files[-1:])
    rows = kernel_table(prof)
    if not rows:
        raise RuntimeError("trace_bench: key_averages() shows no device time "
                           "(no card, or the profiler did not trace it)")
    total = sum(ms for _, ms in rows.values())
    n_frames = frames.shape[0]
    print(f"{'kernel':60s} {'count':>7s} {'device ms':>10s} {'share':>7s}")
    for name, (n, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"{name[:60]:60s} {n:7d} {ms:10.3f} {100 * ms / total:6.2f}%")
    busy, window = busy_share(files[-1])
    print(f"device: {total:.3f} ms of kernels and copies over {reps} GOPs of "
          f"{n_frames} ({total / (reps * n_frames):.3f} ms a frame); busy "
          f"{busy:.3f} of the {window:.3f} ms window "
          f"({100 * busy / window:.1f}%, idle {100 * (1 - busy / window):.1f}"
          f"%)")
    return {"kernels": {k: {"count": n, "device_ms": ms}
                        for k, (n, ms) in rows.items()},
            "device_ms": total, "device_ms_per_frame":
            total / (reps * n_frames), "busy_ms": busy, "window_ms": window,
            "busy_share": busy / window, "trace": files[-1],
            "n_frames": n_frames, "reps": reps}


if __name__ == "__main__":
    main()
