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
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Dict, List, Tuple

import torch

from . import ARTIFACTS, split_device

#: the port's kernels by their CUDA names, as the launch counters name them
PORT_KERNELS = {"dcb_kernel": "dcb", "chain_kernel": "dcb_chain"}
_PORT_RE = re.compile(r"\b(dcb_kernel|chain_kernel)\b")
#: the trace's device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def build(seed: int = 0, device="cuda", n_frames: int = 16, b: int = 1,
          h: int = 1088, w: int = 1920):
    """(gop, (model, frames, masks, dpb0, packed)): ``bench_sweep``'s GOP
    on the performance variant in bf16, weights and inputs from
    ``seed``."""
    from ..config import DMCConfig
    from ..models.dmc import DMC
    from .bench_sweep import make_gop_inputs, run_gop

    packed = os.environ.get("SSGVC_PACKED", "0") == "1"
    n_frames = int(os.environ.get("SSGVC_FRAMES", n_frames))
    cfg = DMCConfig.variant("performance", dtype="bfloat16",
                            packed_io=packed)
    model = DMC(cfg, device=device).init_(
        torch.Generator().manual_seed(seed + 4)).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    frames, masks, dpb0 = make_gop_inputs(cfg, b, h, w, n_frames, g, device)
    return run_gop, (model, frames, masks, dpb0, packed)


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


def main(argv=None) -> dict:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    seed = 0
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    trace_dir = argv[0] if argv else f"{ARTIFACTS}/trace_bench"
    from ..utils.profiling import profiled

    gop, (model, frames, masks, dpb0, packed) = build(seed, device)
    out = gop(model, frames, masks, 32, dpb0, packed)
    float(out[0])

    reps = 2
    with profiled(trace_dir) as prof:
        for r in range(reps):
            out = gop(model, frames, masks, 40 + r, dpb0, packed)
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
