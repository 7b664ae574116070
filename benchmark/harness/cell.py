"""One run of one cell: set-up, the window, the comparison, the metrics.

:func:`run` returns the result line's parts; ``run.py`` prints them. It
takes ``device="cpu"`` (and configurations and mixes given as dicts) for
the benchmark's own tests; the command refuses to measure without a card.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from . import roofline, spec, trace, window


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(device) -> str:
    """The card's name, power limit and SM clocks by ``nvidia-smi``."""
    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def reference_readings(codec, w: window.Window) -> dict:
    """The reference over the kept group, in fp32 with TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return codec.reference(w.kept, w.kept_qp)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def checks(per: dict, limits: dict, failed: int) -> dict:
    """Each compared number (the worst frame's) beside its limit."""
    out = {"failed_frames": {"value": failed, "limit": 0}}
    for name, limit in limits.items():
        out[name] = {"value": max(per[name], key=lambda v: (v != v, v)),
                     "limit": limit}
    return out


def passes(c: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in c.values())


def setup_parts(t_start: float, marks: list, build_parts: dict) -> dict:
    """Set-up's seconds by part, in order: from the process's start to the
    run (``start``: the interpreter, torch), the codec's build as its
    adapter splits it (the port's ``imports``; ``kernels``, compiled on a
    first run and loaded after, apart from the rest; the ``model`` on the
    device; its ``weights`` from the seed), the inputs, the warm-up, the
    collector."""
    out, prev = {}, t_start
    for name, t in marks:
        if name == "build" and build_parts:
            out.update(build_parts)
            out["build_other"] = t - prev - sum(build_parts.values())
        else:
            out[name] = t - prev
        prev = t
    return out


def end_to_end(w: window.Window, setup_s: float) -> dict:
    """The values of every end-to-end metric the window can give."""
    return {"setup_s": setup_s, "fps": w.frames / w.seconds,
            "frame_ms_mean": 1e3 * w.seconds / w.frames}


def layer_info(codec, config: dict, traffic: dict, w: window.Window,
               tr: trace.Trace) -> SimpleNamespace:
    """What a per-layer metric's reader gets: the traced stretch, the
    window's untraced frames and seconds, the latencies and the host's
    queueing times of the untraced frames, and the yardstick's products
    and DepthConvBlock bound of one frame."""
    c = codec.count()
    dtype = config["model"]["dtype"]
    return SimpleNamespace(
        mode=traffic["mode"], trace=tr, traced_frames=w.traced_frames,
        frames=w.frames - w.traced_frames,
        seconds=w.seconds - w.traced_s,
        latency_ms=[x for x, t in zip(w.latency_ms, w.traced) if not t],
        host_ms=[h for h, t in zip(w.host_ms, w.traced) if not t],
        products=c.total, dcb_blocks=c.blocks,
        dcb_bound_s=sum(roofline.dcb_bound_s(p, ch, dtype)
                        for p, ch in c.blocks),
        peak_flops=roofline.PEAK_FLOPS[dtype])


def run(workload: str, seed: int, seconds: float, trace_on: bool, *,
        t_start: float, device="cuda", control: Optional[str] = None,
        bench: Optional[dict] = None, config: Optional[dict] = None,
        traffic: Optional[dict] = None,
        wrap: Optional[Callable] = None) -> dict:
    """One run. ``t_start`` is the process's start on the
    ``time.perf_counter`` clock. ``wrap`` (a fault of
    ``benchmark/faults.py``, in the tests and ``readings.py --fault``) gets
    the codec adapter once its model and inputs are made, before the
    warm-up, and may replace its methods."""
    bench = bench or spec.load_spec()
    cell = spec.cell(bench, workload)
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    marks = [("start", time.perf_counter())]
    codec = spec.codec(config["codec"]).Codec(config, traffic, seed, device,
                                              control)
    codec.build()
    marks.append(("build", time.perf_counter()))
    codec.make_inputs()
    marks.append(("inputs", time.perf_counter()))
    if wrap is not None:
        wrap(codec)
    qp_stream = window.qps(seed, traffic)
    window.warm_up(codec, traffic, next(qp_stream), trace_on)
    if codec.device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm_up", time.perf_counter()))
    # what set-up made stays out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    marks.append(("gc", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = setup_parts(t_start, marks, getattr(codec, "build_parts", {}))
    log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in parts.items()))

    w = window.measure(codec, traffic, seed, seconds, trace_on, qp_stream)

    cuda = codec.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(codec.device) if cuda else 0
    print(f"card: {card_line(codec.device)}; memory_peak_bytes {peak} "
          f"(max_memory_allocated); {w.frames} frames in {w.seconds:.3f} s; "
          f"set-up {setup_s:.3f} s", flush=True)
    tr = w.profiled.read() if w.profiled is not None else None
    codec.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per = reference_readings(codec, w)
    reference_s = time.perf_counter() - t_ref
    log(f"reference: {reference_s:.3f} s over {len(w.kept)} steps of "
        f"{codec.streams}")
    for name, values in per.items():
        log(f"  {name} by step: " + " ".join(f"{v:.4g}" for v in values))
    result = {"checks": checks(per, config["limits"], w.failed),
              "attempted": w.frames, "failed": w.failed,
              "peak": peak, "window": w, "per": per, "setup_s": setup_s,
              "setup_parts": parts, "reference_s": reference_s}
    result["correct"] = passes(result["checks"])
    if trace_on:
        info = layer_info(codec, config, traffic, w, tr)
        layer = {}
        for m in spec.per_layer(bench, workload):
            v = spec.reader(m["name"]).read(info)
            if v is not None:
                layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result.update(metrics=layer, busy_s=tr.busy_s, window_s=tr.span_s,
                      breakdown=trace.breakdown(tr))
    else:
        values = end_to_end(w, setup_s)
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.end_to_end(bench, workload)}
    return result

