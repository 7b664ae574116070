"""The measured window, generic over a codec adapter and a traffic mix.

A group is ``codec.group`` steps of ``codec.streams`` frames from the
state ``codec.start()`` gives, at one QP drawn from the seed (uniform in
the mix's ``qp`` range). Two modes:

  * ``bulk``: a whole group is queued, then synced once by reading its
    bpp values on the host; the window ends at the sync that closes the
    first group to end past ``seconds``.
  * ``live``: one frame at a time, closed loop: each step is queued, its
    bpp read on the host, and only then is the next one submitted. Each
    frame's latency runs from its submission to that read; its host time
    from its submission to the end of its queueing.

One group, drawn from the seed among the first ``sample_from``, keeps its
outputs for the comparison (the window runs at least until it is done).
With ``trace`` the profiler records one whole group that starts past
``trace_at`` of the window; that group is left out of the rates that the
per-layer metrics read.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.profiler import record_function

from . import spec
from .trace import Profiled


@dataclass
class Window:
    seconds: float = 0.0
    frames: int = 0
    failed: int = 0
    latency_ms: List[float] = field(default_factory=list)
    host_ms: List[float] = field(default_factory=list)
    traced: List[bool] = field(default_factory=list)
    kept: Optional[list] = None
    kept_qp: int = 0
    profiled: Optional[Profiled] = None
    traced_frames: int = 0
    traced_s: float = 0.0


def qps(seed: int, traffic: dict):
    """The QP of each group, in order, from the seed."""
    rng = random.Random(spec.sub_seed(seed, "qp"))
    lo, hi = traffic["qp"]["lo"], traffic["qp"]["hi"]
    while True:
        yield rng.randint(lo, hi)


def _bad(values) -> int:
    return sum(1 for v in values if not math.isfinite(v))


def run_group(codec, qp: int, live: bool, w: Optional[Window] = None,
              keep: bool = False, traced: bool = False):
    """Queue one group and sync it as the mode says; returns the kept
    outputs (``keep``). Timings and failures go to ``w``."""
    with record_function("bench.start"):
        state = codec.start()
    kept, bpps = [], []
    for t in range(codec.group):
        s0 = time.perf_counter()
        with record_function("bench.step"):
            out, state = codec.step(t, state, qp)
        if keep:
            kept.append(codec.keep(out))
        if live:
            s1 = time.perf_counter()
            with record_function("bench.read"):
                vals = codec.bpp(out).tolist()
            s2 = time.perf_counter()
            if w is not None:
                w.host_ms.append((s1 - s0) * 1e3)
                w.latency_ms.append((s2 - s0) * 1e3)
                w.traced.append(traced)
                w.failed += _bad(vals)
        else:
            bpps.append(codec.bpp(out))
        del out
    if not live:
        with record_function("bench.read"):
            vals = torch.stack(bpps).flatten().tolist()
        if w is not None:
            w.failed += _bad(vals)
    return kept


def warm_up(codec, traffic: dict, qp: int, trace: bool) -> None:
    """Every shape of the window once (and, for a traced run, the
    profiler started and stopped once, so that its start-up stays out of
    the window)."""
    live = traffic["mode"] == "live"
    for _ in range(traffic["warmup_groups"]):
        run_group(codec, qp, live)
    if trace:
        p = Profiled().start()
        run_group(codec, qp, live)
        p.stop()
        p.read()


def measure(codec, traffic: dict, seed: int, seconds: float, trace: bool,
            qp_stream) -> Window:
    """The window (module docstring)."""
    live = traffic["mode"] == "live"
    if traffic["mode"] not in ("bulk", "live"):
        raise ValueError(f"mode {traffic['mode']!r}: want bulk or live")
    sample = spec.draws(seed, "sample", 1, 0, traffic["sample_from"] - 1)[0]
    w = Window()
    g = 0
    t0 = time.perf_counter()
    while True:
        qp = next(qp_stream)
        keep = g == sample
        tracing = (trace and w.profiled is None and not keep
                   and time.perf_counter() - t0 >= seconds
                   * traffic["trace_at"])
        tg = time.perf_counter()
        prof = Profiled().start() if tracing else None
        kept = run_group(codec, qp, live, w, keep, tracing)
        end = time.perf_counter()
        if prof is not None:
            prof.stop()
            w.profiled = prof
            w.traced_frames = codec.group * codec.streams
            w.traced_s = time.perf_counter() - tg
        if keep:
            w.kept, w.kept_qp = kept, qp
        w.frames += codec.group * codec.streams
        g += 1
        if (end - t0 >= seconds and w.kept is not None
                and (not trace or w.profiled is not None)):
            w.seconds = end - t0
            return w
