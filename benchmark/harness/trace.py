"""The traced stretch: ``torch.profiler`` over a few steady steps inside
the window, its Chrome trace written under ``TMPDIR``, read back and
deleted.

From the trace: each device operation (kernels, copies, sets) with its
name and interval; device time by kernel name (the method of the port's
``experiments/trace_bench.kernel_table``); the busy time as the union of
the device intervals over the span from the trace's first event to its
last (``trace_bench.busy_share``); and each idle gap between device
operations named by what the host was doing at its middle: the innermost
host event (an op, a runtime call or one of the harness's
``record_function`` spans) on the thread that queued the work, under the
harness span that holds it.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the harness's own spans (``record_function``) start with this
SPAN_PREFIX = "bench."


@dataclass
class Trace:
    """What a traced stretch read: ``ops`` (name, start s, duration s, cat)
    of every device operation; ``busy_s`` and ``span_s``; ``gaps`` (label,
    seconds) of every idle gap between device operations."""
    ops: List[Tuple[str, float, float, str]] = field(default_factory=list)
    busy_s: float = 0.0
    span_s: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernels(self) -> List[Tuple[str, float, float, str]]:
        return [o for o in self.ops if o[3] == "kernel"]

    def table(self, cats=("kernel",)) -> Dict[str, Tuple[int, float]]:
        """{name: (count, device seconds)} over the operations of ``cats``."""
        rows: Dict[str, Tuple[int, float]] = {}
        for name, _, dur, cat in self.ops:
            if cat in cats:
                n, s = rows.get(name, (0, 0.0))
                rows[name] = (n + 1, s + dur)
        return rows


def parse(events: List[dict]) -> Trace:
    """A :class:`Trace` of a Chrome trace's complete events."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise RuntimeError("the profiler's trace holds no event")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    tr = Trace(span_s=(t1 - t0) / 1e6)
    tr.ops = [(e.get("name", "?"), e["ts"] / 1e6, e["dur"] / 1e6, e["cat"])
              for e in dev]
    # the union of device intervals, and the gaps between them
    busy, gaps, end = 0.0, [], None
    for e in dev:
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    if dev:
        # the span's edges are idle too
        gaps = [(t0, dev[0]["ts"])] + gaps + [(end, t1)]
    tr.busy_s = busy / 1e6
    tr.gaps = _label([g for g in gaps if g[1] > g[0]], events)
    return tr


def _label(gaps: List[Tuple[float, float]], events: List[dict]
           ) -> List[Tuple[str, float]]:
    """Each gap (start, end in us) as (what the host was doing at its
    middle, seconds)."""
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not host or not gaps:
        return [("host: no event", (b - a) / 1e6) for a, b in gaps]
    # the thread that queued the work: the one with the most runtime calls
    per_tid = defaultdict(int)
    for e in host:
        if e.get("cat") == "cuda_runtime":
            per_tid[e.get("tid")] += 1
    tid = max(per_tid, key=per_tid.get) if per_tid else host[0].get("tid")
    host = sorted((e for e in host if e.get("tid") == tid),
                  key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    # one sweep: the events of one thread nest, so those holding a point
    # are a stack, innermost on top
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        holding = [e for e in stack if e["ts"] + e["dur"] >= mid]
        inner = holding[-1]["name"] if holding else None
        span = next((e["name"] for e in reversed(holding)
                     if e["name"].startswith(SPAN_PREFIX)), None)
        name = inner or "host: between ops"
        if span and span != name:
            name = f"{span} / {name}"
        out.append((name, (b - a) / 1e6))
    return out


class Profiled:
    """``torch.profiler`` on the host and the device between :meth:`start`
    and :meth:`stop`; :meth:`read` writes the trace, reads it back as a
    :class:`Trace` and deletes it, after the window."""

    def start(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        del self.prof
        return parse(events)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, ``top`` of each, in seconds."""
    ops = sorted(tr.table(DEVICE_CATS).items(), key=lambda kv: -kv[1][1])
    idle: Dict[str, float] = defaultdict(float)
    for name, s in tr.gaps:
        idle[name] += s
    return {"device_ops": [[n[:160], s] for n, (_, s) in ops[:top]],
            "idle_gaps": [[n[:160], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
