"""Profiling and device statistics: the JAX package's ``utils/profiling.py``
on ``torch.profiler`` and ``torch.cuda``.

  * ``trace``: a context manager around ``torch.profiler.profile`` that
    exports a Chrome trace (``chrome://tracing``, Perfetto) into a
    directory;
  * ``device_memory_stats``: bytes in use, peak and limit per CUDA device;
  * ``timed``: median seconds per call, between synchronised CUDA events
    on the card, by the host clock on the CPU;
  * ``param_summary``: a parameter-count table per subtree, named by flax
    paths;
  * ``AverageMeter``: a running average.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from .debug import named_leaves, tensor_leaves


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "torch_trace")):
    """Profile the block: CPU activity, and CUDA activity where a card is
    present. On exit the trace is written to ``log_dir`` as
    ``<pid>.<time in ns>.pt.trace.json``. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def device_memory_stats() -> Dict[str, Dict]:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for every
    visible CUDA device (the caching allocator's current and peak allocated
    bytes, the device's total memory); one "cpu" entry of Nones on a host
    without CUDA."""
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                        "bytes_limit": None}}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def _on_card(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tensor_leaves(tree))


def timed(fn: Callable, *args, iters: int = 5, fetch=None, **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)`` after one warm-up
    call. With ``fetch`` (``fetch(out) -> scalar``) each call's time
    includes reading that scalar on the host, as in the JAX package. With
    a tensor on the card among the arguments or outputs, each call is
    timed between CUDA events, synchronised before they are read;
    otherwise by the host clock."""
    def sync(out):
        if fetch is not None:
            float(fetch(out))

    out = fn(*args, **kwargs)
    sync(out)
    card = _on_card([args, kwargs, out])
    times = []
    for _ in range(iters):
        if card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            sync(out)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(out)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def param_summary(params, max_depth: int = 2) -> str:
    """ModelSummary-style table: parameter counts per subtree of flax path
    depth ``max_depth``, largest first, then the total."""
    groups: Dict[str, int] = {}
    total = 0
    for path, leaf in named_leaves(params).items():
        n = int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else 1
        total += n
        key = "/".join(path.split("/")[:max_depth])
        groups[key] = groups.get(key, 0) + n
    lines = [f"{'module':<44s} {'params':>12s}"]
    for k, v in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"{k:<44s} {v:>12,d}")
    lines.append(f"{'TOTAL':<44s} {total:>12,d}")
    return "\n".join(lines)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
