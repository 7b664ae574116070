"""The trace's arithmetic and the per-layer readers on a hand-made
trace: busy and idle time, the gaps' labels, the DepthConvBlock roofline,
the other kernels' time, the whole step's MFU, the launches."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import spec, trace

BENCH = spec.load_spec()


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


#: two frames, in microseconds: host spans and launches on thread 1, the
#: device's kernels on stream 7
EVENTS = [
    ev("bench.step", "user_annotation", 0, 40),
    ev("aten::linear", "cpu_op", 2, 10),
    ev("cudaLaunchKernel", "cuda_runtime", 3, 5),
    ev("bench.step", "user_annotation", 50, 40),
    ev("cudaLaunchKernel", "cuda_runtime", 55, 5),
    ev("bench.read", "user_annotation", 95, 100),
    ev("cudaStreamSynchronize", "cuda_runtime", 96, 98),
    ev("void dcb_kernel<256>(bf16 const*)", "kernel", 10, 30, tid=7),
    ev("void chain_kernel<256>(bf16 const*)", "kernel", 40, 20, tid=7),
    ev("sm90_xmma_gemm_bf16", "kernel", 70, 10, tid=7),
    ev("Memcpy DtoH", "gpu_memcpy", 190, 2, tid=7),
]


def test_parse_busy_and_gaps():
    tr = trace.parse(EVENTS)
    assert tr.span_s == pytest.approx(195e-6)
    assert tr.busy_s == pytest.approx(62e-6)
    gaps = dict()
    for name, s in tr.gaps:
        gaps[name] = gaps.get(name, 0) + s
    assert sum(gaps.values()) == pytest.approx(195e-6 - 62e-6)
    # 0-10: a launch inside the first step (the innermost event); 60-70:
    # the second step's host between ops; 80-190 and 192-195: the read's
    # synchronisation
    assert gaps["bench.step / cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["bench.step"] == pytest.approx(10e-6)
    assert gaps["bench.read / cudaStreamSynchronize"] == pytest.approx(
        113e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["void dcb_kernel<256>(bf16 const*)",
                                  pytest.approx(30e-6)]
    assert b["idle_gaps"][0][0] == "bench.read / cudaStreamSynchronize"


def info(tr, mode="bulk"):
    return SimpleNamespace(
        mode=mode, trace=tr, traced_frames=2, frames=100, seconds=2.0,
        latency_ms=[10.0 + i / 10 for i in range(100)],
        host_ms=[8.0, 10.0], products=928_285_908_480,
        dcb_blocks=[(32640, 256)], dcb_bound_s=20e-6, peak_flops=989e12)


def test_readers():
    tr = trace.parse(EVENTS)
    read = lambda name, run: spec.reader(name).read(run)
    bulk, live = info(tr), info(tr, "live")
    # 2 frames x 20 us of bound over 50 us of dcb kernels
    assert read("dcb_roofline", bulk) == pytest.approx(80.0)
    assert read("other_kernels_ms", bulk) == pytest.approx(5e-3)
    assert read("mfu_pct", bulk) == pytest.approx(
        100 * 928_285_908_480 * 50 / 989e12)
    idle = 100 * (1 - 62 / 195)
    assert read("idle_pct.bulk", bulk) == pytest.approx(idle)
    assert read("idle_pct.live", bulk) is None
    assert read("idle_pct.live", live) == pytest.approx(idle)
    assert read("launches_per_frame.live", live) == pytest.approx(1.5)
    assert read("host_ms_per_frame.live", live) == pytest.approx(9.0)
    assert read("host_ms_per_frame.live", bulk) is None
    # the 95th percentile of 10.0, 10.1, ... 19.9 (statistics' method)
    assert read("frame_ms_p95.live", live) == pytest.approx(19.495)
    assert read("frame_ms_p95.live", bulk) is None


def test_readers_find_nothing_on_a_trace_without_the_device():
    tr = trace.parse([e for e in EVENTS if e["tid"] == 1])
    run = info(tr)
    for name in ("dcb_roofline", "other_kernels_ms", "idle_pct.bulk"):
        assert spec.reader(name).read(run) is None
