"""The live frame's latency tail: the 95th percentile of the untraced
frames' latencies in the traced run, each from its submission to its bpp
read on the host. A per-layer metric and not an end-to-end one: its
quartile spread over a set of runs (13-16%, PERF.md) is more than a
bound of at most 0.25 can hold. Moves ``frame_ms_mean``."""

import statistics


def read(run):
    if run.mode != "live" or len(run.latency_ms) < 20:
        return None
    return statistics.quantiles(run.latency_ms, n=20)[18]
