"""Device kernels a live frame: the kernels in the profiler's trace over
the traced frames. Moves ``frame_ms_mean``: each launch costs the host
time to queue. The profiler can miss a launch or two of a stretch."""


def read(run):
    if (run.mode != "live" or run.trace is None or not run.traced_frames
            or not run.trace.kernels()):
        return None
    return len(run.trace.kernels()) / run.traced_frames
