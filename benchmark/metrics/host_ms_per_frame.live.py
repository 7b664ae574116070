"""Host milliseconds a live frame: the benchmark's host clock around each
call into the model (the copy in, conversion, ingest and forward queued),
before the read that syncs it, averaged over the window's untraced
frames. Moves ``frame_ms_mean``: the host's queueing is on the live
frame's critical path."""


def read(run):
    if run.mode != "live" or not run.host_ms:
        return None
    return sum(run.host_ms) / len(run.host_ms)
