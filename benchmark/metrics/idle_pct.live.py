"""The device's idle share over the traced GOP of a live cell: one minus
the union of the device's operations over the trace's span. Moves
``frame_ms_mean``."""


def read(run):
    if (run.mode != "live" or run.trace is None or not run.trace.ops
            or run.trace.span_s <= 0):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
