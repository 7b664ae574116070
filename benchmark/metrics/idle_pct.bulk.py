"""The device's idle share over the traced group of a bulk cell: one
minus the union of the device's operations over the trace's span. Moves
``fps``."""


def read(run):
    if (run.mode != "bulk" or run.trace is None or not run.trace.ops
            or run.trace.span_s <= 0):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
