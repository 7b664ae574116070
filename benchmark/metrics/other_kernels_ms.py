"""Device milliseconds a frame of every kernel but the DepthConvBlock
kernels: cuDNN and cuBLAS convs, elementwise and entropy math, from the
trace. Moves ``fps``."""

import re

KERNEL = re.compile(r"\b(dcb_kernel|chain_kernel)\b")


def read(run):
    if run.trace is None or not run.traced_frames \
            or not run.trace.kernels():
        return None
    s = sum(dur for name, _, dur, _ in run.trace.kernels()
            if not KERNEL.search(name))
    return 1e3 * s / run.traced_frames
