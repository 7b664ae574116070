"""The DepthConvBlock kernels' share of their roofline: the least time of
all the frame's DepthConvBlock cores (``harness/roofline.dcb_bound_s`` at
the configuration's widths: products at the dtype's peak or bytes at the
HBM's, whichever is larger, block by block, as the benchmark's own count
finds them), over the device time a frame of the kernels that compute
them, ``dcb_kernel`` and ``chain_kernel``. Moves ``fps``."""

import re

KERNEL = re.compile(r"\b(dcb_kernel|chain_kernel)\b")


def read(run):
    if run.trace is None or not run.traced_frames or not run.dcb_blocks:
        return None
    device_s = sum(dur for name, _, dur, _ in run.trace.kernels()
                   if KERNEL.search(name))
    if device_s <= 0:
        return None
    return 100.0 * run.dcb_bound_s * run.traced_frames / device_s
