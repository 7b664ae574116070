"""Products of a frame, counted from shapes on the meta device over the
benchmark's own reference model.

Every product of the reference is an ``F.linear`` or an ``F.conv2d``;
each counts 2 x multiply-adds from its operands' shapes. Each
DepthConvBlock core has exactly one depthwise 3x3 conv (``groups`` equal
to its channels), so that conv marks a block: its output's pixels and
width are the block's, and its work is ``roofline.dcb_flops``. Nothing is
computed on the meta device, so a 1080p frame counts in a second on any
host.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


class Count(TorchFunctionMode):
    """``total`` products, and ``blocks``: (pixels, C) of each
    DepthConvBlock core met."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.blocks: List[Tuple[int, int]] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.linear:
            w = args[1]
            self.total += 2 * math.prod(args[0].shape[:-1]) * w.shape[0] \
                * w.shape[1]
        elif func is F.conv2d:
            w = args[1]
            self.total += 2 * out.numel() * math.prod(w.shape[1:])
            groups = args[6] if len(args) > 6 else kwargs.get("groups", 1)
            c = out.shape[1]
            if groups == c and c > 1 and tuple(w.shape[1:]) == (1, 3, 3):
                n, _, h, wd = out.shape
                self.blocks.append((n * h * wd, c))
        return out


def count(fn: Callable[[], object]) -> Count:
    """Run ``fn`` (a reference forward on meta tensors) under a
    :class:`Count`."""
    c = Count()
    with c, torch.no_grad():
        fn()
    return c
