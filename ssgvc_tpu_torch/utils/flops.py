"""Products of a call, counted from shapes: the port's counterpart of XLA's
``cost_analysis`` as the JAX package's measuring scripts use it
(``experiments/profile_stages.py:34-44``, the "939 GFLOP/frame" of
``experiments/bench_sweep.py:96``).

It counts products only, as 2 x multiply-adds:

  * each ``F.linear`` (the port's 1x1 convs and adaptors), ``F.conv2d``
    (strided, 3x3 and depthwise convs) and ``F.conv_transpose2d`` from its
    operands' shapes;
  * each DepthConvBlock core and each chain of them, whether it runs on a
    kernel or on its plain version, as :func:`dcb_flops`: ``16 C^2 + 18 C``
    a pixel (the 1x1s C->C twice, C->4C and 2C->C, and the depthwise 3x3).
    A block's adaptor is a product of its own, counted where it runs; its
    shortcut is an addition.

XLA's ``cost_analysis`` also counts elementwise work (the activations, the
rate's erf, the quantisers), which is why the JAX script's 939 GFLOP a
1088x1920 performance P-frame is above the 928.29 GFLOP that this module
and the JAX package's own jaxpr (2 x multiply-adds over every
``conv_general_dilated`` and ``dot_general``) both count.

:func:`count_products` runs the call on whatever device its tensors are
on. On the ``meta`` device (a model built with ``device="meta"``, meta
inputs) nothing is computed and no kernel runs, so a 1080p frame counts in
seconds on any host: the blocks are counted and their outputs stood in
for, as a block keeps its input's shape.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

#: the H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, at
#: 700 W): the measuring scripts' TFLOP/s are shares of it
H100_BF16_FLOPS = 989e12

#: the forms a product takes in the port outside the DepthConvBlock cores
_FUNCS = (F.linear, F.conv2d, F.conv_transpose2d)


def dcb_flops(pixels: int, c: int, n: int = 1) -> int:
    """Products of ``n`` DepthConvBlock cores of width ``c`` over ``pixels``
    pixels (batch x H x W): ``16 c^2 + 18 c`` a pixel and block."""
    return n * pixels * (16 * c * c + 18 * c)


def linear_flops(x_shape: Sequence[int], w_shape: Sequence[int]) -> int:
    """``F.linear(x, w)``: 2 x rows x out x in."""
    return 2 * math.prod(x_shape[:-1]) * w_shape[0] * w_shape[1]


def conv_flops(out_shape: Sequence[int], w_shape: Sequence[int]) -> int:
    """``F.conv2d`` to an output of ``out_shape`` (N, O, H, W) with a
    weight (O, I / groups, kh, kw): 2 x outputs x (I / groups) x kh x kw."""
    return 2 * math.prod(out_shape) * math.prod(w_shape[1:])


def conv_transpose_flops(x_shape: Sequence[int],
                         w_shape: Sequence[int]) -> int:
    """``F.conv_transpose2d`` of an input (N, I, H, W) with a weight (I,
    O / groups, kh, kw): every input element meets O / groups x kh x kw
    taps."""
    return 2 * math.prod(x_shape) * math.prod(w_shape[1:])


@dataclass
class ProductCount:
    """FLOP (2 x multiply-adds) counted so far."""
    total: int = 0


class _Counter(TorchFunctionMode):
    def __init__(self, count: ProductCount):
        super().__init__()
        self.count = count
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _FUNCS and not self.paused:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            if func is F.linear:
                self.count.total += linear_flops(args[0].shape, w.shape)
            elif func is F.conv2d:
                self.count.total += conv_flops(out.shape, w.shape)
            else:
                self.count.total += conv_transpose_flops(args[0].shape,
                                                         w.shape)
        return out


@contextlib.contextmanager
def count_products() -> Iterator[ProductCount]:
    """Count the products of the calls made inside the block; yields the
    :class:`ProductCount` it fills. The DepthConvBlock cores
    (``layers.blocks``' calls of ``ops.dcb_grad.dcb_grad`` and
    ``dcb_chain_grad``) count as :func:`dcb_flops`; on the meta device
    their outputs are stood in for, elsewhere they run as they would."""
    from ..layers import blocks

    count = ProductCount()
    mode = _Counter(count)
    one, chain = blocks.dcb_grad, blocks.dcb_chain_grad

    def run(fn, x, *args, **kwargs):
        if x.device.type == "meta":
            return torch.empty_like(x)
        mode.paused = True
        try:
            return fn(x, *args, **kwargs)
        finally:
            mode.paused = False

    def dcb_counted(x, params, *args, **kwargs):
        b, h, w, c = x.shape
        count.total += dcb_flops(b * h * w, c)
        return run(one, x, params, *args, **kwargs)

    def chain_counted(x, params, *args, **kwargs):
        b, h, w, c = x.shape
        count.total += dcb_flops(b * h * w, c, len(params))
        return run(chain, x, params, *args, **kwargs)

    blocks.dcb_grad, blocks.dcb_chain_grad = dcb_counted, chain_counted
    try:
        with mode, torch.no_grad():
            yield count
    finally:
        blocks.dcb_grad, blocks.dcb_chain_grad = one, chain

