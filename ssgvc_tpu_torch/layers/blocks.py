"""The codec's building blocks as ``nn.Module``s on NHWC tensors.

Parameters keep PyTorch's layouts (conv ``weight`` (O, I/groups, kh, kw),
``bias`` (O,)) under the attribute names of the JAX package's flax modules
(``dc_0``, ``ffn_2``, ``adaptor``, ``conv2_0`` ...), so ``state_dict`` keys
read like ``encoder.conv2_0.dc_0.weight``. Parameters are fp32; each module
computes in its ``dtype``. Every DepthConvBlock core runs through
``ops.dcb`` / ``ops.dcb_chain`` inside the autograd Functions of
``ops.dcb_grad``: the hand-written kernels for a CUDA tensor, forward and
backward, their plain versions for a CPU tensor.

:func:`init_` draws fresh weights as the JAX package's flax modules do
(lecun-normal kernels, zero biases, zero residual tails).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcb import pack_kernel, wsilu
from ..ops.dcb_chain import pack_chain
from ..ops.dcb_grad import dcb_chain_grad, dcb_grad
from ..ops.pixel import patch_down_conv, patch_up_conv, pixel_shuffle
from ..parallel import spatial

__all__ = ["wsilu", "wsilu_chunk_add", "Conv", "PatchDownConv",
           "PatchUpConv", "Concat1x1", "DepthConvBlock", "run_chain",
           "SubpelConv2x", "ResidualBlockWithStride2",
           "ResidualBlockUpsample", "lecun_normal_", "init_"]


def wsilu_chunk_add(x: torch.Tensor) -> torch.Tensor:
    """wsilu, then the two channel halves added."""
    x = wsilu(x)
    x1, x2 = x.chunk(2, dim=-1)
    return x1 + x2


def _param(shape, device) -> nn.Parameter:
    # zeros until init_ draws them or weights are loaded (utils/weights.py)
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


#: flax's lecun_normal draws a normal truncated at +-2 and divides by that
#: distribution's standard deviation, so the kept values have std sqrt(1 /
#: fan_in).
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` into a conv weight (O, I/groups, kh, kw): a
    normal truncated at 2 sigma, sigma = sqrt(1 / fan_in) / TRUNC_STD,
    fan_in = I/groups * kh * kw. Drawn on the CPU from ``generator``, so a
    seed gives the same weights on every device."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w)


def init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights for every conv of ``module``, in place, as the flax
    modules init them: lecun_normal kernels (zeros where the conv was built
    with ``zero_init``: the DepthConvBlock residual tails dc_3 and ffn_2, the
    recon_residual heads), zero biases. Other parameters (per-QP tables,
    entropy parameters) are the models' own (``DMC.init_``)."""
    for m in module.modules():
        if isinstance(m, (Conv, PatchDownConv, PatchUpConv, Concat1x1)):
            if m.zero_init:
                with torch.no_grad():
                    m.weight.zero_()
            else:
                lecun_normal_(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
    return module


@contextlib.contextmanager
def cudnn_fp32(dtype: torch.dtype, device: torch.device):
    """cuDNN without TF32 for the duration of a float32 conv on the card:
    ``torch.backends.cudnn.allow_tf32`` defaults to True, which would round
    an fp32 model's strided and 3x3 convs to TF32 (about three digits). The
    flag is restored on exit; bf16 and CPU convs leave it alone. (The 1x1
    convs run as ``F.linear``, whose fp32 default is full fp32.)"""
    if dtype != torch.float32 or device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Conv(nn.Module):
    """A conv on NHWC tensors; 1x1 stride-1 convs run as a matmul, the rest
    through cuDNN (in full fp32 for an fp32 module, :func:`cudnn_fp32`).
    Under a row shard (``parallel/spatial.py``) a kernel > 1 takes its
    padding's rows above and the rows its window reaches below the slab
    from the neighbour slabs (zeros at the image's edges) and pads only
    W."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1, *,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.weight = _param((out_ch, in_ch // groups, kernel_size,
                              kernel_size), device)
        self.bias = _param((out_ch,), device)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype, self.zero_init = dtype, zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        w, b = self.weight.to(dt), self.bias.to(dt)
        if w.shape[-1] == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, w[:, :, 0, 0], b)
        k, s, p = w.shape[-1], self.stride, self.padding
        x, up, _ = spatial.halo(x, p, max(0, k - s - p), zero_edges=True)
        # a halo brings H's padding rows with it: conv2d pads W alone then
        pad = (p - up, p)
        with cudnn_fp32(dt, x.device):
            y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, pad,
                         groups=self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class PatchDownConv(nn.Module):
    """pixel_unshuffle(r) + 1x1 conv; weight (O, C*r*r, 1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, r: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.weight = _param((out_ch, in_ch * r * r, 1, 1), device)
        self.bias = _param((out_ch,), device)
        self.r, self.dtype, self.zero_init = r, dtype, False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_down_conv(x.to(self.dtype), self.weight, self.bias,
                               self.r)


class PatchUpConv(nn.Module):
    """1x1 conv + pixel_shuffle(r); weight (C*r*r, I, 1, 1); ``out_ch`` is
    the channel count after the shuffle."""

    def __init__(self, in_ch: int, out_ch: int, r: int, *,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.weight = _param((out_ch * r * r, in_ch, 1, 1), device)
        self.bias = _param((out_ch * r * r,), device)
        self.r, self.dtype, self.zero_init = r, dtype, zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_up_conv(x.to(self.dtype), self.weight, self.bias, self.r)


class Concat1x1(nn.Module):
    """1x1 conv over an implicit channel concat of ``parts``, in tuple
    order: one weight (O, sum_ch, 1, 1), one matmul per part, the concat
    never materialized."""

    def __init__(self, in_chs: Sequence[int], out_ch: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.weight = _param((out_ch, sum(in_chs), 1, 1), device)
        self.bias = _param((out_ch,), device)
        self.dtype, self.zero_init = dtype, False

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        w = self.weight[:, :, 0, 0].to(dt)
        out = None
        off = 0
        for p in parts:
            term = F.linear(p.to(dt), w[:, off:off + p.shape[-1]])
            out = term if out is None else out + term
            off += p.shape[-1]
        return out + self.bias.to(dt)


InCh = Union[None, int, Tuple[int, ...]]


def _pack_key(x: torch.Tensor, params: Sequence[torch.Tensor]) -> tuple:
    """What a packed-weight cache is valid for: ``x``'s dtype and device and
    each parameter's storage and in-place version."""
    return (x.dtype, x.device,
            tuple((p.data_ptr(), p._version) for p in params))


class DepthConvBlock(nn.Module):
    """x -> [adaptor] -> (dc(x) + x) -> (ffn(.) + .) [+ x] [* quant_step].

    ``in_ch``: None or ``out_ch`` (no adaptor), another int (1x1 adaptor),
    a tuple of part widths (the input is a tuple: a Concat1x1 adaptor, or a
    plain concat when the widths sum to ``out_ch``), or the raw frame's
    channels with ``patch_in`` > 0 (pixel_unshuffle + 1x1 adaptor).
    ``force_adaptor`` keeps the adaptor where the widths alone would drop
    it (a tuple summing to ``out_ch``, or ``out_ch`` itself).
    """

    def __init__(self, out_ch: int, in_ch: InCh = None,
                 shortcut: bool = False, patch_in: int = 0,
                 force_adaptor: bool = False, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        c = out_ch
        kw = dict(dtype=dtype, device=device)
        self.shortcut, self.dtype = shortcut, dtype
        self.tuple_input = isinstance(in_ch, (tuple, list))
        if self.tuple_input and (sum(in_ch) != c or force_adaptor):
            self.adaptor = Concat1x1(in_ch, c, **kw)
        elif patch_in:
            self.adaptor = PatchDownConv(in_ch, c, patch_in, **kw)
        elif not self.tuple_input and (in_ch not in (None, c)
                                       or force_adaptor):
            self.adaptor = Conv(c if in_ch is None else in_ch, c, **kw)
        else:
            self.adaptor = None
        self.dc_0 = Conv(c, c, **kw)
        self.dc_2 = Conv(c, c, 3, padding=1, groups=c, **kw)
        # the residual tails start at zero (flax: ReZero-style), so a fresh
        # stack is the identity
        self.dc_3 = Conv(c, c, zero_init=True, **kw)
        self.ffn_0 = Conv(c, 4 * c, **kw)
        self.ffn_2 = Conv(2 * c, c, zero_init=True, **kw)
        self._packed = None
        self._packed_key = None
        self._chain_packed = None     # set on the first block of a chain
        self._chain_key = None

    def core_params(self) -> Tuple[torch.Tensor, ...]:
        return (self.dc_0.weight, self.dc_0.bias, self.dc_2.weight,
                self.dc_2.bias, self.dc_3.weight, self.dc_3.bias,
                self.ffn_0.weight, self.ffn_0.bias, self.ffn_2.weight,
                self.ffn_2.bias)

    def packed(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The kernel's packed weights for ``x``'s dtype, rebuilt only when a
        parameter changed (in place or by a move); None on the CPU."""
        if x.device.type == "cpu":
            return None
        params = self.core_params()
        key = _pack_key(x, params)
        if key != self._packed_key:
            self._packed = pack_kernel(params, x.dtype)
            self._packed_key = key
        return self._packed

    def adapt(self, x) -> torch.Tensor:
        if self.adaptor is not None:
            x = self.adaptor(x)
        elif self.tuple_input:
            x = torch.cat([p.to(self.dtype) for p in x], dim=-1)
        return x.to(self.dtype).contiguous()

    def forward(self, x, quant_step: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        # under a row shard: the dw3x3's row of each neighbour slab
        x, up, down = spatial.halo(self.adapt(x), 1, 1)
        y = dcb_grad(x, self.core_params(), quant_step, self.shortcut,
                     packed=self.packed(x))
        return spatial.crop(y, up, down)


def run_chain(x: torch.Tensor, blocks: Sequence[DepthConvBlock],
              q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Adaptor-free, shortcut-free blocks back to back through
    ``ops.dcb_chain`` (one kernel launch on the card, with the gradient of
    ``ops.dcb_grad``), ``q_last`` multiplying the last output. Under a row
    shard the chain takes N rows of each neighbour slab and crops N."""
    for b in blocks:
        if b.adaptor is not None or b.shortcut or b.tuple_input:
            raise ValueError("a chain takes adaptor-free, shortcut-free "
                             "blocks")
    x = x.to(blocks[0].dtype).contiguous()
    params = [b.core_params() for b in blocks]
    packed = None
    if x.device.type != "cpu":
        # the chain kernel's packed weights, cached on the chain's first
        # block and rebuilt only when a parameter changed
        head = blocks[0]
        key = _pack_key(x, [p for ps in params for p in ps])
        if key != head._chain_key:
            head._chain_packed = pack_chain(params, x.dtype)
            head._chain_key = key
        packed = head._chain_packed
    x, up, down = spatial.halo(x, len(blocks), len(blocks))
    return spatial.crop(dcb_chain_grad(x, params, q_last, packed=packed), up,
                        down)


class SubpelConv2x(nn.Module):
    """conv -> pixel_shuffle(2)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 padding: int = 0, *, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.conv_0 = Conv(in_ch, out_ch * 4, kernel_size, padding=padding,
                           dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.conv_0(x), 2)


class ResidualBlockWithStride2(nn.Module):
    """2x2 stride-2 conv, then a shortcut DepthConvBlock."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.down = Conv(in_ch, out_ch, 2, stride=2, dtype=dtype,
                         device=device)
        self.conv = DepthConvBlock(out_ch, shortcut=True, dtype=dtype,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.down(x))


class ResidualBlockUpsample(nn.Module):
    """Subpel 2x upsample, then a shortcut DepthConvBlock."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.up = SubpelConv2x(in_ch, out_ch, 1, dtype=dtype, device=device)
        self.conv = DepthConvBlock(out_ch, shortcut=True, dtype=dtype,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.up(x))
