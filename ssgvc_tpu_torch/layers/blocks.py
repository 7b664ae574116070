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

The JAX package's opt-in experiments, read from the environment at each
forward (the eager forward is the port's trace, so a changed variable takes
effect without rebuilding a model), all off by default:

  * ``SSGVC_INT8`` = "1" (dynamic per-tensor activation scale) or "2"
    (static calibrated scales, :func:`set_int8_scales`): every ``groups ==
    1`` :class:`Conv` runs the W8A8 int8 conv of ``ops/qconv.py``;
    ``SSGVC_INT8_SCOPE=3x3`` limits that to the 3x3 sites. While the 1x1s
    are quantized (scope "all") a DepthConvBlock and :func:`run_chain` run
    the JAX package's composition of the block, its 1x1s through
    :class:`Conv`, instead of the fused kernels. With grad enabled the
    route carries ``jax.grad``'s gradient of QuantConv; under a row shard
    and a data mesh mode 1's abs-max is the global tensor's.
  * ``SSGVC_DW=shiftadd``: that composition's depthwise 3x3 as nine
    shifted multiply-adds (:func:`dw3x3_shiftadd`).
  * ``SSGVC_FUSE_DOWN`` / ``SSGVC_FUSE_UP``: the patching convs as one
    strided conv (``ops/pixel.py``).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import warnings
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcb import pack_kernel, wsilu
from ..ops.dcb_chain import pack_chain
from ..ops.dcb_grad import dcb_chain_grad, dcb_grad
from ..ops.pixel import patch_down_conv, patch_up_conv, pixel_shuffle
from ..ops.qconv import (dynamic_scale, pack_weight, qconv, qconv_grad,
                         quantize_weight, static_scale)
from ..parallel import spatial

__all__ = ["wsilu", "wsilu_chunk_add", "Conv", "PatchDownConv",
           "PatchUpConv", "Concat1x1", "DepthConvBlock", "run_chain",
           "SubpelConv2x", "ResidualBlockWithStride2",
           "ResidualBlockUpsample", "lecun_normal_", "init_",
           "dw3x3_shiftadd", "set_int8_scales", "save_int8_scales",
           "load_int8_scales", "collect_int8_scales", "int8_calibration",
           "name_int8_sites"]


def wsilu_chunk_add(x: torch.Tensor) -> torch.Tensor:
    """wsilu, then the two channel halves added."""
    x = wsilu(x)
    x1, x2 = x.chunk(2, dim=-1)
    return x1 + x2


def dw3x3_shiftadd(h: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 conv (padding 1) on NHWC ``h`` as 9 shifted
    multiply-adds, in the JAX package's order (``dy``, then ``dx``, then
    the bias): the same function as ``Conv(C, C, 3, padding=1, groups=C)``
    on the same weight (C, 1, 3, 3) and bias (C,), in ``h``'s dtype.

    ``SSGVC_DW=shiftadd`` selects it wherever the port computes the dw3x3
    as an op of its own: the int8 composition of :class:`DepthConvBlock`.
    The fused ``dcb`` kernels have no separate dw op to switch: they sum
    the nine taps inside the tile routine (``csrc/dcb_tile.cuh:344``, the
    "depthwise 3x3 + b2" loop), as the JAX package's Pallas kernels do."""
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    hh, ww = h.shape[1], h.shape[2]
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = hp[:, dy:dy + hh, dx:dx + ww, :] * weight[:, 0, dy, dx]
            acc = t if acc is None else acc + t
    return acc + bias


def _dw_shiftadd() -> bool:
    """``SSGVC_DW``: "shiftadd" (:func:`dw3x3_shiftadd`) or "conv" (the
    grouped conv) for the composition's depthwise 3x3."""
    return os.environ.get("SSGVC_DW", "conv") == "shiftadd"


def _int8_mode() -> str:
    """``SSGVC_INT8``: "0" off, "1" dynamic per-tensor activation scale,
    "2" static per-site scales (:func:`set_int8_scales`). Read at each
    forward."""
    return os.environ.get("SSGVC_INT8", "0")


def int8_site(kernel_size: int, groups: int) -> bool:
    """Whether a conv runs the int8 route now: ``groups == 1``, the mode on,
    and ``SSGVC_INT8_SCOPE=3x3`` (if set) admitting ``kernel_size``."""
    scope_ok = (os.environ.get("SSGVC_INT8_SCOPE", "all") != "3x3"
                or kernel_size == 3)
    return groups == 1 and _int8_mode() != "0" and scope_ok


def _int8_blocks() -> bool:
    """Whether the DepthConvBlocks' 1x1s are int8 sites now, so the blocks
    run the JAX package's composition instead of the fused kernels."""
    return int8_site(1, 1)


# site ("/".join of the flax module path) -> calibrated activation abs-max;
# consulted under SSGVC_INT8=2
_INT8_SCALES: dict = {}
# sites already warned about a missing mode-2 scale (once per site)
_INT8_WARNED: set = set()
# the calibration in progress (int8_calibration), or None
_CALIB: Optional[dict] = None


def set_int8_scales(scales: dict) -> None:
    """Install the static activation abs-max of each int8 site (mode 2),
    keyed as :func:`collect_int8_scales` keys them.

    The JAX package refuses new scales once a jit trace has baked the old
    ones in (its ``_INT8_BAKED`` guard). The port needs no such guard: its
    eager forward reads this table at every call, so a forward after this
    call uses these scales and nothing can hold stale ones."""
    _INT8_SCALES.clear()
    _INT8_SCALES.update(scales)


def save_int8_scales(path: str) -> None:
    """Write the installed scales as JSON next to a checkpoint, in the JAX
    package's format (either package loads the other's file). An encoder
    and a decoder that hold the same scales produce the same bits."""
    with open(path, "w") as f:
        json.dump(_INT8_SCALES, f, indent=0, sort_keys=True)


def load_int8_scales(path: str) -> dict:
    """Load scales saved by :func:`save_int8_scales` and install them."""
    with open(path) as f:
        scales = {k: float(v) for k, v in json.load(f).items()}
    set_int8_scales(scales)
    return scales


@contextlib.contextmanager
def int8_calibration():
    """``with int8_calibration() as calib: model(...)``: every int8 site
    the forwards reach records the running abs-max of its fp32 input under
    its site key (the JAX package's ``mutable=["int8_calib"]`` apply, whose
    sow reduces a site applied more than once by max). The forwards
    compute as they would outside the context. ``calib`` then goes to
    :func:`collect_int8_scales`."""
    global _CALIB
    if _CALIB is not None:
        raise RuntimeError("int8_calibration contexts do not nest")
    _CALIB = {}
    try:
        yield _CALIB
    finally:
        _CALIB = None


def collect_int8_scales(calib: dict, margin: float = 1.25) -> dict:
    """The site -> abs-max dict :func:`set_int8_scales` takes, from a
    calibration: each recorded fp32 abs-max times ``margin``, in Python
    floats as the JAX package multiplies."""
    return {k: float(v) * margin for k, v in calib.items()}


def name_int8_sites(root: nn.Module) -> None:
    """Give every :class:`Conv` under ``root`` its int8 site key: its
    parameters' flax path (``utils/weights.py`` maps ``a.b.weight`` to
    ``("a", "b", "kernel")``) without ``kernel``, joined by "/", as the
    JAX package keys ``"/".join(self.scope.path)``. The codecs name their
    own sites when built."""
    for name, m in root.named_modules():
        if isinstance(m, Conv):
            m.site = "/".join(name.split("."))


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
        self.site = None          # the int8 site key (name_int8_sites)
        self._wq = self._wq_key = self._wp = None
        self._sx = None           # (abs-max, its s_x tensor) of mode 2

    def int8_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wq, s_w) of ``ops.qconv.quantize_weight`` from the fp32
        weight, rebuilt only when it changed (in place or by a move); a
        1x1's ``ops.qconv.pack_weight`` of wq with them
        (:meth:`int8_packed`)."""
        key = _pack_key(self.weight, (self.weight,))
        if key != self._wq_key:
            self._wq = quantize_weight(self.weight)
            self._wp = (pack_weight(self._wq[0])
                        if self.weight.shape[-1] == 1 else None)
            self._wq_key = key
        return self._wq

    def int8_packed(self) -> Optional[torch.Tensor]:
        """The packed weight the kernel's 1x1 route reads, from
        :meth:`int8_weight`'s cache; None for a kernel > 1."""
        self.int8_weight()
        return self._wp

    def _act_scale(self, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """(s_x, whether it is mode 1's abs-max of x) for ``x``."""
        if _int8_mode() == "2":
            absmax = _INT8_SCALES.get(self._site_key())
            if absmax is not None:
                if self._sx is None or self._sx[0] != absmax \
                        or self._sx[1].device != x.device:
                    self._sx = (absmax, torch.tensor(
                        static_scale(absmax), dtype=torch.float32,
                        device=x.device))
                return self._sx[1], False
            if self.site not in _INT8_WARNED:
                _INT8_WARNED.add(self.site)
                warnings.warn(
                    f"SSGVC_INT8=2 but no calibrated scale for site "
                    f"'{self.site}': falling back to the dynamic per-tensor "
                    f"scale. Calibrate (int8_calibration) and "
                    f"set_int8_scales() first.", stacklevel=3)
        return dynamic_scale(x, spatial.frame_max), True

    def _site_key(self) -> str:
        if self.site is None:
            raise ValueError("an int8 site without a key: name_int8_sites("
                             "root) names a model's convs (the codecs do so "
                             "when built)")
        return self.site

    def int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's QuantConv on this conv's parameters: ``x``
        quantized as given, the output in the module's dtype. Mode 1's
        abs-max is the global tensor's (``parallel.spatial.frame_max``:
        over a row shard's slabs and a :func:`~parallel.spatial.batch_shard`
        group); under a row shard the conv takes the float route's halo.
        With grad enabled it is differentiable as ``jax.grad`` differentiates
        QuantConv (``ops.qconv.qconv_grad``: the bias, and through the
        scales the kernel's and mode 1's input's abs-max elements)."""
        if _CALIB is not None:
            key = self._site_key()
            absmax = spatial.frame_max(x.detach().float().abs().amax())
            prev = _CALIB.get(key)
            _CALIB[key] = absmax if prev is None else torch.maximum(prev,
                                                                    absmax)
        wq, s_w = self.int8_weight()
        wp = self._wp
        s_x, dynamic = self._act_scale(x)
        k, s, p = self.weight.shape[-1], self.stride, self.padding
        x, up, _ = spatial.halo(x, p, max(0, k - s - p), zero_edges=True)
        # a halo brings H's padding rows with it, as on the float route
        pads = (p - up, p - up, p, p)
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return qconv_grad(x, self.weight, self.bias, wq, s_w, s_x, k, s,
                              pads, self.dtype, dynamic,
                              spatial.frame_groups() if dynamic else (),
                              packed=wp)
        return qconv(x, wq, s_w, self.bias, s_x, k, s, pads, self.dtype,
                     packed=wp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if int8_site(self.weight.shape[-1], self.groups):
            return self.int8_forward(x)
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
        name_int8_sites(self)         # a codec renames them from its root

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

    def int8_forward(self, x, quant_step: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """The block as the JAX package composes it from convs
        (``ssgvc_tpu/layers/blocks.py:483-513``), at its rounding points:
        every conv's output in the compute dtype, the 1x1s (and a
        :class:`Conv` adaptor) on the int8 route, the dw3x3 a grouped conv
        or :func:`dw3x3_shiftadd`. Taken while the 1x1s are int8 sites."""
        dt = self.dtype
        x = self.adapt(x)
        h = wsilu(self.dc_0(x))
        if _dw_shiftadd():
            # under a row shard: the dw3x3's row of each neighbour slab
            h, up, down = spatial.halo(h, 1, 1)
            h = spatial.crop(dw3x3_shiftadd(h, self.dc_2.weight.to(dt),
                                            self.dc_2.bias.to(dt)), up, down)
        else:
            h = self.dc_2(h)
        out = self.dc_3(h) + x
        out = self.ffn_2(wsilu_chunk_add(self.ffn_0(out))) + out
        if self.shortcut:
            out = out + x
        if quant_step is not None:
            out = out * quant_step.reshape(-1).to(dt)
        return out

    def forward(self, x, quant_step: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if _int8_blocks():
            return self.int8_forward(x, quant_step)
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
    if _int8_blocks():
        # the JAX package's int8 graph: block after block, q_last last
        for i, b in enumerate(blocks):
            x = b.int8_forward(x, q_last if i == len(blocks) - 1 else None)
        return x
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
