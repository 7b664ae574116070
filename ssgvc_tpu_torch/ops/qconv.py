"""W8A8 int8 convolution: the CUDA kernel ``csrc/qconv.cu``, its plain
PyTorch version, and the scale arithmetic of the JAX package's
``QuantConv`` (``ssgvc_tpu/layers/blocks.py:170-240``) that both share.

``QuantConv`` computes, on NHWC ``x`` and a conv weight ``k``:

    s_w = max(max |k[o]|, 1e-12) / 127            per output channel, fp32
    wq  = round(k / s_w)                          int8
    s_x = max(max |x|, 1e-12) / 127               mode 1 (fp32, on the card)
        = fp32(max(absmax, 1e-12) / 127)          mode 2 (a Python float
                                                  division, rounded once)
    xq  = clip(round(x / s_x), -127, 127)         int8
    y   = float(xq (*) wq) * (s_x * s_w) + b      int32 sums, then the
                                                  compute dtype

Rounding is half to even throughout (``jnp.round``, ``torch.round``,
``rintf``). Divisions on the card take a tensor divisor on the same
device: PyTorch's CUDA division by a Python number multiplies by its
reciprocal, which can differ from the division by an ulp.

:func:`qconv` routes by device: a CPU tensor takes :func:`qconv_plain`, a
CUDA tensor launches the kernel (:func:`qconv_cuda`) or raises.
:func:`qconv_plain` sums the int8 products exactly (a float64 conv on the
int8 values: |sum| <= K * 127^2 < 2^53, whatever the order), so on the card
the kernel and the plain version agree bit for bit.

:func:`qconv_grad` is the same conv with the gradient ``jax.grad`` takes
through QuantConv: the int8 casts carry none, so it reaches the bias and,
through the scales, the kernel's per-channel abs-max elements and (mode 1)
x's abs-max elements. Its backward recomputes the int32 sums by a second
launch of the same conv.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_max_, all_reduce_sum_
from . import _build

#: Kernel launches since the count was last set to 0.
launches = 0
#: K is padded to a multiple of this (one m16n8k32 step) with zero weights.
K_STEP = 32
#: Input and output dtypes the kernel takes.
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d as an IEEE division on t's device (a tensor divisor)."""
    return t / torch.full_like(t, d)


def padded_k(k: int) -> int:
    return -(-k // K_STEP) * K_STEP


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(wq, s_w) of a conv weight (O, Cin, kh, kw) in fp32: ``wq`` (O, Kp)
    int8 in (ky, kx, ci) order, ci fastest, zero-padded to Kp =
    :func:`padded_k` (kh * kw * Cin); ``s_w`` (O,) fp32."""
    w = weight.detach().float()
    o = w.shape[0]
    s_w = _div(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12), 127.0)
    q = torch.round(w / s_w[:, None, None, None])
    q = q.permute(0, 2, 3, 1).reshape(o, -1)
    k = q.shape[1]
    wq = torch.zeros((o, padded_k(k)), dtype=torch.int8, device=w.device)
    wq[:, :k] = q.to(torch.int8)
    return wq, s_w


def static_scale(absmax: float) -> float:
    """Mode 2's s_x from a calibrated abs-max: the Python float division,
    rounded once to fp32, as ``jnp.float32(max(absmax, 1e-12) / 127.0)``."""
    return float(np.float32(max(absmax, 1e-12) / 127.0))


def dynamic_scale(x: torch.Tensor, reduce=None) -> torch.Tensor:
    """Mode 1's s_x: max(max |x|, 1e-12) / 127 in fp32, a 0-dim tensor on
    x's device (no host sync). ``reduce`` takes the local abs-max to the
    global tensor's (``parallel.spatial.frame_max``). The value carries no
    autograd graph: :func:`qconv_grad`'s backward routes the gradient of
    s_x to x itself."""
    absmax = x.detach().float().abs().amax()
    if reduce is not None:
        absmax = reduce(absmax)
    return _div(torch.clamp_min(absmax, 1e-12), 127.0)


def out_size(n: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (n + lo + hi - k) // stride + 1


def qconv_plain(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                bias: torch.Tensor, s_x: torch.Tensor, kernel: int,
                stride: int, pads: Sequence[int],
                out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (B, H, W, Cin) any float
    dtype, ``wq``/``s_w`` from :func:`quantize_weight`, ``bias`` (O,),
    ``s_x`` a 0-dim fp32 tensor on x's device, ``pads`` (top, bottom, left,
    right). Returns (B, Ho, Wo, O) in ``out_dtype``."""
    pt, pb, pl, pr = pads
    cin = x.shape[-1]
    o = wq.shape[0]
    kk = kernel * kernel * cin
    xq = torch.clamp(torch.round(x.detach().float() / s_x), -127, 127)
    xq = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    w = wq[:, :kk].double().reshape(o, kernel, kernel, cin).permute(0, 3, 1,
                                                                    2)
    acc = F.conv2d(xq, w, stride=stride).to(torch.int32)
    y = acc.float().permute(0, 2, 3, 1) * (s_x * s_w)
    y = y + bias.detach().float()
    return y.to(out_dtype).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("qconv")
    fn = lib.ssgvc_qconv_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, vp, i] + [i] * 13 + [vp]
        fn.restype = ctypes.c_int
    return lib


def qconv_cuda(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor, s_x: torch.Tensor, kernel: int,
               stride: int, pads: Sequence[int],
               out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/qconv.cu`` on checked operands (as
    :func:`qconv_plain`): x contiguous bf16 or fp32 on the card, ``wq``
    (O, Kp) int8, ``s_w`` and ``bias`` (O,) fp32 (``bias`` is cast),
    ``s_x`` one fp32 on x's device. Returns a new (B, Ho, Wo, O)."""
    global launches
    what = "qconv"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: kernel takes {KERNEL_DTYPES}, got "
                        f"{x.dtype} -> {out_dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous (B, H, W, C), "
                         f"got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    o = wq.shape[0]
    kp = padded_k(kernel * kernel * cin)
    if (wq.dtype != torch.int8 or tuple(wq.shape) != (o, kp)
            or not wq.is_contiguous() or wq.device != x.device
            or wq.data_ptr() % 16):
        raise ValueError(f"{what}: weights must be a 16-byte aligned "
                         f"contiguous int8 ({o}, {kp}) on {x.device}, got "
                         f"{wq.dtype} {tuple(wq.shape)} on {wq.device}")
    bias = bias.detach().float().contiguous()
    s_w = s_w.float().contiguous()
    s_x = s_x.float().reshape(1)
    for t, n, nm in ((s_w, o, "s_w"), (bias, o, "bias"), (s_x, 1, "s_x")):
        if t.numel() != n or t.device != x.device:
            raise ValueError(f"{what}: {nm} must hold {n} fp32 on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    pt, pb, pl, pr = pads
    ho = out_size(h, kernel, stride, pt, pb)
    wo = out_size(w, kernel, stride, pl, pr)
    if ho < 1 or wo < 1:
        raise ValueError(f"{what}: empty output for {tuple(x.shape)}")
    y = torch.empty((b, ho, wo, o), dtype=out_dtype, device=x.device)
    vec = int(cin % 16 == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssgvc_qconv_forward(
            x.data_ptr(), int(x.dtype == torch.float32), wq.data_ptr(),
            s_w.data_ptr(), bias.data_ptr(), s_x.data_ptr(), y.data_ptr(),
            int(out_dtype == torch.float32), b, h, w, cin, o, kernel, kernel,
            stride, pt, pb, pl, pr, vec, stream)
    _build.check(lib, rc, "qconv kernel")
    launches += 1
    return y


def qconv(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
          bias: torch.Tensor, s_x: torch.Tensor, kernel: int, stride: int,
          pads: Sequence[int],
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv: the plain version for a CPU tensor, the kernel for a
    CUDA tensor (which raises on what it does not take). ``out_dtype``
    defaults to x's."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return qconv_plain(x, wq, s_w, bias, s_x, kernel, stride, pads,
                           out_dtype)
    return qconv_cuda(x.contiguous(), wq, s_w, bias, s_x, kernel, stride,
                      pads, out_dtype)


#: the floor of the abs-max in s_w and s_x (``jnp.maximum(., 1e-12)``)
ABSMAX_FLOOR = 1e-12


def _floor_gate(m: torch.Tensor) -> torch.Tensor:
    """d max(m, 1e-12) / dm as ``jax.grad`` gives it (lax.max's balanced
    JVP): 1 above the floor, 1/2 on it, 0 below."""
    floor = torch.tensor(ABSMAX_FLOOR, dtype=torch.float32, device=m.device)
    return torch.where(m > floor, 1.0, torch.where(m == floor, 0.5, 0.0))


def _absmax_grad(t: torch.Tensor, d_scale: torch.Tensor, m: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """The gradient that ``s = max(m, 1e-12) / 127``, with m = max |t| over
    the dims m does not keep, sends to t: d_scale / 127 through the floor,
    split evenly over the ``count`` elements at the abs-max (``jnp.max``'s
    JVP), times sign(t) (``jnp.abs``'s). ``d_scale``, ``m``, ``count``
    broadcast against t."""
    at = (t.abs() == m).float()
    per = _div(d_scale, 127.0) * _floor_gate(m) / count
    return per * at * torch.sign(t)


class _QConvGrad(torch.autograd.Function):
    """:func:`qconv` with the gradient ``jax.grad`` takes through the JAX
    package's QuantConv, whose int8 casts carry none: the bias's, and
    through out = y * (s_x * s_w) + b the scales' (c = sum g * y per output
    channel, y the int32 sums in fp32) on to the kernel elements at each
    channel's abs-max and, in mode 1 (``dynamic``), to x's elements at the
    global abs-max. y is recomputed in the backward by a second launch of
    the same conv on x's int8 values with unit scales, a zero bias and an
    fp32 output (exact), so nothing the size of an output is saved."""

    @staticmethod
    def forward(ctx, x, weight, bias, wq, s_w, s_x, kernel, stride, pads,
                out_dtype, dynamic, groups):
        ctx.save_for_backward(x, weight, wq, s_w, s_x)
        ctx.meta = (kernel, stride, tuple(pads), dynamic, tuple(groups))
        return qconv(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, wq, s_w, s_x = ctx.saved_tensors
        kernel, stride, pads, dynamic, groups = ctx.meta
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        need_x = need_x and dynamic
        gf = g.float()
        dx = dw = db = None
        if need_b:
            db = gf.sum(dim=(0, 1, 2))
        if need_w or need_x:
            xq = torch.clamp(torch.round(x.detach().float() / s_x), -127,
                             127)
            y = qconv(xq, wq, torch.ones_like(s_w), torch.zeros_like(s_w),
                      torch.ones_like(s_x), kernel, stride, pads,
                      torch.float32)
            c = (gf * y).sum(dim=(0, 1, 2))
        if need_w:
            w = weight.detach()
            m = w.abs().amax(dim=(1, 2, 3), keepdim=True)
            count = (w.abs() == m).float().sum(dim=(1, 2, 3), keepdim=True)
            dw = _absmax_grad(w, (c * s_x).reshape(-1, 1, 1, 1), m, count)
        if need_x:
            xf = x.detach().float()
            # the global abs-max and its tie count, and d s_x summed over
            # the ranks the tensor is spread over (each rank's loss sends
            # its own part)
            m = xf.abs().amax()
            for grp in groups:
                all_reduce_max_([m], grp)
            part = torch.stack([(c * s_w).sum(),
                                (xf.abs() == m).float().sum()])
            for grp in groups:
                all_reduce_sum_([part], grp)
            dx = _absmax_grad(xf, part[0], m, part[1]).to(x.dtype)
        return (dx, dw, db) + (None,) * 9


def qconv_grad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               wq: torch.Tensor, s_w: torch.Tensor, s_x: torch.Tensor,
               kernel: int, stride: int, pads: Sequence[int],
               out_dtype: torch.dtype, dynamic: bool,
               groups: Sequence = ()) -> torch.Tensor:
    """:func:`qconv` differentiable as ``jax.grad`` differentiates the
    JAX package's QuantConv (:class:`_QConvGrad`): ``weight`` (O, Cin, k,
    k) fp32 is the parameter ``wq`` / ``s_w`` were quantized from,
    ``dynamic`` says s_x is mode 1's abs-max of x (over ``groups``, the
    process groups x is spread over: the tie count and d s_x are theirs
    too) rather than a constant."""
    return _QConvGrad.apply(x, weight, bias, wq, s_w, s_x, kernel, stride,
                            pads, out_dtype, dynamic, list(groups))
