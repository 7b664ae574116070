"""One DepthConvBlock after its adaptor: the CUDA kernel ``csrc/dcb.cu`` and
its plain PyTorch version.

The block (NHWC, per pixel, C channels)::

    h = wsilu(x @ W0 + b0)              zeroed outside the frame
    h = dw3x3(h) + b2                   zero padding in h space
    u = x + (h @ W3 + b3)
    f = wsilu(u @ Wf0a + bf0a) + wsilu(u @ Wf0b + bf0b)     (4C split in 2C halves)
    y = u + (f @ Wf2 + bf2)   [+ x if shortcut]   [* q]

Rounding points, shared by the kernel and :func:`dcb_plain` (those of the
TPU kernel ``ssgvc_tpu/ops/pallas_dcb.py``): weights and biases are first
rounded to the activation dtype; products accumulate in fp32; ``h`` stays
fp32 through the depthwise and is rounded before W3; ``u`` stays fp32 for
the residuals and is rounded before Wf0; ``f`` is rounded before Wf2; the
output is rounded once. In fp32 every rounding is the identity, so the
plain version is the conv composition of ``layers/blocks.DepthConvBlock``.

:func:`dcb` routes by device: a CPU tensor takes :func:`dcb_plain`; a CUDA
tensor launches the kernel or raises. The kernel takes bfloat16 activations,
B=1 and C in :data:`KERNEL_CHANNELS`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

#: Channel widths the kernels are instantiated for (the main path's).
KERNEL_CHANNELS = (128, 256, 320, 384)
#: Dynamic shared memory one block may use on sm_90.
SMEM_LIMIT = 232448
#: Output tiles (rows, cols) tried in order; the first that fits is taken.
TILES = ((8, 8), (8, 4), (4, 8), (6, 4), (4, 6), (4, 4), (4, 2), (2, 4),
         (2, 2))
# row strides of the h chunk (fp32) and f chunk (bf16), and the stage-B
# sub-tile: these must match csrc/dcb_core.cuh
_SH, _SF, _MB = 68, 72, 64

#: Kernel launches since the count was last set to 0.
launches = 0

Params = Tuple[torch.Tensor, ...]   # (w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2)


def wsilu(x: torch.Tensor) -> torch.Tensor:
    """silu(4x)/4."""
    return F.silu(4.0 * x) * 0.25


def smem_bytes(c: int, n: int, th: int, tw: int) -> int:
    """Dynamic shared memory of one kernel block for ``n`` chained blocks on
    a (th, tw) output tile: the halo-extended activations (bf16), the
    depthwise output of the current block (bf16), and a work area that
    holds either one fp32 h-chunk or the FFN's bf16 operands."""
    sc = c + 8
    p_in = (th + 2 * n) * (tw + 2 * n)
    p_out = (th + 2 * n - 2) * (tw + 2 * n - 2)
    work = max(p_in * _SH * 4, _MB * sc * 2 + _MB * _SF * 2)
    return p_in * sc * 2 + p_out * sc * 2 + work


def plan_tile(c: int, n: int) -> Optional[Tuple[int, int]]:
    """The first tile of :data:`TILES` whose working set fits, or None."""
    for th, tw in TILES:
        if smem_bytes(c, n, th, tw) <= SMEM_LIMIT:
            return th, tw
    return None


def packed_numel(c: int) -> int:
    return 8 * c * c + 17 * c


def pack_params(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """One block's weights in the kernel's layout, rounded to ``dtype``:
    W0 (C,C), W3 (C,C), Wf0 (4C,C), Wf2 (C,2C), each [out][in]; the
    depthwise taps (9,C); then b0, b2, b3 (C each), bf0 (4C), bf2 (C)."""
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    c = w0.shape[0]
    with torch.no_grad():
        parts = (w0, w3, wf0, wf2, w2.reshape(c, 9).t(), b0, b2, b3, bf0, bf2)
        return torch.cat([p.reshape(-1) for p in parts]).to(dtype)


def dcb_plain(x: torch.Tensor, params: Params,
              q: Optional[torch.Tensor] = None,
              shortcut: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one block at the kernel's
    rounding points, matmuls in fp32 on upcast operands."""
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    cdt = x.dtype
    c = x.shape[-1]
    r = lambda t: t.to(cdt).float()
    xf = x.float()
    h = wsilu(F.linear(xf, r(w0).reshape(c, c), r(b0)))
    h = F.conv2d(h.permute(0, 3, 1, 2), r(w2), r(b2), padding=1,
                 groups=c).permute(0, 2, 3, 1)
    u = xf + F.linear(r(h), r(w3).reshape(c, c), r(b3))
    f = F.linear(r(u), r(wf0).reshape(4 * c, c), r(bf0))
    f = wsilu(f[..., :2 * c]) + wsilu(f[..., 2 * c:])
    y = F.linear(r(f), r(wf2).reshape(c, 2 * c), r(bf2)) + u
    if shortcut:
        y = y + xf
    if q is not None:
        y = y * r(q).reshape(c)
    return y.to(cdt)


def check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"{what}: kernel takes (1, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] not in KERNEL_CHANNELS:
        raise ValueError(f"{what}: C={x.shape[-1]} not in {KERNEL_CHANNELS}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NHWC")


def check_operand(t: torch.Tensor, x: torch.Tensor, numel: int,
                  what: str) -> None:
    if (t.device != x.device or t.dtype != x.dtype or t.numel() != numel
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous {x.dtype} tensor of {numel} "
            f"elements on {x.device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _q_ptr(q: Optional[torch.Tensor], x: torch.Tensor, what: str):
    if q is None:
        return None, None
    q = q.reshape(-1)
    check_operand(q, x, x.shape[-1], f"{what} q")
    return q, q.data_ptr()


def _lib() -> ctypes.CDLL:
    lib = _build.load("dcb")
    fn = lib.ssgvc_dcb_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def dcb_cuda(x: torch.Tensor, packed: torch.Tensor,
             q: Optional[torch.Tensor] = None,
             shortcut: bool = False) -> torch.Tensor:
    """Launch the kernel: x (1, H, W, C) bf16 CUDA, ``packed`` from
    :func:`pack_params`, q (C,) or None. Returns a new (1, H, W, C)."""
    global launches
    check_input(x, "dcb")
    _, h, w, c = x.shape
    check_operand(packed, x, packed_numel(c), "dcb weights")
    q, q_ptr = _q_ptr(q, x, "dcb")
    th, tw = plan_tile(c, 1)
    lib = _lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssgvc_dcb_forward(
            x.data_ptr(), y.data_ptr(), packed.data_ptr(), q_ptr, h, w, c,
            th, tw, int(bool(shortcut)), smem_bytes(c, 1, th, tw), stream)
    _build.check(lib, rc, "dcb kernel")
    launches += 1
    return y


def dcb(x: torch.Tensor, params: Params, q: Optional[torch.Tensor] = None,
        shortcut: bool = False,
        packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block after its adaptor: the plain version for a CPU tensor, the
    kernel for a CUDA tensor. ``packed`` may carry cached
    :func:`pack_params` output for the kernel."""
    if x.device.type == "cpu":
        return dcb_plain(x, params, q, shortcut)
    if packed is None:
        packed = pack_params(params, x.dtype)
    return dcb_cuda(x, packed, q, shortcut)
