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
CUDA tensor launches the kernel (:func:`qconv_cuda`) or raises. On the card
:func:`route_of` picks one of two hand-written routes by shape: the 1x1
route (s8 wgmma, x quantized once into shared memory, weights packed by
:func:`pack_weight` and copied in by a ring, y stored in whole rows; its
plan :func:`plan_1x1`) or the gemm route (x quantized once into int8
scratch, then an implicit GEMM on ``mma.sync``). ``csrc/qconv.cu`` says
what each computes and what bounds it.
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
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_max_, all_reduce_sum_
from . import _build

#: Kernel launches since the count was last set to 0 (either route).
launches = 0
#: Launches of the 1x1 route and of the gemm route (its quantizing pass
#: and implicit GEMM count as one), since each was last set to 0.
launches_1x1 = 0
launches_gemm = 0
#: K is padded to a multiple of this (one m16n8k32 step) with zero weights.
K_STEP = 32
#: Input and output dtypes the kernel takes.
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# The 1x1 route's constants (must match csrc/qconv.cu): K bytes of a ring
# slot (two k32 wgmma steps), rows of a consumer warpgroup, output columns
# a staging row holds, a ring's most slots.
KC = 64
ROWS_WG = 64
STAGE_COLS = 64
MAX_STAGES = 8
#: shared memory one thread block may use; each of two on one SM (the
#: SM's 228 KB less 1 KB reserved a block)
SMEM_LIMIT = 232448
SMEM_PAIR = (233472 - 2 * 1024) // 2
#: SMs of an H100: 128-row tiles only where they are at least this many
SMS = 132


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


def tile_n(o: int) -> int:
    """The 1x1 route's N tile (the wgmma width) for O output channels."""
    return 32 if o <= 32 else 64 if o <= 64 else 128


def padded_kq(k: int) -> int:
    """K (the 1x1 route's Cin, or a weight's Kp) rounded up to a ring
    slot's KC bytes."""
    return -(-k // KC) * KC


def smem_1x1(rg: int, ng: int, bn: int, kq: int, stages: int,
             out_size: int, o: int) -> int:
    """Bytes of the 1x1 route's shared memory for ``rg`` row groups of 64
    and ``ng`` N groups: the quantized rows (64 rg x kq), ng rings of
    ``stages`` slots of bn x KC, a staging block of 64 rows of (min(bn,
    STAGE_COLS) + 8) outputs for each of the rg ng consumer warpgroups,
    scale and bias of every column of O padded to bn (fp32), and a full and
    an empty mbarrier a slot."""
    row = (min(bn, STAGE_COLS) + 8) * out_size
    return (rg * ROWS_WG * kq + ng * stages * bn * KC
            + rg * ng * ROWS_WG * row + 8 * (-(-o // bn) * bn)
            + ng * stages * 16)


def plan_1x1(m: int, cin: int, o: int, out_size: int) -> Optional[dict]:
    """The 1x1 route's launch for M = B H W rows, or None where its shared
    memory does not fit (the gemm route takes the site). A block owns
    ``bm`` rows and every N tile of ``bn`` columns: two row groups of 64
    sharing one ring (``rg`` 2, 128 rows) where there are at least
    :data:`SMS` such blocks and the N tile is 128, else 64 rows, split over
    two N groups (``ng`` 2: two warpgroups on alternate N tiles, a ring
    each) where there are two N tiles or more. Ring slots: the most (to
    :data:`MAX_STAGES`) that keep two blocks on an SM where three or more
    do, else the most one block can hold."""
    kq, bn = padded_kq(cin), tile_n(o)
    nt = -(-o // bn)
    shapes = [(2, 1)] if bn == 128 and -(-m // 128) >= SMS else []
    shapes.append((1, 2) if bn == 128 and nt >= 2 else (1, 1))
    for cap, least in ((SMEM_PAIR, 3), (SMEM_LIMIT, 2)):
        for rg, ng in shapes:
            fits = [s for s in range(2, MAX_STAGES + 1)
                    if smem_1x1(rg, ng, bn, kq, s, out_size, o) <= cap]
            if fits and max(fits) >= least:
                stages = max(fits)
                return dict(rg=rg, ng=ng, bm=rg * ROWS_WG, bn=bn, kq=kq,
                            stages=stages,
                            smem=smem_1x1(rg, ng, bn, kq, stages, out_size,
                                          o),
                            blocks=-(-m // (rg * ROWS_WG)), n_tiles=nt)
    return None


def route_of(shape: Sequence[int], o: int, kernel: int, stride: int,
             pads: Sequence[int], x_aligned: bool,
             out_size: int) -> Tuple[str, Optional[dict]]:
    """("1x1", its plan) for a 1x1 stride-1 unpadded conv on a 16-byte
    aligned x with Cin % 16 == 0 whose plan fits, else ("gemm", None).
    Kept per shape: the host decides once a site, not once a call."""
    return _route(tuple(shape), o, kernel, stride, tuple(pads), x_aligned,
                  out_size)


@functools.lru_cache(maxsize=4096)
def _route(shape, o, kernel, stride, pads, x_aligned, out_size):
    b, h, w, cin = shape
    if (kernel == 1 and stride == 1 and pads == (0, 0, 0, 0)
            and cin % 16 == 0 and x_aligned):
        plan = plan_1x1(b * h * w, cin, o, out_size)
        if plan is not None:
            return "1x1", plan
    return "gemm", None


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """A 1x1 weight's ``wq`` (O, Kp) int8 as the 1x1 route's ring copies
    it: one contiguous slot of BN x KC bytes per (N tile t, K chunk c), in
    order t then c, O padded to BN and Kp to KQ with zeros; inside a slot
    element (n, k) lies at (n // 8) * 8 KC + (k // 16) * 128 + (n % 8) * 16
    + k % 16 (the canonical K-major layout with 16-byte core-matrix rows).
    Returns a flat int8 tensor on wq's device (no host sync)."""
    o, kp = wq.shape
    bn, kq = tile_n(o), padded_kq(kp)
    nt = -(-o // bn)
    w = torch.zeros((nt * bn, kq), dtype=torch.int8, device=wq.device)
    w[:o, :kp] = wq
    w = w.reshape(nt, bn // 8, 8, kq // KC, KC // 16, 16)
    return w.permute(0, 3, 1, 4, 2, 5).contiguous().reshape(-1)


def unpack_weight(packed: torch.Tensor, o: int, kp: int) -> torch.Tensor:
    """The inverse of :func:`pack_weight`: the (O, Kp) ``wq``."""
    bn, kq = tile_n(o), padded_kq(kp)
    nt = -(-o // bn)
    w = packed.reshape(nt, kq // KC, bn // 8, KC // 16, 8, 16)
    w = w.permute(0, 2, 4, 1, 3, 5).reshape(nt * bn, kq)
    return w[:o, :kp].contiguous()


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
    if lib.ssgvc_qconv_1x1.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssgvc_qconv_1x1.argtypes = ([vp, i, vp, vp, vp, vp, vp, i]
                                        + [i] * 9 + [vp])
        lib.ssgvc_qconv_gemm.argtypes = ([vp, i, vp, vp, vp, vp, vp, vp, i]
                                         + [i] * 12 + [vp])
        lib.ssgvc_qconv_smem_1x1.argtypes = [i] * 7
        for fn in (lib.ssgvc_qconv_1x1, lib.ssgvc_qconv_gemm,
                   lib.ssgvc_qconv_smem_1x1):
            fn.restype = ctypes.c_int
    return lib


def qconv_cuda(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor, s_x: torch.Tensor, kernel: int,
               stride: int, pads: Sequence[int], out_dtype: torch.dtype,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/qconv.cu`` on checked operands (as
    :func:`qconv_plain`): x contiguous bf16 or fp32 on the card, ``wq``
    (O, Kp) int8, ``s_w`` and ``bias`` (O,) fp32 (``bias`` is cast),
    ``s_x`` one fp32 on x's device; ``packed``: ``pack_weight(wq)``, which
    the 1x1 route reads (packed here when not given). The route is
    :func:`route_of`'s. Returns a new (B, Ho, Wo, O)."""
    global launches, launches_1x1, launches_gemm
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
    # fp32 contiguous operands pass as they are (the kernel reads their
    # data pointers): the host's time a call sets the int8 frame's
    bias, s_w, s_x = (t if t.dtype == torch.float32 and t.is_contiguous()
                      else t.detach().float().contiguous()
                      for t in (bias, s_w, s_x))
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
    x_f32, y_f32 = int(x.dtype == torch.float32), int(out_dtype
                                                     == torch.float32)
    route, plan = route_of(x.shape, o, kernel, stride, pads,
                           x.data_ptr() % 16 == 0, y.element_size())
    if route == "1x1":
        if packed is None:
            packed = pack_weight(wq)
        size = plan["n_tiles"] * plan["bn"] * plan["kq"]
        if (packed.dtype != torch.int8 or packed.numel() != size
                or not packed.is_contiguous() or packed.device != x.device
                or packed.data_ptr() % 16):
            raise ValueError(f"{what}: the packed weights must be "
                             f"pack_weight(wq), {size} int8 on {x.device}, "
                             f"got {packed.dtype} {tuple(packed.shape)} on "
                             f"{packed.device}")
    else:
        xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _lib()

    def launch():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "1x1":
            return lib.ssgvc_qconv_1x1(
                x.data_ptr(), x_f32, packed.data_ptr(), s_w.data_ptr(),
                bias.data_ptr(), s_x.data_ptr(), y.data_ptr(), y_f32,
                b * h * w, cin, o, plan["rg"], plan["ng"], plan["bn"],
                plan["kq"], plan["stages"], plan["smem"], stream)
        return lib.ssgvc_qconv_gemm(
            x.data_ptr(), x_f32, xq.data_ptr(), wq.data_ptr(),
            s_w.data_ptr(), bias.data_ptr(), s_x.data_ptr(), y.data_ptr(),
            y_f32, b, h, w, cin, o, kernel, kernel, stride, pt, pb, pl, pr,
            stream)

    if x.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(x.device):
            rc = launch()
    _build.check(lib, rc, f"qconv kernel ({route} route)")
    launches += 1
    if route == "1x1":
        launches_1x1 += 1
    else:
        launches_gemm += 1
    return y


def qconv(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
          bias: torch.Tensor, s_x: torch.Tensor, kernel: int, stride: int,
          pads: Sequence[int], out_dtype: Optional[torch.dtype] = None,
          packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv: the plain version for a CPU tensor, the kernel for a
    CUDA tensor (which raises on what it does not take). ``out_dtype``
    defaults to x's; ``packed`` (``pack_weight(wq)``, kept by the caller
    per weight version) feeds the 1x1 route."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return qconv_plain(x, wq, s_w, bias, s_x, kernel, stride, pads,
                           out_dtype)
    return qconv_cuda(x.contiguous(), wq, s_w, bias, s_x, kernel, stride,
                      pads, out_dtype, packed)


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
                out_dtype, dynamic, groups, packed):
        ctx.save_for_backward(x, weight, wq, s_w, s_x)
        ctx.meta = (kernel, stride, tuple(pads), dynamic, tuple(groups))
        ctx.packed = packed
        return qconv(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype,
                     packed=packed)

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
                      torch.float32, packed=ctx.packed)
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
        return (dx, dw, db) + (None,) * 10


def qconv_grad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               wq: torch.Tensor, s_w: torch.Tensor, s_x: torch.Tensor,
               kernel: int, stride: int, pads: Sequence[int],
               out_dtype: torch.dtype, dynamic: bool,
               groups: Sequence = (),
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`qconv` differentiable as ``jax.grad`` differentiates the
    JAX package's QuantConv (:class:`_QConvGrad`): ``weight`` (O, Cin, k,
    k) fp32 is the parameter ``wq`` / ``s_w`` were quantized from,
    ``dynamic`` says s_x is mode 1's abs-max of x (over ``groups``, the
    process groups x is spread over: the tie count and d s_x are theirs
    too) rather than a constant; ``packed`` as for :func:`qconv`, for
    both launches."""
    return _QConvGrad.apply(x, weight, bias, wq, s_w, s_x, kernel, stride,
                            pads, out_dtype, dynamic, list(groups), packed)
