"""The DepthConvBlock gradient: :class:`DCBFunction` and
:class:`DCBChainFunction` (``torch.autograd.Function``s over ``ops.dcb`` and
``ops.dcb_chain``), the block backward they share, and its own kernels
(``csrc/dcb_bwd.cu``) with their plain PyTorch versions.

The block, at the rounding points of ``ops/dcb.py`` (``r`` rounds to the
activation dtype; weights and biases are rounded first)::

    a0 = x W0 + b0;  h = wsilu(a0);  g = r(dw3x3(h) + b2)
    u = x + g W3 + b3;  p = r(u) Wf0 + bf0
    f = r(wsilu(p_a) + wsilu(p_b));  y = (f Wf2 + bf2 + u [+ x]) [* q]

Its backward (:func:`block_backward`) recomputes a0, u and p with
``F.linear``, and runs every 1x1 conv's input and weight gradient as a
matrix product. The rest runs in four kernels, each beside its plain
version; a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises:

  * :func:`dw_fwd` (a): g from a0, the depthwise 3x3 of wsilu(a0) with
    zero padding per image;
  * :func:`gate_bwd` (b): dp from df through wsilu' for both 2C halves, the
    FFN's hidden f, dy * q, and per-tile partial sums for bf0, bf2 and q;
  * :func:`dw_bwd` (c): da0 = dw3x3^T(dg) * wsilu'(a0), and per-tile partial
    sums for the taps (against h = wsilu(a0)), b2, b0 and b3;
  * :func:`grad_reduce` (d): the partials' rows summed in a fixed order,
    the partition set by the partials' shape alone
    (:func:`grad_reduce_order` is the same additions on the CPU).

The partials have one row per tile of :func:`bwd_tiles` on the card (one
on the CPU), a partition set by the activation's shape alone.

Every rounding is the identity in the backward (the straight-through
gradient autograd gives ``.to(dtype)``); gradients are fp32 inside, dx
returns in x's dtype and each parameter's gradient in fp32. No
floating-point atomics: the same inputs give the same gradients bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .dcb import (KERNEL_DTYPES, WIDTH_STEP, Params, dcb, packed_numel,
                  wsilu)
from .dcb_chain import dcb_chain

#: The partials' partition (csrc/dcb_bwd.cu): tiles of at most TILE x TILE
#: pixels of one image, one partials row each; gate_bwd and dw_bwd give a
#: thread block one tile's SLICE channels (dw_fwd runs on the same tiles
#: without partials, its thread blocks on narrower slices).
TILE, SLICE = 8, 32
#: Kernel launches since each count was last set to 0.
launches = {"dw_fwd": 0, "gate_bwd": 0, "dw_bwd": 0, "grad_reduce": 0}
#: The same launches by operand shape since last cleared: (kernel, key) ->
#: count; the key is the activation's (B, H, W, C), for gate_bwd with
#: whether q was given, and for grad_reduce the partials' (rows, cols).
shape_launches: Dict[Tuple[str, tuple], int] = {}
#: grad_reduce's fixed partition (csrc/dcb_bwd.cu): rows in chunks of
#: RED_CHUNK, each chunk's rows in RED_WARPS contiguous runs summed in order,
#: the runs' sums added in order; more than one chunk, and the chunks' sums
#: are summed the same way.
RED_CHUNK, RED_WARPS = 1024, 8
#: Partial-sum columns of one block backward, as multiples of C: gate_bwd's
#: bf0 (4), bf2 (1) and q (1), then dw_bwd's taps (9), b2, b0 and b3 (1 each).
GATE_COLS, DW_COLS = 6, 12


def wsilu_grad(v: torch.Tensor) -> torch.Tensor:
    """d wsilu / dv."""
    s = torch.sigmoid(4.0 * v)
    return s + 4.0 * v * s * (1.0 - s)


def bwd_tiles(shape: Sequence[int]) -> Tuple[int, int, int]:
    """(th, tw, rows) of the partials' partition of a (B, H, W, C)
    activation: tiles of th x tw pixels (th = min(TILE, H), tw = min(TILE,
    W)) that never cross an image, the last tile row and column cut off at
    the image's edge; one partials row per tile, ordered (image, tile row,
    tile column). A function of the shape alone."""
    b, h, w, _ = shape
    th, tw = min(TILE, h), min(TILE, w)
    return th, tw, b * -(-h // th) * -(-w // tw)


def partial_rows(x: torch.Tensor) -> int:
    """Rows of the partials matrix for a (B, H, W, C) activation: one per
    tile of :func:`bwd_tiles` on the card, one on the CPU."""
    if x.device.type == "cpu":
        return 1
    return bwd_tiles(x.shape)[2]


def tile_sums(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-pixel values ``t`` (B, H, W, K) summed over each partials row's
    pixels: (rows, K). One row sums every pixel; otherwise ``rows`` must be
    :func:`bwd_tiles`' count, and row r sums tile r's pixels."""
    if rows == 1:
        return t.sum((0, 1, 2))[None]
    b, h, w, k = t.shape
    th, tw, n = bwd_tiles(t.shape)
    if rows != n:
        raise ValueError(f"partials: {rows} rows, the partition of "
                         f"{tuple(t.shape)} has {n}")
    ny, nx = -(-h // th), -(-w // tw)
    t = F.pad(t, (0, 0, 0, nx * tw - w, 0, ny * th - h))
    return t.reshape(b, ny, th, nx, tw, k).sum((2, 4)).reshape(n, k)


# ------------------------------------------------------------ plain versions

def dw_fwd_plain(a0: torch.Tensor, taps: torch.Tensor, b2: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """g = dw3x3(h) + b2 with h = wsilu(a0), rounded to ``out_dtype``; a0
    (B, H, W, C) fp32, taps (9, C) (tap 3 i + j reads h at (y + i - 1,
    x + j - 1)), b2 (C,)."""
    c = a0.shape[-1]
    g = F.conv2d(wsilu(a0).permute(0, 3, 1, 2),
                 taps.t().reshape(c, 1, 3, 3), b2, padding=1,
                 groups=c).permute(0, 2, 3, 1)
    return g.to(out_dtype)


def gate_bwd_plain(df, p, dy, q, resid, part, col):
    """(dp, f, dy * q or None); the sums of dp, dy (* q) and (with q) dy *
    resid written to ``part[:, col:col + 6C]``, by :func:`tile_sums` (one
    row: over every pixel)."""
    c = dy.shape[-1]
    rows = part.shape[0]
    pa, pb = p[..., :2 * c], p[..., 2 * c:]
    dp = torch.cat([df * wsilu_grad(pa), df * wsilu_grad(pb)], dim=-1)
    fr = (wsilu(pa) + wsilu(pb)).to(dy.dtype)
    dyf = dy.float()
    dyq = dyf * q if q is not None else None
    sums = [tile_sums(dp, rows),
            tile_sums(dyq if q is not None else dyf, rows),
            tile_sums(dyf * resid, rows) if q is not None
            else dyf.new_zeros(rows, c)]
    part[:, col:col + GATE_COLS * c] = torch.cat(sums, 1)
    return dp, fr, dyq


def dw_bwd_plain(dg, a0, taps, du, part, col):
    """da0 = dw3x3^T(dg) * wsilu'(a0); the sums of the tap gradient (9, C)
    (against h = wsilu(a0)), dg, da0 and du written to
    ``part[:, col:col + 12C]``, by :func:`tile_sums` (one row: over every
    pixel)."""
    c = dg.shape[-1]
    rows = part.shape[0]
    w = taps.t().reshape(c, 1, 3, 3)
    dgn, hn = dg.permute(0, 3, 1, 2), wsilu(a0).permute(0, 3, 1, 2)
    dh = F.conv_transpose2d(dgn, w, padding=1, groups=c)
    da0 = dh.permute(0, 2, 3, 1) * wsilu_grad(a0)
    # tap (i, j): dg(y, x) h(y + i - 1, x + j - 1), summed over pixels
    hp = F.pad(hn, (1, 1, 1, 1))
    hh, ww = dg.shape[1], dg.shape[2]
    prods = [dgn * hp[:, :, i:i + hh, j:j + ww]
             for i in range(3) for j in range(3)]
    if rows == 1:
        dtap = torch.cat([t.sum((0, 2, 3)) for t in prods])[None]
    else:
        dtap = torch.cat([tile_sums(t.permute(0, 2, 3, 1), rows)
                          for t in prods], 1)
    part[:, col:col + DW_COLS * c] = torch.cat(
        [dtap, tile_sums(dg, rows), tile_sums(da0, rows),
         tile_sums(du, rows)], 1)
    return da0


def grad_reduce_plain(part: torch.Tensor) -> torch.Tensor:
    return part.sum(0)


def grad_reduce_order(part: torch.Tensor) -> torch.Tensor:
    """``part.sum(0)`` with the kernel's additions in the kernel's order
    (fp32, one add at a time): what ``grad_reduce_cuda`` returns, bit for
    bit."""
    rows = part.float()
    while True:
        n = rows.shape[0]
        run = -(-min(n, RED_CHUNK) // RED_WARPS)
        sums = []
        for c0 in range(0, n, RED_CHUNK):
            c1 = min(c0 + RED_CHUNK, n)
            total = None
            for w in range(RED_WARPS):
                s = torch.zeros_like(rows[0])
                for r in range(c0 + w * run, min(c0 + (w + 1) * run, c1)):
                    s = s + rows[r]
                total = s if total is None else total + s
            sums.append(total)
        if len(sums) == 1:
            return sums[0]
        rows = torch.stack(sums)


# ------------------------------------------------------------------ kernels

def _lib() -> ctypes.CDLL:
    lib = _build.load("dcb_bwd")
    if lib.ssgvc_dw_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssgvc_dw_fwd.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.ssgvc_gate_bwd.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.ssgvc_dw_bwd.argtypes = [vp] * 6 + [i] * 7 + [vp]
        lib.ssgvc_grad_reduce.argtypes = [vp, vp, vp, i, i, vp]
        for fn in (lib.ssgvc_dw_fwd, lib.ssgvc_gate_bwd, lib.ssgvc_dw_bwd,
                   lib.ssgvc_grad_reduce):
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, t: Optional[torch.Tensor], dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> int:
    """The pointer of an operand the kernel takes as it is, or raise; 0 for
    an absent optional operand."""
    if t is None:
        return 0
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _launch(name: str, key: tuple, *args) -> None:
    lib = _lib()
    device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, f"ssgvc_{name}")(*args, stream)
    _build.check(lib, rc, f"{name} kernel")
    launches[name] += 1
    shape_launches[name, key] = shape_launches.get((name, key), 0) + 1


def _part_ptr(part: torch.Tensor, col: int, cols: int, rows: int) -> int:
    """The pointer of the partials' column ``col``, or raise unless ``part``
    is a contiguous fp32 (rows, >= col + cols) tensor."""
    if (part.dtype != torch.float32 or not part.is_contiguous()
            or part.shape[0] != rows or col + cols > part.shape[1]):
        raise ValueError(f"partials: expected a contiguous float32 ({rows}, "
                         f">= {col + cols}) tensor, got {part.dtype} "
                         f"{tuple(part.shape)}")
    return part.data_ptr() + 4 * col


def _act_dtype(what: str, dtype: torch.dtype) -> int:
    """1 for fp32, 0 for bf16 (the kernels' ``f32`` flag); raise for any
    other dtype."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: kernel takes bfloat16 or float32, got "
                        f"{dtype}")
    return int(dtype == torch.float32)


def dw_fwd_cuda(a0, taps, b2, out_dtype):
    b, hh, ww, c = shape = _bwd_shape("dw_fwd", a0)
    act = _act_dtype("dw_fwd", out_dtype)
    dev, f32 = a0.device, torch.float32
    with torch.cuda.device(dev):
        ptrs = [_check("dw_fwd a0", a0, f32, shape, dev),
                _check("dw_fwd taps", taps, f32, (9, c), dev),
                _check("dw_fwd b2", b2, f32, (c,), dev)]
        g = torch.empty(shape, dtype=out_dtype, device=dev)
        _aligned("dw_fwd", ptrs + [g.data_ptr()])
        th, tw, _ = bwd_tiles(shape)
        _launch("dw_fwd", shape, *ptrs, g.data_ptr(), b, hh, ww, c, th, tw,
                act)
    return g


def _bwd_shape(what: str, t: torch.Tensor) -> Tuple[int, int, int, int]:
    """The (B, H, W, C) of a tiled kernel's activation (dw_fwd's a0,
    gate_bwd's dy, dw_bwd's dg), or raise unless C is a multiple of
    WIDTH_STEP, as the forward kernels take it (these move 4 channels at a
    time; no other C runs)."""
    if t.dim() != 4 or t.shape[-1] % WIDTH_STEP:
        raise ValueError(f"{what}: kernel takes (B, H, W, C) with C a "
                         f"multiple of {WIDTH_STEP}, got {tuple(t.shape)}")
    return tuple(t.shape)


def _aligned(what: str, ptrs: Sequence[int]) -> None:
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{what}: kernel reads and writes 16 bytes at a "
                         "time: every operand must be 16-byte aligned")


def gate_bwd_cuda(df, p, dy, q, resid, part, col):
    b, hh, ww, c = shape = _bwd_shape("gate_bwd", dy)
    dev, f32 = dy.device, torch.float32
    act = _act_dtype("gate_bwd", dy.dtype)
    lead = shape[:-1]
    if q is not None and q.data_ptr() % 16:
        q = q.clone()                   # a small view off 16 bytes: copied
    with torch.cuda.device(dev):
        ptrs = [_check("gate_bwd df", df, f32, lead + (2 * c,), dev),
                _check("gate_bwd p", p, f32, lead + (4 * c,), dev),
                _check("gate_bwd dy", dy, dy.dtype, shape, dev),
                _check("gate_bwd q", q, f32, (c,), dev),
                _check("gate_bwd resid", resid, f32, shape, dev)]
        if (q is None) != (resid is None):
            raise ValueError("gate_bwd: q and resid go together")
        dp = torch.empty_like(p)
        fr = torch.empty(lead + (2 * c,), dtype=dy.dtype, device=dev)
        dyq = torch.empty(shape, dtype=f32, device=dev) if q is not None \
            else None
        outs = [dp.data_ptr(), fr.data_ptr(),
                0 if dyq is None else dyq.data_ptr()]
        _aligned("gate_bwd", ptrs + outs)
        th, tw, rows = bwd_tiles(shape)
        part_ptr = _part_ptr(part, col, GATE_COLS * c, rows)
        _launch("gate_bwd", shape + (q is not None,), *ptrs, *outs,
                part_ptr, part.shape[1], b, hh, ww, c, th, tw, act)
    return dp, fr, dyq


def dw_bwd_cuda(dg, a0, taps, du, part, col):
    b, hh, ww, c = shape = _bwd_shape("dw_bwd", dg)
    dev, f32 = dg.device, torch.float32
    with torch.cuda.device(dev):
        ptrs = [_check("dw_bwd dg", dg, f32, shape, dev),
                _check("dw_bwd a0", a0, f32, shape, dev),
                _check("dw_bwd taps", taps, f32, (9, c), dev),
                _check("dw_bwd du", du, f32, shape, dev)]
        da0 = torch.empty_like(dg)
        _aligned("dw_bwd", ptrs[:2] + [da0.data_ptr()])
        th, tw, rows = bwd_tiles(shape)
        part_ptr = _part_ptr(part, col, DW_COLS * c, rows)
        _launch("dw_bwd", shape, *ptrs, da0.data_ptr(), part_ptr,
                part.shape[1], b, hh, ww, c, th, tw)
    return da0


def grad_reduce_cuda(part):
    rows, k = part.shape
    if rows > RED_CHUNK * RED_CHUNK:
        raise ValueError(f"grad_reduce: {rows} rows, at most "
                         f"{RED_CHUNK * RED_CHUNK}")
    with torch.cuda.device(part.device):
        ptr = _check("grad_reduce part", part, torch.float32, (rows, k),
                     part.device)
        out = torch.empty(k, dtype=torch.float32, device=part.device)
        scratch = (torch.empty(-(-rows // RED_CHUNK), k, dtype=torch.float32,
                               device=part.device)
                   if rows > RED_CHUNK else out)
        _launch("grad_reduce", (rows, k), ptr, out.data_ptr(),
                scratch.data_ptr(), rows, k)
    return out


# ------------------------------------------------------- routes by device

def dw_fwd(a0, taps, b2, out_dtype):
    """Kernel (a), or its plain version for a CPU tensor."""
    if a0.device.type == "cpu":
        return dw_fwd_plain(a0, taps, b2, out_dtype)
    return dw_fwd_cuda(a0, taps, b2, out_dtype)


def gate_bwd(df, p, dy, q, resid, part, col):
    """Kernel (b), or its plain version for a CPU tensor."""
    if dy.device.type == "cpu":
        return gate_bwd_plain(df, p, dy, q, resid, part, col)
    return gate_bwd_cuda(df, p, dy, q, resid, part, col)


def dw_bwd(dg, a0, taps, du, part, col):
    """Kernel (c), or its plain version for a CPU tensor."""
    if dg.device.type == "cpu":
        return dw_bwd_plain(dg, a0, taps, du, part, col)
    return dw_bwd_cuda(dg, a0, taps, du, part, col)


def grad_reduce(part):
    """Kernel (d), or its plain version for a CPU tensor."""
    if part.device.type == "cpu":
        return grad_reduce_plain(part)
    return grad_reduce_cuda(part)


# ----------------------------------------------------------- the backward

def block_backward(x: torch.Tensor, params: Params,
                   q: Optional[torch.Tensor], shortcut: bool,
                   dy: torch.Tensor):
    """Gradients of one block's output (its kernel's forward) with respect
    to x, q and the ten params: (dx in x's dtype, dq (C,) fp32 or None,
    [ten fp32 gradients in the params' shapes])."""
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    cdt = x.dtype
    c = x.shape[-1]
    r = lambda t: t.detach().to(cdt).float()
    xf = x.detach().float()
    dy = dy.contiguous()
    W0, W3 = r(w0).reshape(c, c), r(w3).reshape(c, c)
    Wf0, Wf2 = r(wf0).reshape(4 * c, c), r(wf2).reshape(c, 2 * c)
    taps = r(w2).reshape(c, 9).t().contiguous()

    # recompute the block's intermediates
    a0 = F.linear(xf, W0, r(b0))
    g = dw_fwd(a0, taps, r(b2), cdt)
    gf = g.float()
    u = F.linear(gf, W3, r(b3)) + xf
    ur = u.to(cdt).float()
    p = F.linear(ur, Wf0, r(bf0))

    qf = r(q).reshape(c) if q is not None else None
    resid = None
    if qf is not None:
        resid = u + r(bf2)
        if shortcut:
            resid = resid + xf
    dyf = dy.float()
    # the FFN's output gradient, q folded into Wf2's rows
    df = F.linear(dyf, (Wf2 * qf[:, None] if qf is not None else Wf2).t())
    part = torch.empty(partial_rows(x), (GATE_COLS + DW_COLS) * c,
                       dtype=torch.float32, device=x.device)
    dp, fr, dyq = gate_bwd(df.contiguous(), p, dy, qf, resid, part, 0)
    dyp = dyq if dyq is not None else dyf          # gradient of y before q

    flat = lambda t: t.reshape(-1, t.shape[-1])
    G = flat(dyf).t() @ flat(fr.float())           # (C, 2C)
    dwf2 = G * qf[:, None] if qf is not None else G
    dwf0 = flat(dp).t() @ flat(ur)
    du = dyp + F.linear(dp, Wf0.t())
    dg = F.linear(du, W3.t())
    dw3 = flat(du).t() @ flat(gf)
    da0 = dw_bwd(dg.contiguous(), a0, taps, du.contiguous(), part,
                 GATE_COLS * c)
    dw0 = flat(da0).t() @ flat(xf)
    dx = du + F.linear(da0, W0.t())
    if shortcut:
        dx = dx + dyp

    sums = grad_reduce(part)
    s = lambda k, n: sums[k * c:(k + n) * c]
    dq = s(5, 1) + (Wf2 * G).sum(1) if qf is not None else None
    grads = [dw0.reshape(c, c, 1, 1), s(16, 1),
             s(6, 9).reshape(9, c).t().reshape(c, 1, 3, 3), s(15, 1),
             dw3.reshape(c, c, 1, 1), s(17, 1),
             dwf0.reshape(4 * c, c, 1, 1), s(0, 4),
             dwf2.reshape(c, 2 * c, 1, 1), s(4, 1)]
    return dx.to(cdt), dq, grads


class DCBFunction(torch.autograd.Function):
    """One block after its adaptor with a gradient: the forward is
    ``ops.dcb.dcb`` (the hand-written kernel on the card), the backward
    :func:`block_backward`. Inputs: x, q (or None), the packed weights (or
    None; not differentiable), shortcut, then the ten params."""

    @staticmethod
    def forward(ctx, x, q, packed, shortcut, *params):
        ctx.shortcut = shortcut
        ctx.save_for_backward(x, q, *params)
        return dcb(x, params, q, shortcut, packed=packed)

    @staticmethod
    def backward(ctx, dy):
        x, q, *params = ctx.saved_tensors
        dx, dq, grads = block_backward(x, params, q, ctx.shortcut, dy)
        if dq is not None:
            dq = dq.reshape(q.shape)
        return (dx, dq, None, None, *grads)


class DCBChainFunction(torch.autograd.Function):
    """N adaptor-free, shortcut-free blocks with a gradient: the forward is
    ``ops.dcb_chain.dcb_chain`` (one kernel launch on the card); the
    backward recomputes each block's input with N - 1 ``dcb`` launches,
    then runs the blocks' backwards in reverse. Inputs: x, q_last (or
    None), the chain's packed weights (or None), N, then the N x ten
    params."""

    @staticmethod
    def forward(ctx, x, q_last, packed, n, *flat):
        blocks = [flat[10 * j:10 * j + 10] for j in range(n)]
        ctx.n = n
        ctx.save_for_backward(x, q_last, packed, *flat)
        return dcb_chain(x, blocks, q_last, packed=packed)

    @staticmethod
    def backward(ctx, dy):
        x, q_last, packed, *flat = ctx.saved_tensors
        n = ctx.n
        blocks = [flat[10 * j:10 * j + 10] for j in range(n)]
        per = packed_numel(x.shape[-1], x.dtype)
        inputs: List[torch.Tensor] = [x]
        with torch.no_grad():
            for j in range(n - 1):
                pk = None if packed is None else packed[j * per:(j + 1) * per]
                inputs.append(dcb(inputs[-1], blocks[j], packed=pk))
        grads: List[Optional[torch.Tensor]] = [None] * (10 * n)
        dq = None
        for j in reversed(range(n)):
            q = q_last if j == n - 1 else None
            dy, dqj, g = block_backward(inputs[j], blocks[j], q, False, dy)
            grads[10 * j:10 * j + 10] = g
            if dqj is not None:
                dq = dqj.reshape(q_last.shape)
        return (dy, dq, None, None, *grads)


def dcb_grad(x: torch.Tensor, params: Sequence[torch.Tensor],
             q: Optional[torch.Tensor] = None, shortcut: bool = False,
             packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ops.dcb.dcb`` with a gradient (through :class:`DCBFunction`).
    Without grad mode (every inference path) ``dcb`` itself: a Function's
    bookkeeping costs host time on each of a frame's calls."""
    if not torch.is_grad_enabled():
        return dcb(x, params, q, shortcut, packed=packed)
    return DCBFunction.apply(x, q, packed, shortcut, *params)


def dcb_chain_grad(x: torch.Tensor, blocks: Sequence[Params],
                   q_last: Optional[torch.Tensor] = None,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ops.dcb_chain.dcb_chain`` with a gradient (through
    :class:`DCBChainFunction`); ``dcb_chain`` itself without grad mode."""
    if not torch.is_grad_enabled():
        return dcb_chain(x, blocks, q_last, packed=packed)
    flat = [p for params in blocks for p in params]
    return DCBChainFunction.apply(x, q_last, packed, len(blocks), *flat)
