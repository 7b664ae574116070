"""One DepthConvBlock after its adaptor: the CUDA kernel ``csrc/dcb.cu``, its
plain PyTorch version, and the plain Python helpers that lay out the work of
both DepthConvBlock kernels (tile grid, window, weight packing,
shared-memory budget); ``ops/dcb_chain.py`` uses them too.

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

:func:`dcb` routes by device and dtype: a CPU tensor takes
:func:`dcb_plain`; a CUDA tensor launches a kernel or raises. bfloat16
activations (B, H, W, C) go to the wgmma kernel ``csrc/dcb.cu``; any dtype
but bf16 and fp32 raises a ``TypeError``. float32 goes by width
(:func:`uses_tf32`): a block computed at CP >= :data:`TF32_MIN_CP` (C >= 72)
runs on the 3xTF32 wgmma kernel ``csrc/dcb_tf32.cu`` (:func:`dcb_tf32_cuda`,
weights from :func:`pack_tf32`, launches counted in
:data:`launches_tf32`), a narrower one on the SIMT fp32 kernel
``csrc/dcb_f32.cu`` (:func:`dcb_f32_cuda`, weights from :func:`pack_f32`,
:data:`launches_f32`), which is faster there and takes C up to
:data:`F32_MAX_CHANNELS` only; its work units (whole small images, or 8x8
tiles) are :func:`f32_plan` / :func:`f32_units`. Every other kernel takes
every C that is a multiple of 8 up to :data:`MAX_CHANNELS`
(:func:`check_width`).

Both kernels run one tile routine (``csrc/dcb_tile.cuh``) on 8x8 output
tiles. A tile reads its input with a one-pixel halo (:data:`WIN` x
:data:`WIN` pixels) and recomputes dc_0 on it. Products run on ``wgmma``
with the weights brought into shared memory by bulk copies of slabs that
:func:`pack_block` has laid out in wgmma's canonical operand layout, in the
order the kernel consumes them. The single-block kernel is a persistent
grid of one thread block per SM walking the B x tiles of a batch; a tile's
halo never reads a neighbouring image.

A block is computed at :func:`padded_channels` (C rounded up to a multiple
of 64, and 512 over 384: 368 runs at 384, 448 at 512). :func:`pack_block`
gives the padded channels zero weights and biases, so they stay exactly 0
and add nothing; the kernel reads and writes the frame at its real C. At C=512 the window and ring B
are cut to fit in shared memory (:func:`window_rows`, :func:`ring_b`); at a
computed width of 64 ring B has bytes of its own (:func:`ring_b_own`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

#: The widest block the single-block kernels take; every C that is a
#: multiple of :data:`WIDTH_STEP` up to it runs, computed at
#: :func:`padded_channels`.
MAX_CHANNELS = 512
WIDTH_STEP = 8      # the window's 16-byte copies: 8 bf16 channels
#: Dynamic shared memory one block may use on sm_90.
SMEM_LIMIT = 232448
#: Kernel launches since the count was last set to 0: the bf16 kernel's,
#: the SIMT fp32 kernel's and the 3xTF32 kernel's.
launches = 0
launches_f32 = 0
launches_tf32 = 0
#: The SIMT and the 3xTF32 fp32 kernels' launches by operand shape since
#: last cleared: (B, H, W, C, shortcut, q given) -> count.
shape_launches_f32: Dict[tuple, int] = {}
shape_launches_tf32: Dict[tuple, int] = {}

Params = Tuple[torch.Tensor, ...]   # (w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2)


def wsilu(x: torch.Tensor) -> torch.Tensor:
    """silu(4x)/4."""
    return F.silu(4.0 * x) * 0.25


def packed_numel(c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Elements of one block's packed weights for the card's ``dtype``
    kernel: :func:`pack_block` (at the computed width) for bf16; for fp32
    :func:`pack_tf32` (at the computed width) where :func:`uses_tf32`, else
    :func:`pack_f32` (at C)."""
    if dtype == torch.float32:
        return tf32_numel(c) if uses_tf32(c) else 8 * c * c + 17 * c
    cp = padded_channels(c)
    return 8 * cp * cp + 17 * cp


def pack_params(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """One block's weights flat, rounded to ``dtype``: W0 (C,C), W3 (C,C),
    Wf0 (4C,C), Wf2 (C,2C), each [out][in]; the depthwise taps (9,C); then
    b0, b2, b3 (C each), bf0 (4C), bf2 (C). :func:`pack_block` keeps its
    tail (taps and biases) and lays the matrices out for the kernels."""
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    c = w0.shape[0]
    with torch.no_grad():
        parts = (w0, w3, wf0, wf2, w2.reshape(c, 9).t(), b0, b2, b3, bf0, bf2)
        return torch.cat([p.reshape(-1) for p in parts]).to(dtype)


# The kernels' per-tile layout: must match csrc/dcb_tile.cuh.
TILE = 8            # output tile side
WIN = TILE + 2      # input window side: the tile and a one-pixel halo
WIN_ROWS = 128      # window pixels padded to two 64-row wgmma tiles
WIDE_WIN_ROWS = 104  # window rows held at C=512: 13 core-matrix groups
KS_A = 64           # k columns of a W0 slab (stage A)
KS_B = 32           # k columns of a W3 / Wf0 / Wf2 slab (stage B)
KC = 64             # h channels per stage-A chunk
KF = 64             # hidden channels per FFN chunk
SH = KC + 4         # fp32 row stride of the h chunk
RING_A = 4          # W0 slab slots
RING_B = 4          # stage-B slab slots, in the window's bytes
WIDE_RING_B = 3     # the same at C=512
BARRIER_BYTES = 256
HCHUNK = max(WIN * WIN * SH * 4, 2 * TILE * TILE * KF * 2)  # h / f chunks


def tile_grid(h: int, w: int) -> Tuple[int, int]:
    """Rows and columns of 8x8 output tiles over an h x w frame; the last
    row and column may be ragged."""
    return -(-h // TILE), -(-w // TILE)


def tile_origin(t: int, tiles_x: int) -> Tuple[int, int]:
    """Frame row and column of tile ``t``'s first output pixel (tiles in
    row-major order)."""
    return (t // tiles_x) * TILE, (t % tiles_x) * TILE


def window_pixel(r: int, y0: int, x0: int) -> Tuple[int, int]:
    """Frame coordinates of window row ``r`` (0 <= r < WIN * WIN) of the
    tile at (y0, x0): the window starts one pixel above and left of it."""
    return y0 - 1 + r // WIN, x0 - 1 + r % WIN


#: The widths a block is computed at: one kernel instance pair each.
COMPUTED_WIDTHS = (64, 128, 192, 256, 320, 384, 512)


def padded_channels(c: int) -> int:
    """The width a block of ``c`` channels is computed at, one of
    :data:`COMPUTED_WIDTHS` up to 512: ``c`` rounded up to a multiple of
    :data:`KC`, and 512 for every ``c`` from 392 to 512."""
    if COMPUTED_WIDTHS[-2] < c <= COMPUTED_WIDTHS[-1]:
        return COMPUTED_WIDTHS[-1]
    return -(-c // KC) * KC


def window_rows(c: int) -> int:
    """Window rows held in shared memory: two 64-row wgmma tiles, or at a
    computed width over 384, :data:`WIDE_WIN_ROWS` (the 100 window pixels;
    stage A's second tile then reads its rows 104-127 from hb's bytes, and
    their results are dropped)."""
    return WIN_ROWS if padded_channels(c) <= 384 else WIDE_WIN_ROWS


def ring_b(c: int) -> int:
    """Stage-B slab slots."""
    return RING_B if padded_channels(c) <= 384 else WIDE_RING_B


def slot_b(c: int) -> int:
    """Bytes of one ring-B slot: the larger of a CP x KS_B slab (W3, Wf2)
    and a 2 KF x KS_B one (Wf0)."""
    return max(KS_B * padded_channels(c) * 2, 2 * KF * KS_B * 2)


def ring_b_own(c: int) -> bool:
    """Whether ring B needs bytes of its own: its slots do not fit in the
    window's (only at a computed width of 64, where the window is 16 KiB
    and a slot must hold an 8 KiB Wf0 slab)."""
    return ring_b(c) * slot_b(c) > window_rows(c) * padded_channels(c) * 2


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of one thread block of either kernel, the same
    for every N.

    Stage A holds the window A tile (:func:`window_rows` x CP bf16), the
    fp32 h chunk, hb (64 x CP bf16) and the W0 ring. In stage B the window
    is dead: its bytes hold the :func:`ring_b` slots of W3 / Wf0 / Wf2
    slabs (unless :func:`ring_b_own`), hb is overwritten by uc, and the h
    chunk's bytes hold two f chunks (64 x KF bf16)."""
    cp = padded_channels(c)
    window = window_rows(c) * cp * 2
    hb = TILE * TILE * cp * 2
    ring_a = RING_A * KS_A * KC * 2
    own = ring_b(c) * slot_b(c) if ring_b_own(c) else 0
    return window + HCHUNK + hb + ring_a + own + BARRIER_BYTES


def canonical(m: torch.Tensor) -> torch.Tensor:
    """A (R, K) matrix, K contiguous, in wgmma's K-major no-swizzle layout:
    8x8 core matrices of 64 contiguous elements, K-adjacent ones next to
    each other, the 8-row groups outermost. Flat, R * K elements."""
    r, k = m.shape
    return m.reshape(r // 8, 8, k // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def decanonical(flat: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """Inverse of :func:`canonical`."""
    return flat.reshape(r // 8, k // 8, 8, 8).permute(0, 2, 1, 3).reshape(r, k)


def ffn_rows(c: int, f0: int) -> List[int]:
    """Wf0 rows of the FFN slab for hidden chunk ``f0``: for each consumer
    warpgroup in turn, its KF/2 columns of half a, then the same of half b,
    so that one N=64 product gives a warpgroup matching a and b columns."""
    half = KF // 2
    rows = []
    for g in range(2):
        base = f0 + g * half
        rows += list(range(base, base + half))
        rows += list(range(2 * c + base, 2 * c + base + half))
    return rows


def slabs(c: int) -> Iterator[Tuple[str, int, int, int, int]]:
    """The weight slabs of one block in stream order: (matrix, first row,
    row count, first k, k count), each a (rows, k count) canonical tile.
    Wf0 slabs take their rows through :func:`ffn_rows`."""
    for c0 in range(0, c, KC):
        for k0 in range(0, c, KS_A):
            yield "w0", c0, KC, k0, KS_A
    for k0 in range(0, c, KS_B):
        yield "w3", 0, c, k0, KS_B
    for f0 in range(0, 2 * c, KF):
        for k0 in range(0, c, KS_B):
            yield "wf0", f0, 2 * KF, k0, KS_B
        for k0 in range(f0, f0 + KF, KS_B):
            yield "wf2", 0, c, k0, KS_B


def _matrices(params: Params):
    w0, _, _, _, w3, _, wf0, _, wf2, _ = params
    c = w0.shape[0]
    return {"w0": w0.reshape(c, c), "w3": w3.reshape(c, c),
            "wf0": wf0.reshape(4 * c, c), "wf2": wf2.reshape(c, 2 * c)}


def pad_params(params: Params, cp: int) -> Params:
    """One block's params widened from C to ``cp`` channels with zeros, as
    the kernels compute it: every padded weight and bias is 0, and the 4C
    hidden rows of Wf0 keep their two halves apart (half a at rows
    [0, 2C), half b at [2 cp, 2 cp + 2C)), so the padded channels of h, u,
    f and y stay exactly 0."""
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    c = w0.shape[0]
    p = cp - c
    if p == 0:
        return params
    with torch.no_grad():
        halves = lambda t: torch.cat([F.pad(h, (0, 0) * (t.dim() - 1)
                                            + (0, 2 * p))
                                      for h in t.split(2 * c)])
        wf0 = halves(F.pad(wf0, (0, 0, 0, 0, 0, p)))
        return (F.pad(w0, (0, 0, 0, 0, 0, p, 0, p)), F.pad(b0, (0, p)),
                F.pad(w2, (0, 0, 0, 0, 0, 0, 0, p)), F.pad(b2, (0, p)),
                F.pad(w3, (0, 0, 0, 0, 0, p, 0, p)), F.pad(b3, (0, p)),
                wf0, halves(bf0),
                F.pad(wf2, (0, 0, 0, 0, 0, 2 * p, 0, p)), F.pad(bf2, (0, p)))


def pack_block(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """One block's weights in the kernels' layout, rounded to ``dtype``, at
    the computed width CP (:func:`pad_params`): the slabs of :func:`slabs`
    back to back (8 CP^2 elements), then the depthwise taps and biases as
    in :func:`pack_params`."""
    params = pad_params(params, padded_channels(params[0].shape[0]))
    c = params[0].shape[0]
    with torch.no_grad():
        mats = _matrices(params)
        parts = []
        for name, r0, rows, k0, ks in slabs(c):
            m = mats[name]
            sel = (m[ffn_rows(c, r0)] if name == "wf0"
                   else m[r0:r0 + rows])
            parts.append(canonical(sel[:, k0:k0 + ks]))
        flat = torch.cat(parts + [pack_params(params, dtype)[8 * c * c:]
                                  .to(parts[0].dtype)])
        return flat.to(dtype)


def pack_f32(params: Params) -> torch.Tensor:
    """One block's weights for the SIMT fp32 kernel (``csrc/dcb_f32.cu``),
    at C: the four matrices transposed ([in][out], so that a thread's four
    output channels are one float4), then the taps and biases as in
    :func:`pack_params`. 8 C^2 + 17 C floats; the kernel copies them into
    shared memory in :data:`F32_GROUPS`."""
    c = params[0].shape[0]
    w0, _, _, _, w3, _, wf0, _, wf2, _ = params
    with torch.no_grad():
        mats = [m[:, :, 0, 0].float().t().reshape(-1)
                for m in (w0, w3, wf0, wf2)]
        return torch.cat(mats + [pack_params(params, torch.float32)
                                 [8 * c * c:]]).contiguous()


# The SIMT fp32 kernel's plan: must match csrc/dcb_f32.cu.
#: The widest block the SIMT fp32 kernel takes (wider ones run on 3xTF32).
F32_MAX_CHANNELS = 64
F32_THREADS = 256
F32_PMAX = 64            # output pixels of a unit
F32_PCTA = 16            # least of them a cluster's CTA takes
F32_MAX_CS = 4           # CTAs a unit of whole images spans
F32_TILE = (8, 8)        # a tile unit's outputs
F32_RP = 8               # pixels of a thread's product tile
F32_LDQ = 104            # window pixels a unit holds: (8 + 2)^2 rounded to 8
F32_LDP = 68             # row stride of g and f: F32_PMAX + 4
F32_GROUPS = 5           # weight groups, one mbarrier each


def f32_ksplit(c: int) -> int:
    """K segments of every product of the SIMT kernel at ``c`` channels: a
    function of C alone, so every sum runs in one order whatever the batch,
    the plan or the grid (256 threads over a 64-pixel unit's 8x8 tiles at
    C = 32 and 64; below 32 more segments, for shorter serial chains)."""
    return 8 if c <= 32 else 4


def f32_groups(c: int) -> List[List[Tuple[int, int]]]:
    """The SIMT kernel's weight groups in the order it waits for them, each
    a matrix and its bias as (offset, floats) spans of one :func:`pack_f32`
    block (``group_span`` in csrc/dcb_f32.cu): W0 + b0, the taps + b2, W3 +
    b3, Wf0 + bf0, Wf2 + bf2. Each lands at the same offset in shared
    memory, one bulk copy per span."""
    cc, t = c * c, 8 * c * c          # t: the taps, then the biases
    return [[(0, cc), (t + 9 * c, c)], [(t, 9 * c), (t + 10 * c, c)],
            [(cc, cc), (t + 11 * c, c)], [(2 * cc, 4 * cc), (t + 12 * c, 4 * c)],
            [(6 * cc, 2 * cc), (t + 16 * c, c)]]


def f32_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one SIMT thread block: the weights (8 C^2 +
    17 C floats), the input window and h / u (C x :data:`F32_LDQ` floats
    each), g / f (2C x :data:`F32_LDP`), the unit's tables (:data:`F32_LDQ`
    + 11 :data:`F32_PMAX` ints: window pixels, output slots and pixels, the
    3x3 neighbours) and the mbarriers."""
    floats = 8 * c * c + 17 * c + 2 * c * F32_LDQ + 2 * c * F32_LDP
    return 4 * floats + 4 * (F32_LDQ + 11 * F32_PMAX) + 8 * F32_GROUPS


class F32Plan(NamedTuple):
    """The SIMT kernel's work units for a (B, H, W) batch (``make_plan``
    in csrc/dcb_f32.cu, field for field)."""
    b: int
    h: int
    w: int
    whole: int     # 1: units of g whole images; 0: tiles
    g: int         # images per unit (whole), else 1
    cs: int        # CTAs per unit (a cluster; whole), else 1
    th: int        # outputs per window: the image, or the tile
    tw: int
    tiles_x: int   # tile columns per image (tiles), else 1
    tiles: int     # tiles per image (tiles), else 1
    units: int
    ww: int        # window row stride in slots
    q: int         # window slots per CTA (a multiple of F32_RP)
    p: int         # outputs per CTA (a multiple of F32_RP)


def f32_plan(b: int, h: int, w: int) -> F32Plan:
    """Units of at most :data:`F32_PMAX` output pixels. An image that fits
    one is never cut: a unit holds as many whole images as fit (``g``, up
    to 64 at 1x1; the last unit may hold fewer), a chain (n > 1) runs every
    block on them in shared memory, and the unit spans a cluster of ``cs``
    CTAs (1, 2 or 4, at least :data:`F32_PCTA` pixels each; CTA r takes the
    unit's pixels [r p, (r + 1) p) in image, row, column order, h crossing
    between them through distributed shared memory). Larger images are cut
    into :data:`F32_TILE` output tiles with a one-pixel halo (zero outside
    the image), one CTA each. The same plan serves one block and a chain."""
    rnd = lambda v: -(-v // F32_RP) * F32_RP
    if h * w <= F32_PMAX:
        g = min(F32_PMAX // (h * w), b)
        px = g * h * w
        cs = (F32_MAX_CS if px >= F32_MAX_CS * F32_PCTA
              else 2 if px >= 2 * F32_PCTA else 1)
        q = rnd(-(-px // cs))
        return F32Plan(b, h, w, 1, g, cs, h, w, 1, 1, -(-b // g), w, q, q)
    th, tw = F32_TILE
    tiles_x = -(-w // tw)
    tiles = -(-h // th) * tiles_x
    return F32Plan(b, h, w, 0, 1, 1, th, tw, tiles_x, tiles, b * tiles,
                   tw + 2, rnd((th + 2) * (tw + 2)), th * tw)


def f32_units(b: int, h: int, w: int, c: int) -> dict:
    """The SIMT kernel's work for a (B, H, W, C) batch, as
    ``setup_unit`` in csrc/dcb_f32.cu lays it out: ``plan``
    (:func:`f32_plan`), ``ksplit`` (:func:`f32_ksplit`; the plan itself is
    the same at every C), and ``units``: per unit, per CTA of its cluster,
    ``slots`` (per window slot, the pixel of the (B H W) stack whose input
    it holds, or -1: h is 0 there) and ``outputs`` (per output: its window
    slot, its pixel or -1 where nothing is stored, and per 3x3 tap t the
    CTA and slot whose h it reads, ``rank << 8 | slot``, or -1 for a zero
    past the image's edge)."""
    check_width(c, F32_MAX_CHANNELS, "f32_units")
    pl = f32_plan(b, h, w)
    units = []
    for u in range(pl.units):
        ctas = []
        for rank in range(pl.cs):
            if pl.whole:
                hw, b0, first = h * w, u * pl.g, rank * pl.p
                real = min(pl.g, b - b0) * hw
                slots = [b0 * hw + first + i if first + i < real else -1
                         for i in range(pl.p)]
                outputs = []
                for i in range(pl.p):
                    at = first + i
                    nbrs = []
                    for t in range(9):
                        r = at % hw // w + t // 3 - 1
                        col = at % w + t % 3 - 1
                        nb = at + (t // 3 - 1) * w + t % 3 - 1
                        nbrs.append(nb // pl.p << 8 | nb % pl.p
                                    if at < real and 0 <= r < h
                                    and 0 <= col < w else -1)
                    outputs.append((i, slots[i], tuple(nbrs)))
            else:
                img, tt = divmod(u, pl.tiles)
                ty0 = tt // pl.tiles_x * pl.th
                tx0 = tt % pl.tiles_x * pl.tw
                slots = []
                for i in range(pl.q):
                    gy, gx = ty0 - 1 + i // pl.ww, tx0 - 1 + i % pl.ww
                    slots.append((img * h + gy) * w + gx
                                 if i < (pl.th + 2) * pl.ww and 0 <= gy < h
                                 and 0 <= gx < w else -1)
                outputs = []
                for i in range(pl.p):
                    r, col = divmod(i, pl.tw)
                    gy, gx = ty0 + r, tx0 + col
                    nbrs = tuple((r + t // 3) * pl.ww + col + t % 3
                                 for t in range(9))
                    outputs.append(((r + 1) * pl.ww + col + 1,
                                    (img * h + gy) * w + gx
                                    if gy < h and gx < w else -1, nbrs))
            ctas.append(dict(slots=slots, outputs=outputs))
        units.append(ctas)
    return dict(plan=pl, ksplit=f32_ksplit(c), units=units)


# The 3xTF32 kernel's layout: must match csrc/dcb_tf32.cu.
#: fp32 blocks computed at this width or wider run on the 3xTF32 kernel.
TF32_MIN_CP = 128
T_NPIX = TILE * TILE       # output pixels of a tile: one m64 A tile
T_NWIN = WIN * WIN         # window pixels: rows [0, 100) of two m64 tiles
T_KC = 64                  # h channels per stage-A chunk
T_KF = 64                  # hidden channels per FFN chunk
T_HS = T_KC + 4            # fp32 row stride of the h chunk
T_XBUF = 2 * T_NPIX * T_KF * 4   # the h chunk or two f chunks
T_MAX_SLOTS = 8


def uses_tf32(c: int) -> bool:
    """Whether an fp32 block of ``c`` channels runs on the 3xTF32 kernel
    (computed at CP >= :data:`TF32_MIN_CP`) rather than the SIMT one."""
    return padded_channels(c) >= TF32_MIN_CP


def tf32_width(c: int) -> int:
    """The width the 3xTF32 kernel computes a block of ``c`` channels at:
    :func:`padded_channels`, and at least :data:`TF32_MIN_CP` (narrower
    blocks route to the SIMT kernel, but the 3xTF32 one takes them too)."""
    return max(TF32_MIN_CP, padded_channels(c))


def tf32_numel(c: int) -> int:
    """Elements of one block's :func:`pack_tf32` weights."""
    cp = tf32_width(c)
    return 16 * cp * cp + 17 * cp


def tf32_slot_bytes(c: int) -> int:
    """Bytes of one ring slot: 16 KiB, 12 KiB at CP = 192 and 384, 10 KiB
    at 320 (whole k8 steps of a W3 / Wf2 slab, 32 CP bytes each, and of a
    W0 / Wf0 slab, 4 KiB each)."""
    cp = tf32_width(c)
    return {192: 12288, 384: 12288, 320: 10240}.get(cp, 16384)


def _pow2_floor(v: int) -> int:
    return 4 if v >= 4 else 2 if v >= 2 else 1


def tf32_sps(c: int) -> Tuple[int, int]:
    """k8 steps per slab: (W0 / Wf0, 64 rows; W3 / Wf2, CP/2 rows)."""
    slot = tf32_slot_bytes(c)
    return (_pow2_floor(slot // 4096),
            _pow2_floor(slot // (32 * tf32_width(c))))


def tf32_slots(c: int) -> int:
    """Slots of each warpgroup's ring: as many as fit, at most 8."""
    cp = tf32_width(c)
    free = SMEM_LIMIT - T_NPIX * cp * 4 - T_XBUF - BARRIER_BYTES
    return min(T_MAX_SLOTS, free // (2 * tf32_slot_bytes(c)))


def tf32_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one thread block of the 3xTF32 kernel: act
    (64 x CP fp32: g, then u), the h chunk or two f chunks, two rings of
    :func:`tf32_slots` slots, the mbarriers."""
    cp = tf32_width(c)
    return (T_NPIX * cp * 4 + T_XBUF
            + 2 * tf32_slots(c) * tf32_slot_bytes(c) + BARRIER_BYTES)


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to tf32 (10 mantissa bits; to nearest, ties away
    from zero), in an fp32 container with the low 13 bits 0."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = rna_tf32(t), lo = rna_tf32(t - hi); hi + lo is within
    2^-22 |t| of t."""
    hi = rna_tf32(t)
    return hi, rna_tf32(t.float() - hi)


def tf32_k_order(k: int) -> torch.Tensor:
    """The channel of each of the kernel's k positions over ``k`` (a
    multiple of 16): in k8 step s of a k16 block, logical column kl holds
    channel 4 (kl % 4) + 2 s + kl // 4 of the block, so that a thread's
    two steps of one A row are one float4."""
    kl = torch.arange(8)
    step = torch.cat([4 * (kl % 4) + 2 * s + kl // 4 for s in (0, 1)])
    return (torch.arange(0, k, 16)[:, None] + step).reshape(-1)


def tf32_steps(m: torch.Tensor) -> torch.Tensor:
    """The B operand of a (R, K) matrix (output rows, K contiguous) for the
    3xTF32 kernel: per k8 step, hi then lo, each (R, 8) in wgmma's
    canonical K-major layout (8x4 core matrices of 32 contiguous floats,
    K-adjacent ones 128 bytes apart, 8-row groups 256 bytes apart). Flat,
    K/8 x 2 x 8 R floats."""
    r, k = m.shape
    mp = m.float()[:, tf32_k_order(k)].reshape(r // 8, 8, k // 8, 2, 4)
    hi, lo = tf32_split(mp)
    both = torch.stack([hi, lo])           # (2, R/8, 8, K/8, 2, 4)
    return both.permute(3, 0, 1, 4, 2, 5).reshape(-1)


def tf32_unsteps(flat: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """Inverse of :func:`tf32_steps` up to the split: hi + lo, (R, K)."""
    both = flat.reshape(k // 8, 2, r // 8, 2, 8, 4).permute(1, 2, 4, 0, 3, 5)
    mp = (both[0] + both[1]).reshape(r, k)
    out = torch.empty_like(mp)
    out[:, tf32_k_order(k)] = mp
    return out


def tf32_pieces(c: int) -> Iterator[Tuple[str, List[int], int, int]]:
    """The matrices of one block in :func:`pack_tf32`'s order, at the
    computed width CP: (matrix, rows, first k, k count), each packed by
    :func:`tf32_steps`. W0 in chunks of 64 h channels (both warpgroups
    stream it); then per warpgroup g: W3's rows of its CP/2 outputs, and per
    FFN chunk of 64 hidden channels its Wf0 rows (:func:`ffn_rows`: 32 of
    half a, 32 of half b) and Wf2's rows of its outputs over the chunk."""
    cp = tf32_width(c)
    half = cp // 2
    for c0 in range(0, cp, T_KC):
        yield "w0", list(range(c0, c0 + T_KC)), 0, cp
    for g in range(2):
        outs = list(range(g * half, (g + 1) * half))
        yield "w3", outs, 0, cp
        for f0 in range(0, 2 * cp, T_KF):
            yield "wf0", ffn_rows(cp, f0)[T_KF * g:T_KF * (g + 1)], 0, cp
            yield "wf2", outs, f0, T_KF


def pack_tf32(params: Params) -> torch.Tensor:
    """One block's weights for the 3xTF32 kernel (``csrc/dcb_tf32.cu``), at
    the computed width CP (:func:`pad_params`): the pieces of
    :func:`tf32_pieces` back to back, each split hi / lo by
    :func:`tf32_steps` (16 CP^2 floats), then the taps and biases as in
    :func:`pack_params`. 16 CP^2 + 17 CP floats."""
    params = pad_params(params, tf32_width(params[0].shape[0]))
    cp = params[0].shape[0]
    with torch.no_grad():
        mats = _matrices(params)
        parts = [tf32_steps(mats[name][rows][:, k0:k0 + ks])
                 for name, rows, k0, ks in tf32_pieces(cp)]
        return torch.cat(parts + [pack_params(params, torch.float32)
                                  [8 * cp * cp:]]).contiguous()


def unpack_tf32(flat: torch.Tensor, c: int) -> dict:
    """The four matrices ([out][in], hi + lo) of one :func:`pack_tf32`
    tensor, at the computed width."""
    cp = tf32_width(c)
    mats = {"w0": flat.new_zeros(cp, cp), "w3": flat.new_zeros(cp, cp),
            "wf0": flat.new_zeros(4 * cp, cp),
            "wf2": flat.new_zeros(cp, 2 * cp)}
    off = 0
    for name, rows, k0, ks in tf32_pieces(cp):
        n = 2 * len(rows) * ks
        mats[name][rows, k0:k0 + ks] = tf32_unsteps(flat[off:off + n],
                                                    len(rows), ks)
        off += n
    return mats


def tf32_stream(c: int, g: int) -> List[Tuple[int, int]]:
    """(byte offset in the block's packed weights, bytes) of each slab
    warpgroup ``g`` streams for one tile, in order: the arithmetic of
    ``Stream::src`` in csrc/dcb_tf32.cu."""
    cp = tf32_width(c)
    (sa, sb), ks = tf32_sps(c), cp // 8
    a_bytes, b_bytes = 4096 * sa, 32 * cp * sb
    w0_bytes, wg_bytes = 8 * cp * cp, 28 * cp * cp
    out = [(i * a_bytes, a_bytes) for i in range(cp // T_KC * ks // sa)]
    wg = w0_bytes + g * wg_bytes
    out += [(wg + i * b_bytes, b_bytes) for i in range(ks // sb)]
    for chunk in range(2 * cp // T_KF):
        cb = wg + ks * 32 * cp + chunk * 768 * cp
        out += [(cb + r * a_bytes, a_bytes) for r in range(ks // sa)]
        out += [(cb + 512 * cp + r * b_bytes, b_bytes)
                for r in range(8 // sb)]
    return out


def pack_kernel(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """One block's weights as the card's kernel for ``dtype`` activations
    takes them: for fp32 :func:`pack_tf32` where :func:`uses_tf32`, else
    :func:`pack_f32`; :func:`pack_block` (the bf16 kernel's layout)
    otherwise."""
    if dtype == torch.float32:
        return pack_tf32(params) if uses_tf32(params[0].shape[0]) \
            else pack_f32(params)
    return pack_block(params, dtype)


def unpack_block(flat: torch.Tensor, c: int) -> dict:
    """The four matrices ([out][in]) of one :func:`pack_block` tensor of a
    block of ``c`` channels, at its computed width."""
    c = padded_channels(c)
    mats = {"w0": flat.new_empty(c, c), "w3": flat.new_empty(c, c),
            "wf0": flat.new_empty(4 * c, c), "wf2": flat.new_empty(c, 2 * c)}
    off = 0
    for name, r0, rows, k0, ks in slabs(c):
        tile = decanonical(flat[off:off + rows * ks], rows, ks)
        off += rows * ks
        if name == "wf0":
            mats[name][ffn_rows(c, r0), k0:k0 + ks] = tile
        else:
            mats[name][r0:r0 + rows, k0:k0 + ks] = tile
    return mats


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


#: Activation dtypes the card's kernels take: bf16 (wgmma), fp32 (3xTF32
#: wgmma or SIMT, by width).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_width(c: int, max_c: int, what: str) -> None:
    """The kernels' width rule: C a multiple of :data:`WIDTH_STEP` from 8
    to ``max_c``; raise a ``ValueError`` otherwise."""
    if not (WIDTH_STEP <= c <= max_c and c % WIDTH_STEP == 0):
        raise ValueError(f"{what}: C={c} is not a multiple of {WIDTH_STEP} "
                         f"from {WIDTH_STEP} to {max_c}")


def check_input(x: torch.Tensor, what: str, max_c: int,
                dtype: torch.dtype) -> None:
    """Raise unless ``x`` is what a kernel takes: a contiguous CUDA (B, H,
    W, C) tensor of the kernel's ``dtype`` (a ``TypeError`` otherwise), C by
    :func:`check_width`."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{what}: kernel takes {dtype}, got {x.dtype} (the "
                        f"card's kernels take {KERNEL_DTYPES})")
    if x.dim() != 4 or x.shape[0] < 1:
        raise ValueError(f"{what}: kernel takes (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    check_width(x.shape[-1], max_c, what)
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


def q_operand(q: Optional[torch.Tensor], x: torch.Tensor, what: str):
    """(q, its pointer) for a kernel, or (None, None): the kernels read q in
    pairs of channels, so a view that starts off a 4-byte boundary is
    copied."""
    if q is None:
        return None, None
    q = q.reshape(-1)
    check_operand(q, x, x.shape[-1], f"{what} q")
    if q.data_ptr() % 4:
        q = q.clone()
    return q, q.data_ptr()


def _lib() -> ctypes.CDLL:
    lib = _build.load("dcb")
    fn = lib.ssgvc_dcb_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def _lib_f32(tf32: bool) -> ctypes.CDLL:
    """The fp32 kernel's library: csrc/dcb_tf32.cu or csrc/dcb_f32.cu."""
    name = "dcb_tf32" if tf32 else "dcb_f32"
    lib = _build.load(name)
    fn = getattr(lib, f"ssgvc_{name}_forward")
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def launch_f32(x: torch.Tensor, y: torch.Tensor, scratch: torch.Tensor,
               packed: torch.Tensor, q_ptr, n: int, shortcut: bool,
               what: str, tf32: bool = False) -> None:
    """One launch of ``csrc/dcb_tf32.cu`` (``tf32``) or ``csrc/dcb_f32.cu``
    on checked operands: n blocks from x to y, ``scratch`` the chain's other
    buffer where the kernel takes the cooperative path (3xTF32 for n > 1;
    the SIMT kernel for n > 1 on tile units only)."""
    b, h, w, c = x.shape
    if tf32 and (x.data_ptr() | y.data_ptr() | scratch.data_ptr()
                 | packed.data_ptr()) % 16:
        raise ValueError(f"{what}: the 3xTF32 kernel reads and copies in 16 "
                         "bytes: x, y and the weights must be 16-byte "
                         "aligned")
    if not tf32 and packed.data_ptr() % 16:
        raise ValueError(f"{what}: the SIMT kernel copies its weights in 16 "
                         "bytes: they must be 16-byte aligned")
    lib = _lib_f32(tf32)
    fn = lib.ssgvc_dcb_tf32_forward if tf32 else lib.ssgvc_dcb_f32_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                packed.data_ptr(), q_ptr, b, h, w, c, n, int(bool(shortcut)),
                stream)
    _build.check(lib, rc, f"{what} kernel")


def dcb_f32_cuda(x: torch.Tensor, packed: torch.Tensor,
                 q: Optional[torch.Tensor] = None,
                 shortcut: bool = False) -> torch.Tensor:
    """Launch the SIMT fp32 kernel: x (B, H, W, C) fp32 CUDA, C a multiple
    of 8 up to :data:`F32_MAX_CHANNELS` (a ``ValueError`` above),
    ``packed`` from :func:`pack_f32`, q (C,) or None. Returns a new (B, H,
    W, C)."""
    global launches_f32
    check_input(x, "dcb_f32", F32_MAX_CHANNELS, torch.float32)
    c = x.shape[-1]
    check_operand(packed, x, 8 * c * c + 17 * c, "dcb_f32 weights")
    q, q_ptr = q_operand(q, x, "dcb_f32")
    y = torch.empty_like(x)
    launch_f32(x, y, y, packed, q_ptr, 1, shortcut, "dcb_f32")
    launches_f32 += 1
    key = (*x.shape, bool(shortcut), q is not None)
    shape_launches_f32[key] = shape_launches_f32.get(key, 0) + 1
    return y


def dcb_tf32_cuda(x: torch.Tensor, packed: torch.Tensor,
                  q: Optional[torch.Tensor] = None,
                  shortcut: bool = False) -> torch.Tensor:
    """Launch the 3xTF32 kernel: x (B, H, W, C) fp32 CUDA, any C the
    kernels take (:func:`dcb` sends it C >= 72), ``packed`` from
    :func:`pack_tf32`, q (C,) or None. Returns a new (B, H, W, C)."""
    global launches_tf32
    check_input(x, "dcb_tf32", MAX_CHANNELS, torch.float32)
    c = x.shape[-1]
    check_operand(packed, x, tf32_numel(c), "dcb_tf32 weights")
    q, q_ptr = q_operand(q, x, "dcb_tf32")
    y = torch.empty_like(x)
    launch_f32(x, y, y, packed, q_ptr, 1, shortcut, "dcb_tf32", tf32=True)
    launches_tf32 += 1
    key = (*x.shape, bool(shortcut), q is not None)
    shape_launches_tf32[key] = shape_launches_tf32.get(key, 0) + 1
    return y


def dcb_cuda(x: torch.Tensor, packed: torch.Tensor,
             q: Optional[torch.Tensor] = None,
             shortcut: bool = False) -> torch.Tensor:
    """Launch the bf16 kernel: x (B, H, W, C) bf16 CUDA, ``packed`` from
    :func:`pack_block`, q (C,) or None. Returns a new (B, H, W, C)."""
    global launches
    check_input(x, "dcb", MAX_CHANNELS, torch.bfloat16)
    b, h, w, c = x.shape
    check_operand(packed, x, packed_numel(c, x.dtype), "dcb weights")
    q, q_ptr = q_operand(q, x, "dcb")
    lib = _lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssgvc_dcb_forward(
            x.data_ptr(), y.data_ptr(), packed.data_ptr(), q_ptr, b, h, w,
            c, int(bool(shortcut)), stream)
    _build.check(lib, rc, "dcb kernel")
    launches += 1
    return y


def dcb(x: torch.Tensor, params: Params, q: Optional[torch.Tensor] = None,
        shortcut: bool = False,
        packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block after its adaptor: the plain version for a CPU tensor; for
    a CUDA tensor in float32 the 3xTF32 kernel where :func:`uses_tf32`,
    else the SIMT one; otherwise the bf16 kernel (which refuses any other
    dtype). ``packed`` may carry cached :func:`pack_kernel` output."""
    if x.device.type == "cpu":
        return dcb_plain(x, params, q, shortcut)
    if packed is None:
        packed = pack_kernel(params, x.dtype)
    if x.dtype == torch.float32:
        if uses_tf32(x.shape[-1]):
            return dcb_tf32_cuda(x, packed, q, shortcut)
        return dcb_f32_cuda(x, packed, q, shortcut)
    return dcb_cuda(x, packed, q, shortcut)
