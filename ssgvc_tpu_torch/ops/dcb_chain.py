"""N adaptor-free, shortcut-free DepthConvBlocks in one launch: the CUDA
kernel ``csrc/dcb_chain.cu``, its plain PyTorch version, and the plain
Python helpers that lay out the kernel's work (tile grid, window, buffer
plan, weight packing, shared-memory budget).

Each block computes what ``ops/dcb.py`` describes; each block's output is
rounded to the activation dtype before the next block reads it, and an
optional ``q_last`` multiplies the last block's output (the ``* quant_step``
that follows the encoder's chain).

The kernel is persistent: one cooperative launch per chain, whatever N.
For each block in turn, every thread block walks its share of the 8x8
output tiles, then the whole grid meets at a barrier, so the next block
reads a finished activation. Activations move between the caller's output
and one scratch tensor (:func:`buffer_plan`), both L2-resident at the main
path's sizes. A tile reads its input with a one-pixel halo
(:data:`WIN` x :data:`WIN` pixels) and recomputes dc_0 on it; nothing else
is recomputed. Products run on ``wgmma`` with the weights brought into
shared memory by bulk copies of slabs that :func:`pack_chain` has laid out
in wgmma's canonical operand layout, in the order the kernel consumes them.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from . import _build
from .dcb import (Params, check_input, check_operand, dcb_plain,
                  packed_numel, pack_params)

#: Kernel launches since the count was last set to 0.
launches = 0

# Must match csrc/dcb_chain.cu.
TILE = 8            # output tile side
WIN = TILE + 2      # input window side: the tile and a one-pixel halo
WIN_ROWS = 128      # window pixels padded to two 64-row wgmma tiles
KS_A = 64           # k columns of a W0 slab (stage A)
KS_B = 32           # k columns of a W3 / Wf0 / Wf2 slab (stage B)
KC = 64             # h channels per stage-A chunk
KF = 64             # hidden channels per FFN chunk
SH = KC + 4         # fp32 row stride of the h chunk
RING_A = 4          # W0 slab slots
RING_B = 4          # stage-B slab slots, in the window's bytes
BARRIER_BYTES = 256


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


def buffer_plan(n: int) -> List[Tuple[str, str]]:
    """(source, destination) of each block: 'x' the input (never written),
    'y' the caller's output, 's' the scratch tensor; the last block writes
    'y'. The kernel applies the same rule to pick its buffers."""
    dst = ["y" if (n - 1 - j) % 2 == 0 else "s" for j in range(n)]
    return [("x" if j == 0 else dst[j - 1], dst[j]) for j in range(n)]


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of one thread block, the same for every N.

    Stage A holds the window A tile (WIN_ROWS x C bf16), the fp32 h chunk,
    hb (64 x C bf16) and the W0 ring. In stage B the window is dead: its
    bytes hold the RING_B slots of W3 / Wf0 / Wf2 slabs (each at most
    C x KS_B bf16), hb is overwritten by uc, and the h chunk's bytes hold
    two f chunks (64 x KF bf16)."""
    window = WIN_ROWS * c * 2
    hchunk = max(WIN * WIN * SH * 4, 2 * TILE * TILE * KF * 2)
    hb = TILE * TILE * c * 2
    ring_a = RING_A * KS_A * KC * 2
    return window + hchunk + hb + ring_a + BARRIER_BYTES


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


def pack_block(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """One block's weights in the chain kernel's layout, rounded to
    ``dtype``: the slabs of :func:`slabs` back to back (8 C^2 elements),
    then the depthwise taps and biases as in :func:`~.dcb.pack_params`."""
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


def pack_chain(blocks: Sequence[Params], dtype: torch.dtype) -> torch.Tensor:
    """Every block's :func:`pack_block`, back to back: the kernel's one
    weight operand."""
    return torch.cat([pack_block(p, dtype) for p in blocks])


def unpack_block(flat: torch.Tensor, c: int) -> dict:
    """The four matrices ([out][in]) of one :func:`pack_block` tensor."""
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


def dcb_chain_plain(x: torch.Tensor, blocks: Sequence[Params],
                    q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the blocks in sequence."""
    for j, params in enumerate(blocks):
        x = dcb_plain(x, params, q_last if j == len(blocks) - 1 else None)
    return x


def _lib() -> ctypes.CDLL:
    lib = _build.load("dcb_chain")
    fn = lib.ssgvc_dcb_chain_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def dcb_chain_cuda(x: torch.Tensor, packed: torch.Tensor,
                   q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch for the whole chain: x (1, H, W, C) bf16 CUDA, ``packed``
    from :func:`pack_chain` (N blocks), q_last (C,) or None."""
    global launches
    check_input(x, "dcb_chain")
    _, h, w, c = x.shape
    n = packed.numel() // packed_numel(c)
    if n < 1:
        raise ValueError("dcb_chain: no blocks")
    check_operand(packed, x, n * packed_numel(c), "dcb_chain weights")
    if q_last is not None:
        q_last = q_last.reshape(-1)
        check_operand(q_last, x, c, "dcb_chain q_last")
    lib = _lib()
    y = torch.empty_like(x)
    scratch = torch.empty_like(x) if n > 1 else y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssgvc_dcb_chain_forward(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), packed.data_ptr(),
            None if q_last is None else q_last.data_ptr(), h, w, c, n, stream)
    _build.check(lib, rc, "dcb_chain kernel")
    launches += 1
    return y


def dcb_chain(x: torch.Tensor, blocks: Sequence[Params],
              q_last: Optional[torch.Tensor] = None,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chained blocks: the plain version for a CPU tensor, the kernel for a
    CUDA tensor. ``packed`` may carry the chain's cached
    :func:`pack_chain` output."""
    if x.device.type == "cpu":
        return dcb_chain_plain(x, blocks, q_last)
    if packed is None:
        packed = pack_chain(blocks, x.dtype)
    return dcb_chain_cuda(x, packed, q_last)

