"""N adaptor-free, shortcut-free DepthConvBlocks in one launch: the CUDA
kernel ``csrc/dcb_chain.cu``, its plain PyTorch version, its buffer plan
and its weight packing. The per-tile layout (tile grid, window, slab
packing, shared-memory budget) is the single-block kernel's, in
``ops/dcb.py``.

Each block computes what ``ops/dcb.py`` describes; each block's output is
rounded to the activation dtype before the next block reads it, and an
optional ``q_last`` multiplies the last block's output (the ``* quant_step``
that follows the encoder's chain).

The kernel is persistent: one cooperative launch per chain, whatever N
and B. For each block in turn, every thread block walks its share of the
B x 8x8 output tiles, then the whole grid meets at a barrier, so the next
block reads a finished activation. Activations move between the caller's
output and one scratch tensor (:func:`buffer_plan`), both L2-resident at
the main path's sizes. A tile reads its input with a one-pixel halo
(:data:`WIN` x :data:`WIN` pixels) and recomputes dc_0 on it; nothing else
is recomputed. Each tile runs the single-block kernel's tile routine
(``csrc/dcb_tile.cuh``) on the block's slabs from :func:`pack_chain`.

:func:`dcb_chain` routes by device, dtype and width as ``ops.dcb.dcb``
does: a bfloat16 CUDA tensor to ``csrc/dcb_chain.cu``; a float32 one, one
launch per chain too, to the 3xTF32 kernel
``csrc/dcb_tf32.cu`` where ``ops.dcb.uses_tf32`` (:func:`dcb_chain_tf32_cuda`)
and to the SIMT kernel ``csrc/dcb_f32.cu`` below it
(:func:`dcb_chain_f32_cuda`: on units of whole small images it runs the
whole chain in each thread block's shared memory, a plain launch with no
scratch tensor; see :func:`buffer_plan`); any other dtype raises. All take
every C that is a multiple of 8 up to :data:`MAX_CHANNELS`, the SIMT one
up to ``ops.dcb.F32_MAX_CHANNELS``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from .dcb import (F32_MAX_CHANNELS, Params, check_input, check_operand,
                  dcb_plain, f32_plan, launch_f32, pack_kernel, packed_numel,
                  q_operand, tf32_numel, uses_tf32)
# The per-tile layout both kernels share, re-exported for the chain's
# callers and tests.
from .dcb import (KC, KF, KS_A, KS_B, RING_B, TILE, WIN,  # noqa: F401
                  WIN_ROWS, canonical, decanonical, smem_bytes, tile_grid,
                  tile_origin, unpack_block, window_pixel)

#: The widest block the chain kernels take (every multiple of 8 up to it).
MAX_CHANNELS = 384
#: Kernel launches since the count was last set to 0: the bf16 kernel's,
#: the SIMT fp32 kernel's and the 3xTF32 kernel's.
launches = 0
launches_f32 = 0
launches_tf32 = 0
#: The SIMT and the 3xTF32 fp32 kernels' launches by operand shape since
#: last cleared: (B, H, W, C, N, q given) -> count.
shape_launches_f32: Dict[tuple, int] = {}
shape_launches_tf32: Dict[tuple, int] = {}


def buffer_plan(n: int, in_smem: bool = False) -> List[Tuple[str, str]]:
    """(source, destination) of each block: 'x' the input (never written),
    'y' the caller's output, 's' the scratch tensor; the last block writes
    'y'. The kernels apply the same rule to pick their buffers. With
    ``in_smem`` (the SIMT fp32 kernel on units of whole images, where
    ``ops.dcb.f32_plan`` says ``whole``) every other output stays in the
    thread block's shared memory, 'm', and no scratch tensor is used."""
    if in_smem:
        dst = ["y" if j == n - 1 else "m" for j in range(n)]
    else:
        dst = ["y" if (n - 1 - j) % 2 == 0 else "s" for j in range(n)]
    return [("x" if j == 0 else dst[j - 1], dst[j]) for j in range(n)]


def pack_chain(blocks: Sequence[Params], dtype: torch.dtype) -> torch.Tensor:
    """Every block's ``ops.dcb.pack_kernel``, back to back: the one weight
    operand of the card's chain kernel for ``dtype`` activations."""
    return torch.cat([pack_kernel(p, dtype) for p in blocks])


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
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def dcb_chain_cuda(x: torch.Tensor, packed: torch.Tensor,
                   q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch for the whole chain: x (B, H, W, C) bf16 CUDA, ``packed``
    from :func:`pack_chain` (N blocks), q_last (C,) or None."""
    global launches
    check_input(x, "dcb_chain", MAX_CHANNELS, torch.bfloat16)
    b, h, w, c = x.shape
    n = packed.numel() // packed_numel(c)
    if n < 1:
        raise ValueError("dcb_chain: no blocks")
    check_operand(packed, x, n * packed_numel(c), "dcb_chain weights")
    q_last, q_ptr = q_operand(q_last, x, "dcb_chain")
    lib = _lib()
    y = torch.empty_like(x)
    scratch = torch.empty_like(x) if n > 1 else y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssgvc_dcb_chain_forward(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), packed.data_ptr(),
            q_ptr, b, h, w, c, n, stream)
    _build.check(lib, rc, "dcb_chain kernel")
    launches += 1
    return y


def _chain_f32(x, packed, q_last, what, tf32):
    check_input(x, what, MAX_CHANNELS if tf32 else F32_MAX_CHANNELS,
                torch.float32)
    b, h, w, c = x.shape
    per = tf32_numel(c) if tf32 else 8 * c * c + 17 * c
    n = packed.numel() // per
    if n < 1:
        raise ValueError(f"{what}: no blocks")
    check_operand(packed, x, n * per, f"{what} weights")
    q_last, q_ptr = q_operand(q_last, x, what)
    y = torch.empty_like(x)
    in_smem = not tf32 and f32_plan(b, h, w).whole == 1
    scratch = (torch.empty_like(x)
               if any(d == "s" for _, d in buffer_plan(n, in_smem)) else y)
    launch_f32(x, y, scratch, packed, q_ptr, n, False, what, tf32=tf32)
    key = (*x.shape, n, q_last is not None)
    shapes = shape_launches_tf32 if tf32 else shape_launches_f32
    shapes[key] = shapes.get(key, 0) + 1
    return y


def dcb_chain_f32_cuda(x: torch.Tensor, packed: torch.Tensor,
                       q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the SIMT fp32 kernel for the whole chain: x (B, H, W,
    C) fp32 CUDA, C up to ``ops.dcb.F32_MAX_CHANNELS`` (a ``ValueError``
    above; :func:`dcb_chain` sends it C <= 64), ``packed``: N
    ``ops.dcb.pack_f32`` back to back, q_last (C,) or None. On units of
    whole images the N blocks run in shared memory (a plain launch, no
    scratch tensor); on tiles, cooperatively with a grid barrier between
    blocks."""
    global launches_f32
    y = _chain_f32(x, packed, q_last, "dcb_chain_f32", False)
    launches_f32 += 1
    return y


def dcb_chain_tf32_cuda(x: torch.Tensor, packed: torch.Tensor,
                        q_last: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One launch of the 3xTF32 kernel for the whole chain: x (B, H, W, C)
    fp32 CUDA (:func:`dcb_chain` sends it C >= 72), ``packed``: N
    ``ops.dcb.pack_tf32`` back to back, q_last (C,) or None."""
    global launches_tf32
    y = _chain_f32(x, packed, q_last, "dcb_chain_tf32", True)
    launches_tf32 += 1
    return y


def dcb_chain(x: torch.Tensor, blocks: Sequence[Params],
              q_last: Optional[torch.Tensor] = None,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chained blocks: the plain version for a CPU tensor; for a CUDA
    tensor in float32 the 3xTF32 kernel where ``ops.dcb.uses_tf32``, else
    the SIMT one; otherwise the bf16 kernel (which refuses any other
    dtype). ``packed`` may carry the chain's cached :func:`pack_chain`
    output."""
    if x.device.type == "cpu":
        return dcb_chain_plain(x, blocks, q_last)
    if packed is None:
        packed = pack_chain(blocks, x.dtype)
    if x.dtype == torch.float32:
        if uses_tf32(x.shape[-1]):
            return dcb_chain_tf32_cuda(x, packed, q_last)
        return dcb_chain_f32_cuda(x, packed, q_last)
    return dcb_chain_cuda(x, packed, q_last)

