"""N adaptor-free, shortcut-free DepthConvBlocks in one launch: the CUDA
kernel ``csrc/dcb_chain.cu``, its plain PyTorch version and the segment
planner.

Each block computes what ``ops/dcb.py`` describes; each block's output is
rounded to the activation dtype before the next block reads it, and an
optional ``q_last`` multiplies the last block's output (the ``* quant_step``
that follows the encoder's chain). The kernel keeps a tile's activations in
shared memory across all blocks of a segment: its input tile carries a halo
of N pixels on every side and the live region shrinks by one pixel per side
per block. :func:`plan_segments` splits a chain whose halo-extended tile does
not fit in shared memory into shorter segments, longest first.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from .dcb import (Params, check_input, check_operand, dcb_plain,
                  pack_params, packed_numel, plan_tile, smem_bytes)

#: Kernel launches since the count was last set to 0.
launches = 0


def plan_segments(c: int, length: int) -> List[Tuple[int, int, int]]:
    """Split a chain of ``length`` blocks at width ``c`` into segments
    (n, th, tw): the longest n whose tile fits first, then the rest."""
    plan = []
    rest = length
    while rest > 0:
        for n in range(rest, 0, -1):
            tile = plan_tile(c, n)
            if tile is not None:
                plan.append((n, *tile))
                rest -= n
                break
        else:
            raise ValueError(f"no tile fits a single block at C={c}")
    return plan


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
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def dcb_chain_cuda(x: torch.Tensor, packed: Sequence[torch.Tensor],
                   q_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel once per planned segment: x (1, H, W, C) bf16 CUDA,
    ``packed`` one :func:`~.dcb.pack_params` tensor per block."""
    global launches
    check_input(x, "dcb_chain")
    _, h, w, c = x.shape
    for p in packed:
        check_operand(p, x, packed_numel(c), "dcb_chain weights")
    if q_last is not None:
        q_last = q_last.reshape(-1)
        check_operand(q_last, x, c, "dcb_chain q_last")
    lib = _lib()
    start = 0
    for n, th, tw in plan_segments(c, len(packed)):
        seg = packed[start:start + n]
        start += n
        stacked = seg[0] if n == 1 else torch.cat(list(seg))
        q = q_last if start == len(packed) else None
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.ssgvc_dcb_chain_forward(
                x.data_ptr(), y.data_ptr(), stacked.data_ptr(),
                None if q is None else q.data_ptr(), h, w, c, n, th, tw,
                smem_bytes(c, n, th, tw), stream)
        _build.check(lib, rc, "dcb_chain kernel")
        launches += 1
        x = y
    return x


def dcb_chain(x: torch.Tensor, blocks: Sequence[Params],
              q_last: Optional[torch.Tensor] = None,
              packed: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
    """Chained blocks: the plain version for a CPU tensor, the kernel for a
    CUDA tensor. ``packed`` may carry the blocks' cached packed weights."""
    if x.device.type == "cpu":
        return dcb_chain_plain(x, blocks, q_last)
    if packed is None:
        packed = [pack_params(p, x.dtype) for p in blocks]
    return dcb_chain_cuda(x, packed, q_last)
