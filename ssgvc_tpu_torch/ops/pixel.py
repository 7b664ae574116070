"""Pixel (un)shuffle on NHWC tensors and the patching convs.

Output channel ``c*r*r + i*r + j`` of :func:`pixel_unshuffle` holds input
pixel offset ``(i, j)`` of channel ``c``: the channel order of
``torch.nn.functional.pixel_unshuffle`` on NCHW, kept on NHWC.

``pixel_unshuffle(r)`` then a 1x1 conv is one stride-r r x r conv on the
raw frame, and a 1x1 conv then ``pixel_shuffle(r)`` one stride-r
transposed conv. :data:`FUSE_DOWN` / :data:`FUSE_UP` (the JAX package's
``SSGVC_FUSE_DOWN`` / ``SSGVC_FUSE_UP``, read once at import and off by
default; set the attributes to flip them) select those fused forms, on
the unfused 1x1 weights' layout, so checkpoints hold the same parameters
either way. Both fused forms are library convolutions (cuDNN on the card,
in full fp32 for fp32 inputs), as they are XLA convolutions in the JAX
package (``ssgvc_tpu/ops/pixel.py:61-114``).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

FUSE_DOWN = os.environ.get("SSGVC_FUSE_DOWN", "0") == "1"
FUSE_UP = os.environ.get("SSGVC_FUSE_UP", "0") == "1"


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r)."""
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C); inverse of pixel_unshuffle."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def patch_down_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, r: int) -> torch.Tensor:
    """pixel_unshuffle(r) then a 1x1 conv.

    x: (B, H*r, W*r, C); weight: (O, C*r*r, 1, 1) in the channel order of
    :func:`pixel_unshuffle`; bias: (O,). Returns (B, H, W, O). With
    :data:`FUSE_DOWN`, one stride-r r x r conv, the bias added after it."""
    if FUSE_DOWN:
        from ..layers.blocks import cudnn_fp32

        o = weight.shape[0]
        k = weight[:, :, 0, 0].reshape(o, x.shape[-1], r, r).to(x.dtype)
        with cudnn_fp32(x.dtype, x.device):
            out = F.conv2d(x.permute(0, 3, 1, 2), k, stride=r)
        return (out.permute(0, 2, 3, 1) + bias.to(x.dtype)).contiguous()
    u = pixel_unshuffle(x, r)
    return F.linear(u, weight[:, :, 0, 0].to(u.dtype), bias.to(u.dtype))


def patch_up_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, r: int) -> torch.Tensor:
    """A 1x1 conv then pixel_shuffle(r).

    x: (B, H, W, I); weight: (C*r*r, I, 1, 1); bias: (C*r*r,).
    Returns (B, H*r, W*r, C). With :data:`FUSE_UP`, one stride-r
    transposed conv, then the bias as an r x r tile (each shuffled
    channel's own)."""
    if FUSE_UP:
        from ..layers.blocks import cudnn_fp32

        b, h, w, i = x.shape
        c = weight.shape[0] // (r * r)
        k = weight[:, :, 0, 0].t().reshape(i, c, r, r).to(x.dtype)
        with cudnn_fp32(x.dtype, x.device):
            out = F.conv_transpose2d(x.permute(0, 3, 1, 2), k, stride=r)
        tile = bias.to(x.dtype).reshape(c, r, r).permute(1, 2, 0)
        return (out.permute(0, 2, 3, 1) + tile.repeat(h, w, 1)).contiguous()
    out = F.linear(x, weight[:, :, 0, 0].to(x.dtype), bias.to(x.dtype))
    return pixel_shuffle(out, r)
