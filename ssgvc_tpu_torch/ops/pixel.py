"""Pixel (un)shuffle on NHWC tensors and the unfused patching convs.

Output channel ``c*r*r + i*r + j`` of :func:`pixel_unshuffle` holds input
pixel offset ``(i, j)`` of channel ``c``: the channel order of
``torch.nn.functional.pixel_unshuffle`` on NCHW, kept on NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    :func:`pixel_unshuffle`; bias: (O,). Returns (B, H, W, O)."""
    u = pixel_unshuffle(x, r)
    return F.linear(u, weight[:, :, 0, 0].to(u.dtype), bias.to(u.dtype))


def patch_up_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, r: int) -> torch.Tensor:
    """A 1x1 conv then pixel_shuffle(r).

    x: (B, H, W, I); weight: (C*r*r, I, 1, 1); bias: (C*r*r,).
    Returns (B, H*r, W*r, C)."""
    out = F.linear(x, weight[:, :, 0, 0].to(x.dtype), bias.to(x.dtype))
    return pixel_shuffle(out, r)
