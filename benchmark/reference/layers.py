"""Plain fp32 layers of the codec on NHWC tensors.

Weights come from a flat dict keyed like the model's ``state_dict``
(``encoder.conv2_0.dc_0.weight``): conv weights (O, I / groups, kh, kw),
biases (O,). :class:`Params` is a view of that dict under a prefix.
Every product is an ``F.linear`` (1x1 convs, adaptors) or an ``F.conv2d``
(strided, 3x3 and depthwise convs), so the benchmark's product count
(``harness/count.py``) reads them off the calls.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F


class Params:
    """A view of a flat state dict under ``prefix``."""

    def __init__(self, sd: dict, prefix: str = ""):
        self.sd, self.prefix = sd, prefix

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.sd[self.prefix + key]

    def __contains__(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def sub(self, name: str) -> "Params":
        return Params(self.sd, f"{self.prefix}{name}.")


def wsilu(x: torch.Tensor) -> torch.Tensor:
    """silu(4x) / 4."""
    return F.silu(4.0 * x) * 0.25


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r); channel c*r*r + i*r + j holds
    pixel offset (i, j) of channel c."""
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of :func:`pixel_unshuffle`."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """A 1x1 conv: weight (O, I, 1, 1)."""
    return F.linear(x, p["weight"][:, :, 0, 0], p["bias"])


def conv(x: torch.Tensor, p: Params, stride: int = 1, padding: int = 0,
         groups: int = 1) -> torch.Tensor:
    """A conv with zero padding on an NHWC tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["weight"], p["bias"], stride,
                 padding, groups=groups)
    return y.permute(0, 2, 3, 1)


Input = Union[torch.Tensor, Sequence[torch.Tensor]]


def block(x: Input, p: Params, q: Optional[torch.Tensor] = None,
          shortcut: bool = False, patch: int = 0) -> torch.Tensor:
    """A DepthConvBlock: x -> [adaptor] -> u = x + dc(x) -> y = u + ffn(u)
    [+ x] [* q]. A tuple input is concatenated on channels first; the
    adaptor, where the weights hold one, is a 1x1 conv on that (after a
    ``patch`` pixel-unshuffle of a raw frame). dc is 1x1, wsilu, depthwise
    3x3, 1x1; ffn is 1x1 to 4C, wsilu on both halves summed, 1x1 back."""
    if not isinstance(x, torch.Tensor):
        x = torch.cat(list(x), dim=-1)
    if patch:
        x = pixel_unshuffle(x, patch)
    if "adaptor.weight" in p:
        x = linear(x, p.sub("adaptor"))
    c = x.shape[-1]
    h = wsilu(linear(x, p.sub("dc_0")))
    h = conv(h, p.sub("dc_2"), padding=1, groups=c)
    u = x + linear(h, p.sub("dc_3"))
    f = linear(u, p.sub("ffn_0"))
    y = u + linear(wsilu(f[..., :2 * c]) + wsilu(f[..., 2 * c:]),
                   p.sub("ffn_2"))
    if shortcut:
        y = y + x
    if q is not None:
        y = y * q
    return y


def down_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    """2x2 stride-2 conv, then a shortcut block."""
    return block(conv(x, p.sub("down"), stride=2), p.sub("conv"),
                 shortcut=True)


def subpel(x: torch.Tensor, p: Params, padding: int = 0) -> torch.Tensor:
    """conv to 4x the channels, then pixel_shuffle(2)."""
    return pixel_shuffle(conv(x, p, padding=padding), 2)


def up_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    """1x1 subpel 2x upsample, then a shortcut block."""
    return block(subpel(x, p.sub("up.conv_0")), p.sub("conv"),
                 shortcut=True)


def qp_row(t: torch.Tensor, qp: int) -> torch.Tensor:
    """Row ``qp`` of a per-QP table, shaped to scale NHWC channels."""
    return t[qp].reshape(1, 1, 1, -1)


def pad_to(y: torch.Tensor, p: int = 4) -> torch.Tensor:
    """Replicate-pad bottom and right to a multiple of ``p``."""
    h, w = y.shape[1], y.shape[2]
    pb, pr = -h % p, -w % p
    if not (pb or pr):
        return y
    out = F.pad(y.permute(0, 3, 1, 2), (0, pr, 0, pb), mode="replicate")
    return out.permute(0, 2, 3, 1)


def quantize(y, scales, means, mask):
    """One pass of a checkerboard prior on the positions in ``mask``:
    (rounded residual, y_hat, scales), each zero elsewhere."""
    means = means * mask
    y_q = torch.round((y - means) * mask) * mask
    return y_q, y_q + means, scales * mask
