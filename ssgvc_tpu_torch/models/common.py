"""Shared codec math: checkerboard masks, masked quantization, the 2-pass
checkerboard prior of the P-frame codec and the 4-pass one of the I-frame
codec, padding and bpp. NHWC throughout.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..layers.quant import noise_quant, ste_round
from ..parallel import spatial


def qp_gain_ramp_init(rows: int, channels: int, lo: float = 0.25,
                      hi: float = 5.0, inverse: bool = False) -> torch.Tensor:
    """A per-QP gain table (rows, channels) at init: a geometric ramp from
    ``lo`` (qp 0) to ``hi`` (the last row), constant across channels, or its
    reciprocal. Higher qp gives a larger latent and more bits, as lambda(qp)
    rises, so the variable-rate ladder exists at step 0 of a from-scratch
    run. fp32, in the JAX package's order of operations (``jnp.linspace``:
    start * (1 - step) + stop * step, the last row exactly ``hi``); XLA's
    exp and fused multiply-adds put its rows up to 3 ulp from these."""
    f32 = torch.float32
    start = torch.log(torch.tensor(lo, dtype=f32))
    stop = torch.log(torch.tensor(hi, dtype=f32))
    if rows > 1:
        step = torch.arange(rows - 1, dtype=f32) / (rows - 1)
        line = torch.cat([start * (1 - step) + stop * step, stop[None]])
    else:
        line = start[None]
    ramp = torch.exp(line)
    if inverse:
        ramp = 1.0 / ramp
    return ramp[:, None].expand(rows, channels).contiguous()


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` field ("bfloat16" or
    "float32")."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def checkerboard_masks_2x(channel: int, height: int, width: int,
                          dtype=torch.float32, device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two complementary (1, H, W, C) masks: the ((1,0),(0,1)) checker on
    the first channel half, inverted on the second; mask_1 swaps them."""
    if channel % 2:
        raise ValueError(f"channel={channel} must be even")
    hh = torch.arange(height, device=device).reshape(1, height, 1, 1)
    ww = torch.arange(width, device=device).reshape(1, 1, width, 1)
    cc = torch.arange(channel, device=device).reshape(1, 1, 1, channel)
    checker = (hh % 2 + ww % 2) % 2 == 0
    mask_0 = torch.where(cc < channel // 2, checker, ~checker).to(dtype)
    return mask_0, (1.0 - mask_0).to(dtype)


#: Micro pattern of each channel quarter, per pass of the 4-pass prior;
#: pattern k lights the pixels with (h % 2, w % 2) == (k // 2, k % 2).
MASK_4X_ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def checkerboard_masks_4x(channel: int, height: int, width: int,
                          dtype=torch.float32, device="cuda"
                          ) -> Tuple[torch.Tensor, ...]:
    """Four complementary (1, H, W, C) masks over channel quarters: mask i
    lights, in quarter q, the pixels of pattern ``MASK_4X_ORDERS[i][q]``."""
    if channel % 4:
        raise ValueError(f"channel={channel} must be a multiple of 4")
    hh = torch.arange(height, device=device).reshape(1, height, 1, 1)
    ww = torch.arange(width, device=device).reshape(1, 1, width, 1)
    quarter = torch.arange(channel, device=device) // (channel // 4)
    pattern = (hh % 2) * 2 + ww % 2
    orders = torch.tensor(MASK_4X_ORDERS, device=device)
    return tuple((pattern == orders[i][quarter].reshape(1, 1, 1, channel))
                 .to(dtype) for i in range(4))


class MaskedQuant(NamedTuple):
    y_res: torch.Tensor
    y_q_hat: torch.Tensor         # straight-through twin (reconstruction)
    y_q_hat_write: torch.Tensor   # noise twin (bit estimate)
    y_hat: torch.Tensor
    scales_hat: torch.Tensor


def process_with_mask(y, scales, means, mask,
                      generator: Optional[torch.Generator],
                      train: bool) -> MaskedQuant:
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q_hat = ste_round(y_res) * mask
    y_q_hat_write = noise_quant(y_res, generator, train) * mask
    y_hat = y_q_hat + means_hat
    return MaskedQuant(y_res, y_q_hat, y_q_hat_write, y_hat, scales_hat)


def get_padding_size(height: int, width: int, p: int = 64) -> Tuple[int, int]:
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_w - width, new_h - height   # (pad_right, pad_bottom)


def get_downsampled_shape(height: int, width: int, p: int) -> Tuple[int, int]:
    return (height + p - 1) // p, (width + p - 1) // p


def pad_for_y(y: torch.Tensor, p: int = 4) -> torch.Tensor:
    """Replicate-pad bottom/right to a multiple of p (NHWC). Under a row
    shard every slab but the frame's last holds whole units, a multiple of
    4 rows at y's scale, so only its right is padded; the last slab holds
    the frame's bottom and pads the rows the unsharded frame pads."""
    _, h, w, _ = y.shape
    pad_r, pad_b = get_padding_size(h, w, p)
    if pad_r == 0 and pad_b == 0:
        return y
    out = F.pad(y.permute(0, 3, 1, 2), (0, pad_r, 0, pad_b), mode="replicate")
    return out.permute(0, 2, 3, 1).contiguous()


class PriorOut(NamedTuple):
    y_res: torch.Tensor
    y_q_hat: torch.Tensor
    y_q_hat_write: torch.Tensor
    y_hat: torch.Tensor
    scales_hat: torch.Tensor


def compress_prior_2x(y: torch.Tensor, common_params: torch.Tensor,
                      spatial_prior: Callable,
                      generator: Optional[torch.Generator],
                      train: bool) -> PriorOut:
    """Two-pass checkerboard prior of the P-frame codec.

    ``common_params`` stacks (q_dec, scales, means) on channels; q_dec is
    clamped at 0.5 and folded into y as a reciprocal before quantization."""
    q_dec, scales, means = common_params.chunk(3, dim=-1)
    q_dec = torch.clamp(q_dec, min=0.5)
    y = y * (1.0 / q_dec)

    c, h, w = y.shape[-1], y.shape[1], y.shape[2]
    mask_0, mask_1 = checkerboard_masks_2x(c, h, w, dtype=y.dtype,
                                           device=y.device)
    p0 = process_with_mask(y, scales, means, mask_0, generator, train)
    # tuple input: the prior's first block consumes the concat implicitly
    scales1, means1 = spatial_prior((p0.y_hat, common_params)).chunk(2, -1)
    p1 = process_with_mask(y, scales1, means1, mask_1, generator, train)

    return PriorOut(
        y_res=p0.y_res + p1.y_res,
        y_q_hat=p0.y_q_hat + p1.y_q_hat,
        y_q_hat_write=p0.y_q_hat_write + p1.y_q_hat_write,
        y_hat=(p0.y_hat + p1.y_hat) * q_dec,
        scales_hat=p0.scales_hat + p1.scales_hat,
    )


def separate_prior_image(params: torch.Tensor):
    """The I-frame prior's split: the first 2 channels -> (q_enc, q_dec) =
    sigmoid * 1.5 + 0.5, in [0.5, 2]; the rest -> (scales, means)."""
    q = torch.sigmoid(params[..., :2]) * 1.5 + 0.5
    scales, means = params[..., 2:].chunk(2, dim=-1)
    return q[..., 0:1], q[..., 1:2], scales, means


def compress_prior_4x(y: torch.Tensor, common_params: torch.Tensor,
                      reduction: Callable, adaptors: Sequence[Callable],
                      spatial_prior: Callable,
                      generator: Optional[torch.Generator], train: bool,
                      fm_s: Optional[torch.Tensor] = None) -> PriorOut:
    """Four-pass checkerboard prior of the I-frame codec.

    ``common_params`` carries (q_enc, q_dec, scales, means)
    (:func:`separate_prior_image`); y is scaled by q_enc before the passes
    and y_hat by q_dec after them. Pass i > 0 takes its scales and means
    from ``spatial_prior(adaptors[i - 1]((y_hat so far, reduced)))``, with
    ``reduced = reduction(common_params)``. ``fm_s`` (optional, per
    channel) divides y and the first pass's scales and means and multiplies
    y_hat back. The noise of every pass comes from ``generator``, in pass
    order."""
    q_enc, q_dec, scales, means = separate_prior_image(common_params)
    if fm_s is not None:
        y = y / fm_s
        scales = scales / fm_s
        means = means / fm_s
    reduced = reduction(common_params)

    c, h, w = y.shape[-1], y.shape[1], y.shape[2]
    masks = checkerboard_masks_4x(c, h, w, dtype=y.dtype, device=y.device)
    y = y * q_enc

    passes = [process_with_mask(y, scales, means, masks[0], generator, train)]
    y_hat_so_far = passes[0].y_hat
    for i, adaptor in enumerate(adaptors):
        scales_i, means_i = spatial_prior(
            adaptor((y_hat_so_far, reduced))).chunk(2, dim=-1)
        p = process_with_mask(y, scales_i, means_i, masks[i + 1], generator,
                              train)
        passes.append(p)
        y_hat_so_far = y_hat_so_far + p.y_hat

    y_hat = y_hat_so_far * q_dec
    if fm_s is not None:
        y_hat = y_hat * fm_s
    return PriorOut(
        y_res=sum(p.y_res for p in passes),
        y_q_hat=sum(p.y_q_hat for p in passes),
        y_q_hat_write=sum(p.y_q_hat_write for p in passes),
        y_hat=y_hat,
        scales_hat=sum(p.scales_hat for p in passes),
    )


def bpp_from_bits(bits: torch.Tensor, pixel_num: int) -> torch.Tensor:
    """Sum bits over (H, W, C), divide by source pixels -> per-sample bpp.
    Under a row shard the sum is the frame's (all-reduced over the slabs)
    and ``pixel_num`` the frame's."""
    return spatial.frame_sum(bits.sum(dim=(1, 2, 3))) / pixel_num
