"""The I-frame codec (DMCI) in plain fp32: 8x8 patches into a 7-block
encoder, a latent y at 1/16 of the frame, a hyper latent at 1/64, a
four-pass checkerboard prior, a 13-block decoder back to pixels.

DCVC-RT's intra model (``src/models/image_model.py`` of the reference
code).
"""

from __future__ import annotations

from typing import Dict

import torch

from .entropy import factorized_bits, gaussian_bits_cdf
from .layers import (Params, block, conv, down_block, linear, pad_to,
                     pixel_shuffle, qp_row, quantize, up_block)

#: the micro pattern of each channel quarter in each pass: pattern k is
#: the pixels with (h % 2, w % 2) == (k // 2, k % 2)
ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def checkerboard_4x(c: int, h: int, w: int, device) -> list:
    """Four complementary (1, H, W, C) masks over the channel quarters."""
    hh = torch.arange(h, device=device).reshape(1, h, 1, 1)
    ww = torch.arange(w, device=device).reshape(1, 1, w, 1)
    pattern = (hh % 2) * 2 + ww % 2
    quarter = torch.arange(c, device=device) // (c // 4)
    orders = torch.tensor(ORDERS, device=device)
    return [(pattern == orders[i][quarter].reshape(1, 1, 1, c)).float()
            for i in range(4)]


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, qp: int,
            patch: int = 8) -> Dict[str, torch.Tensor]:
    """One I-frame: ``x`` (B, H, W, 3) in [0, 1], fp32. Returns 'frame',
    'bpp', 'bpp_y', 'bpp_z'."""
    W = Params(sd)
    q_enc, q_dec = qp_row(W["q_scale_enc"], qp), qp_row(W["q_scale_dec"], qp)

    # analysis
    enc = W.sub("enc")
    f = block(x, enc.sub("enc_1"), q=q_enc, patch=patch)
    for i in range(6):
        f = block(f, enc.sub(f"enc_2_{i}"))
    y = conv(f, enc.sub("enc_2_6"), stride=2, padding=1)

    # hyper latent
    z = block(pad_to(y), W.sub("hyper_enc_0"))
    z = down_block(down_block(z, W.sub("hyper_enc_1")), W.sub("hyper_enc_2"))
    z_hat = torch.round(z * W["z_gain"])

    # prior parameters, cropped to y
    p = block(up_block(up_block(z_hat, W.sub("hyper_dec_0")),
                       W.sub("hyper_dec_1")), W.sub("hyper_dec_2"))
    for i in range(3):
        p = block(p, W.sub(f"y_prior_fusion_{i}"))
    params = linear(p, W.sub("y_prior_fusion_3"))[:, :y.shape[1],
                                                  :y.shape[2], :]

    # four-pass checkerboard prior
    q = torch.sigmoid(params[..., :2]) * 1.5 + 0.5
    qe, qd = q[..., 0:1], q[..., 1:2]
    scales, means = params[..., 2:].chunk(2, dim=-1)
    reduced = linear(params, W.sub("y_spatial_prior_reduction"))
    masks = checkerboard_4x(y.shape[-1], y.shape[1], y.shape[2], y.device)
    y = y * qe
    y_q, y_hat, s_hat = quantize(y, scales, means, masks[0])
    for i in (1, 2, 3):
        s = block((y_hat, reduced), W.sub(f"y_spatial_prior_adaptor_{i}"))
        for j in range(3):
            s = block(s, W.sub(f"y_spatial_prior_{j}"))
        scales_i, means_i = linear(s, W.sub("y_spatial_prior_3")).chunk(
            2, dim=-1)
        yq_i, yh_i, s_i = quantize(y, scales_i, means_i, masks[i])
        y_q, y_hat, s_hat = y_q + yq_i, y_hat + yh_i, s_hat + s_i
    y_hat = y_hat * qd

    # synthesis
    dec = W.sub("dec")
    f = up_block(y_hat, dec.sub("dec_1_0"))
    for i in range(1, 12):
        f = block(f, dec.sub(f"dec_1_{i}"))
    f = block(f, dec.sub("dec_1_12"), q=q_dec)
    frame = torch.clamp(pixel_shuffle(block(f, dec.sub("dec_2")), patch),
                        0.0, 1.0)

    pixels = x.shape[1] * x.shape[2]
    bits_y = gaussian_bits_cdf(y_q, s_hat)
    bits_z = factorized_bits(z_hat, W.sub("bit_estimator_z"), qp)
    bpp_y = bits_y.sum(dim=(1, 2, 3)) / pixels
    bpp_z = bits_z.sum(dim=(1, 2, 3)) / pixels
    return {"frame": frame, "bpp": bpp_y + bpp_z, "bpp_y": bpp_y,
            "bpp_z": bpp_z}
