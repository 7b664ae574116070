"""The P-frame codec (DMC), ``performance`` variant, in plain fp32: the
mask modulates the latent y by a spatial feature transform, the prior is
a two-pass checkerboard, frames enter and leave pixel-unshuffled by 8
(``packed_io``), and the frame follows another P-frame (the decoded
feature of the previous frame is the context).

DCVC-RT's inter model (``src/models/video_model.py`` of the reference
code) with the SFT of ``src/refactor/seg_video_model.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .entropy import factorized_bits, gaussian_bits
from .layers import (Params, block, conv, down_block, linear, qp_row,
                     quantize, subpel, up_block)

#: the rate estimate's smallest sigma, and the coder's symbol range
SIGMA_FLOOR = 0.11
SYMBOL_MAX = 127.0


def checkerboard_2x(c: int, h: int, w: int, device) -> tuple:
    """Two complementary (1, H, W, C) masks: the checker ((h + w) even) on
    the first channel half, its inverse on the second, and the swap."""
    hh = torch.arange(h, device=device).reshape(1, h, 1, 1)
    ww = torch.arange(w, device=device).reshape(1, 1, w, 1)
    cc = torch.arange(c, device=device).reshape(1, 1, 1, c)
    even = (hh + ww) % 2 == 0
    m0 = torch.where(cc < c // 2, even, ~even).float()
    return m0, 1.0 - m0


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor,
            mask: torch.Tensor, qp: int, dpb: Dict[str, torch.Tensor],
            patch: int = 8) -> Dict[str, torch.Tensor]:
    """One P-frame. ``x`` (B, H/8, W/8, 192) and ``mask`` (B, H/8, W/8,
    64) packed, ``dpb`` the previous frame's {'frame', 'feature'}; all
    fp32. Returns the new DPB's 'frame' and 'feature', and 'bpp', 'bpp_y',
    'bpp_z' per image."""
    W = Params(sd)
    q_enc, q_dec = qp_row(W["q_encoder"], qp), qp_row(W["q_decoder"], qp)
    q_feat = qp_row(W["q_feature"], qp)
    q_sft = qp_row(W["q_sft"], qp)

    # context from the previous decoded feature
    fe = W.sub("feature_extractor")
    f = linear(dpb["feature"], W.sub("feature_adaptor_p"))
    x1 = block(block(f, fe.sub("conv1_0")), fe.sub("conv1_1"))
    ctx_t = x1 * q_feat
    ctx = x1
    for i in range(4):
        ctx = block(ctx, fe.sub(f"conv2_{i}"))

    # analysis
    en = W.sub("encoder")
    f = block((linear(x, en.sub("conv1")), ctx), en.sub("conv2_0"))
    f = block(block(f, en.sub("conv2_1")), en.sub("conv2_2"), q=q_enc)
    y = conv(f, en.sub("down"), stride=2, padding=1)

    # the mask's spatial feature transform of y
    sft = W.sub("mask_sft")
    m = linear(mask, sft.sub("conv1"))
    for i in range(3):
        m = block(m, sft.sub(f"conv2_{i}"))
    gamma, beta = conv(m * q_sft, sft.sub("down"), stride=2,
                       padding=1).chunk(2, dim=-1)
    y = y * (1.0 + gamma) + beta

    # hyper latent
    he = W.sub("hyper_encoder")
    z = down_block(down_block(block(y, he.sub("conv_0")), he.sub("conv_1")),
                   he.sub("conv_2"))
    z_hat = torch.round(z * W["z_gain"])

    # prior parameters: hierarchical and temporal, fused
    hd = W.sub("hyper_decoder")
    hier = block(up_block(up_block(z_hat, hd.sub("conv_0")),
                          hd.sub("conv_1")), hd.sub("conv_2"))
    temporal = down_block(ctx_t, W.sub("temporal_prior_encoder"))
    h, w = temporal.shape[1], temporal.shape[2]
    pf = W.sub("y_prior_fusion")
    params = torch.cat([hier[:, :h, :w, :], temporal], dim=-1)
    for i in range(3):
        params = block(params, pf.sub(f"conv_{i}"))
    params = linear(params, pf.sub("conv_3"))

    # two-pass checkerboard prior
    q_d, scales, means = params.chunk(3, dim=-1)
    q_d = torch.clamp(q_d, min=0.5)
    y = y * (1.0 / q_d)
    m0, m1 = checkerboard_2x(y.shape[-1], y.shape[1], y.shape[2], y.device)
    yq0, yh0, s0 = quantize(y, scales, means, m0)
    sp = W.sub("y_spatial_prior")
    s = block(block((yh0, params), sp.sub("conv_0")), sp.sub("conv_1"))
    scales1, means1 = linear(s, sp.sub("conv_2")).chunk(2, dim=-1)
    yq1, yh1, s1 = quantize(y, scales1, means1, m1)
    y_hat = (yh0 + yh1) * q_d

    # synthesis
    de = W.sub("decoder")
    f = subpel(y_hat, de.sub("up.conv_0"), padding=1) * q_dec
    f = block((f, ctx), de.sub("conv_0"))
    feature = linear(block(block(f, de.sub("conv_1")), de.sub("conv_2")),
                     de.sub("proj"))
    frame = reconstruct(sd, feature, qp)

    # rates per source pixel
    pixels = x.shape[1] * x.shape[2] * patch * patch
    bits_y = gaussian_bits(torch.clamp(yq0 + yq1, -SYMBOL_MAX, SYMBOL_MAX),
                           torch.clamp(s0 + s1, min=SIGMA_FLOOR))
    bits_z = factorized_bits(z_hat, W.sub("bit_estimator_z"), qp)
    bpp_y = bits_y.sum(dim=(1, 2, 3)) / pixels
    bpp_z = bits_z.sum(dim=(1, 2, 3)) / pixels
    return {"frame": frame, "feature": feature, "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y, "bpp_z": bpp_z}


def reconstruct(sd: Dict[str, torch.Tensor], feature: torch.Tensor,
                qp: int) -> torch.Tensor:
    """The decoded frame (packed) from the decoder's output feature: four
    blocks at the reconstruction width, the per-QP scale, the 1x1 head,
    the clamp to [0, 1]."""
    rg = Params(sd).sub("recon_generation_net")
    r = feature
    for i in range(4):
        r = block(r, rg.sub(f"conv_{i}"))
    r = r * qp_row(Params(sd)["q_recon"], qp)
    return torch.clamp(linear(r, rg.sub("head")), 0.0, 1.0)
